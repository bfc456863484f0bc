// B3: per-pixel spherical-harmonics forward rasterizer.
//
// Replaces the Pallas kernel gaussian_splatting_tpu/ops/render_sh.py::_fwd_kernel
// (launched by _render_fwd).  The plain PyTorch version is
// gaussian_splatting_torch/ops/render_sh.py::render_sh_fwd_plain.
//
// A splat's colour at pixel p is colour_c(p) = sum_k coeff[c * n_sh + k] *
// basis[k, p], with basis the SH basis at the pixel's world-frame view ray;
// compositing, thresholds and the T_EPS stop are B1's (render_fwd.cu).
//
// Design: B1's skeleton.  One thread block per 16x16 tile, one thread per
// pixel; each pixel keeps its n_sh basis values in registers for the whole
// walk.  The block gathers 256 splats at a time through gaussian_idx into
// shared memory: their geometry and their 3 * n_sh coefficients, one row of
// 256 splats per coefficient, so the gather writes and the per-splat reads
// (every pixel reads the same splat, a broadcast) are free of bank
// conflicts.  At n_sh = 16 that is 7 KB of geometry and 48 KB of
// coefficients, above the 48 KB of static shared memory: the launcher asks
// for dynamic shared memory with cudaFuncSetAttribute.  The kernel is a
// template on n_sh (4, 9, 16), so the contraction over k unrolls and the
// basis stays in registers; the host dispatches on n_sh.
//
// What bounds it on the H100: per splat-pixel pair that a pixel reaches
// before T < T_EPS, B1's ~25 float32 operations (one expf), plus 2 * 3 *
// n_sh for the contraction (96 at n_sh = 16) on the pairs that composite,
// against 67 TFLOP/s outside the tensor cores; the bytes are feat, the
// basis and the output (read or written once: ~100 MB on a 1296x840 view at
// n_sh = 16) against 3.35 TB/s, so operations bind.  The contraction is
// done per pixel and splat as the reference does, not as the Pallas
// kernel's coefficient-times-weight matmul (an MXU device).  The loop is
// latency-bound scalar work with a sequential dependence on T, as in B1;
// load balance across tiles is left for later work.
#include "common.cuh"

namespace gs {
namespace {

template <int NSH>
constexpr int sh_fwd_smem_bytes() {
  return kPixelsPerTile * (int(sizeof(SplatGeom)) + 3 * NSH * int(sizeof(float)));
}

template <int NSH>
__global__ void __launch_bounds__(kPixelsPerTile)
    render_sh_fwd_kernel(const float* __restrict__ feat, int n,
                         const float* __restrict__ basis,
                         const int* __restrict__ gaussian_idx,
                         const int* __restrict__ tile_starts, int x_tiles,
                         int n_pix, float* __restrict__ out) {
  constexpr int kCoeffRows = 3 * NSH;
  extern __shared__ float s_mem[];
  SplatGeom* s_geom = reinterpret_cast<SplatGeom*>(s_mem);
  // s_coeff[r * kPixelsPerTile + j]: coefficient row r of batch splat j
  float* s_coeff = reinterpret_cast<float*>(s_geom + kPixelsPerTile);

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const float ox = float((tile % x_tiles) * kTilePx);
  const float oy = float((tile / x_tiles) * kTilePx);
  const float up = float(p % kTilePx) - kHalfTile;
  const float vp = float(p / kTilePx) - kHalfTile;
  const int lo = tile_starts[tile];
  const int hi = tile_starts[tile + 1];
  const int o = tile * kPixelsPerTile + p;

  float b[NSH];
#pragma unroll
  for (int k = 0; k < NSH; ++k) b[k] = basis[k * n_pix + o];

  float T = 1.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  bool done = false;
  for (int base = lo; base < hi; base += kPixelsPerTile) {
    // also the barrier that keeps the previous batch alive until every
    // pixel has finished with it
    if (__syncthreads_count(!done) == 0) break;
    const int i = base + p;
    if (i < hi) {
      const int g = gaussian_idx[i];
      s_geom[p] = load_geom(feat, n, g, ox, oy);
#pragma unroll
      for (int r = 0; r < kCoeffRows; ++r) {
        s_coeff[r * kPixelsPerTile + p] = feat[(kShCoeff0 + r) * n + g];
      }
    }
    __syncthreads();
    const int count = min(kPixelsPerTile, hi - base);
    for (int j = 0; j < count && !done; ++j) {
      if (T < kTEps) {
        done = true;
        break;
      }
      const float alpha = splat_alpha(s_geom[j], up, vp);
      if (alpha < kAlphaSkip) continue;
      const float w = alpha * T;
      const float* c = s_coeff + j;
      cr += sh_colour<NSH>(c, b) * w;
      cg += sh_colour<NSH>(c + NSH * kPixelsPerTile, b) * w;
      cb += sh_colour<NSH>(c + 2 * NSH * kPixelsPerTile, b) * w;
      T *= 1.0f - alpha;
    }
    done = done || T < kTEps;
  }
  out[0 * n_pix + o] = cr;
  out[1 * n_pix + o] = cg;
  out[2 * n_pix + o] = cb;
  out[3 * n_pix + o] = T;
}

template <int NSH>
cudaError_t launch(const float* feat, int n, const float* basis,
                   const int* gaussian_idx, const int* tile_starts,
                   int n_tiles, int x_tiles, float* out, cudaStream_t stream) {
  constexpr int smem = sh_fwd_smem_bytes<NSH>();
  const cudaError_t err = cudaFuncSetAttribute(
      render_sh_fwd_kernel<NSH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  render_sh_fwd_kernel<NSH><<<n_tiles, kPixelsPerTile, smem, stream>>>(
      feat, n, basis, gaussian_idx, tile_starts, x_tiles,
      n_tiles * kPixelsPerTile, out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gs

// feat: (6 + 3 * n_sh, n) float32 rows u, v, op, a+.25, b/2, c+.25 and the
// coefficients (row 6 + c * n_sh + k); basis: (n_sh, n_tiles * 256) float32
// in tile-major pixel order; gaussian_idx: (S,) int32; tile_starts:
// (n_tiles+1,) int32; out: (4, n_tiles * 256) float32 rows premultiplied
// r, g, b and T.  n_sh is 4, 9 or 16; any other value returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int gs_render_sh_fwd(const float* feat, int n, const float* basis,
                                int n_sh, const int* gaussian_idx,
                                const int* tile_starts, int n_tiles,
                                int x_tiles, float* out, cudaStream_t stream) {
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  switch (n_sh) {
    case 4:
      return static_cast<int>(gs::launch<4>(feat, n, basis, gaussian_idx,
                                            tile_starts, n_tiles, x_tiles, out,
                                            stream));
    case 9:
      return static_cast<int>(gs::launch<9>(feat, n, basis, gaussian_idx,
                                            tile_starts, n_tiles, x_tiles, out,
                                            stream));
    case 16:
      return static_cast<int>(gs::launch<16>(feat, n, basis, gaussian_idx,
                                             tile_starts, n_tiles, x_tiles,
                                             out, stream));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
