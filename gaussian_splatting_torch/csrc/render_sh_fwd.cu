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
// What bounds it on the H100: per splat-pixel pair that a pixel reaches
// before T < T_EPS, B1's ~25 float32 operations (one expf), plus 2 * 3 *
// n_sh for the contraction (96 at n_sh = 16) on the pairs that composite,
// against 67 TFLOP/s outside the tensor cores; the bytes are feat, the
// basis and the output (read or written once: ~100 MB on a 1296x840 view at
// n_sh = 16) against 3.35 TB/s, so operations bind.  The contraction is
// done per pixel and splat as the reference does, not as the Pallas
// kernel's coefficient-times-weight matmul (an MXU device).
//
// Design: B1's (render_fwd.cu, common.cuh), a template on n_sh (4, 9, 16),
// so the contraction unrolls and the basis stays in registers (2 * n_sh
// values a thread, for its two pixels).  The wrapper packs the rows into
// gaussian-major records (u, v, op, a, b, c, rdet, then the coefficients;
// 56 floats at n_sh 16, 14 16-byte words in 7 sectors, where the row-major
// matrix took 54 one-float reads), and the block stages each splat's record
// contiguously, so the walk reads a splat's coefficients as 16-byte
// broadcast loads, once for both of the thread's pixels, and contracts them
// in fused multiply-adds (as B4's phase A).  The tiles are taken heaviest
// first (gs_tile_order, as B1).  The records live in dynamic shared
// memory, two stage buffers of kBatch splats; the host dispatches on n_sh.
#include "common.cuh"

namespace gs {
namespace {

constexpr int kBatch = 64;  // splats gathered at a time

template <int NSH>
struct ShFwd {
  static constexpr int kWords = packed_stride(kShCoeff0 + 3 * NSH) / 4;
  static constexpr int kSmemBytes = 2 * kBatch * kWords * int(sizeof(float4));
};

template <int NSH>
__global__ void __launch_bounds__(kFwdThreads)
    render_sh_fwd_kernel(const float4* __restrict__ rec,
                         const float* __restrict__ basis,
                         const int* __restrict__ gaussian_idx,
                         const int* __restrict__ tile_starts,
                         const int* __restrict__ tile_order, int x_tiles,
                         int n_pix, float* __restrict__ out) {
  constexpr int kWords = ShFwd<NSH>::kWords;
  extern __shared__ float4 s_rec[];

  const int tile = tile_order[blockIdx.x];
  const int t = threadIdx.x;
  const float ox = float((tile % x_tiles) * kTilePx);
  const float oy = float((tile / x_tiles) * kTilePx);
  const int row0 = 2 * (t / kTilePx);
  const float up = float(t % kTilePx) - kHalfTile;
  const float vp0 = float(row0) - kHalfTile;
  const float vp1 = float(row0 + 1) - kHalfTile;
  const int o = tile * kPixelsPerTile + row0 * kTilePx + t % kTilePx;

  float b0[NSH], b1[NSH];
#pragma unroll
  for (int k = 0; k < NSH; ++k) {
    b0[k] = basis[k * n_pix + o];
    b1[k] = basis[k * n_pix + o + kTilePx];
  }

  FwdPixel px0, px1;
  fwd_batches<kWords, kBatch>(
      s_rec, rec, gaussian_idx, tile_starts[tile], tile_starts[tile + 1], ox,
      oy, [&](const float4* st, int count) {
        for (int j = 0; j < count; ++j) {
          if (!px0.live() && !px1.live()) break;
          const float4* sj = st + j * kWords;
          const SplatGeom s = staged_geom(sj);
          const float a0 = splat_alpha(s, up, vp0);
          const float a1 = splat_alpha(s, up, vp1);
          const bool h0 = px0.live() && a0 >= kAlphaSkip;
          const bool h1 = px1.live() && a1 >= kAlphaSkip;
          if (h0 || h1) {
            float c0[3], c1[3];
            sh_colour_pair<NSH>(sj, b0, b1, c0, c1);
            if (h0) px0.add(a0, c0[0], c0[1], c0[2]);
            if (h1) px1.add(a1, c1[0], c1[1], c1[2]);
          }
        }
        return px0.live() || px1.live();
      });
  store_fwd_pixel(out, n_pix, o, px0);
  store_fwd_pixel(out, n_pix, o + kTilePx, px1);
}

template <int NSH>
cudaError_t launch(const float* rec, const float* basis,
                   const int* gaussian_idx, const int* tile_starts,
                   const int* tile_order, int n_tiles, int x_tiles, float* out,
                   cudaStream_t stream) {
  constexpr int smem = ShFwd<NSH>::kSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      render_sh_fwd_kernel<NSH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  render_sh_fwd_kernel<NSH><<<n_tiles, kFwdThreads, smem, stream>>>(
      reinterpret_cast<const float4*>(rec), basis, gaussian_idx, tile_starts,
      tile_order, x_tiles, n_tiles * kPixelsPerTile, out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gs

// rec: (n, packed_stride(6 + 3 * n_sh)) float32 records of gs_pack_fwd_rows
// over the (6 + 3 * n_sh, n) rows u, v, op, a+.25, b/2, c+.25 and the
// coefficients (row 6 + c * n_sh + k); basis: (n_sh, n_tiles * 256) float32
// in tile-major pixel order; gaussian_idx: (S,) int32; tile_starts:
// (n_tiles+1,) int32; tile_order: (n_tiles,) int32, a permutation of the
// tiles (gs_tile_order's); out: (4, n_tiles * 256) float32 rows
// premultiplied r, g, b and T.  n_sh is 4, 9 or 16; any other value returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int gs_render_sh_fwd(const float* rec, const float* basis, int n_sh,
                                const int* gaussian_idx,
                                const int* tile_starts, const int* tile_order,
                                int n_tiles, int x_tiles, float* out,
                                cudaStream_t stream) {
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  switch (n_sh) {
    case 4:
      return static_cast<int>(gs::launch<4>(rec, basis, gaussian_idx,
                                            tile_starts, tile_order, n_tiles,
                                            x_tiles, out, stream));
    case 9:
      return static_cast<int>(gs::launch<9>(rec, basis, gaussian_idx,
                                            tile_starts, tile_order, n_tiles,
                                            x_tiles, out, stream));
    case 16:
      return static_cast<int>(gs::launch<16>(rec, basis, gaussian_idx,
                                             tile_starts, tile_order, n_tiles,
                                             x_tiles, out, stream));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
