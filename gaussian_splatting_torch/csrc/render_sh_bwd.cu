// B4: per-pixel spherical-harmonics backward rasterizer, the VJP of B3's
// raw output.
//
// Replaces the Pallas kernel gaussian_splatting_tpu/ops/render_sh.py::_bwd_kernel
// (launched by _render_bwd) and the permutation-inversion sort that reduces
// its per-splat rows onto gaussians.  The plain PyTorch version is
// gaussian_splatting_torch/ops/render_sh.py::render_sh_bwd_plain.
//
// Semantics (the JAX backward's, as B2's in render_bwd.cu): per pixel, E =
// sum_c raw_c * g_c + g_T * T; the splats are walked front to back again
// with alpha clamped at kAlphaClamp (in T, in the T_EPS stop, in the weights
// and in 1 / (1 - alpha)), carrying T and the inclusive prefix pg = sum A *
// w, where A = sum_c g_c * colour_c and colour_c = sum_k coeff[c * n_sh + k]
// * basis_k is the splat's colour at the pixel.  q = at * (A * T - (E - pg)
// / (1 - at)) gives the six geometry rows as in B2; the 3 * n_sh coefficient
// rows are (g_c * basis_k) * w.  The basis gets no gradient, so in this path
// a gaussian's centre gets its gradient only through u, v and the conic.
//
// Design: B2's skeleton, a template on n_sh (4, 9, 16).  One block per
// tile, one thread per pixel; 256 splats' geometry and coefficients are
// gathered into dynamic shared memory (90 KB at n_sh = 16 with the partial
// sums below, past the 48 KB of static shared memory; the launcher raises
// the limit with cudaFuncSetAttribute).  Each pixel has 6 + 3 * n_sh terms
// per splat (54 at n_sh = 16), against B2's 9.  B2's per-row shuffle
// reduction would cost 5 shuffles per row, 270 per warp and splat here; this
// kernel reduces the rows over the warp by recursive halving instead (a
// reduce-scatter: at each of 5 steps a lane sends half of its rows to its
// partner and keeps the other half), 31 shuffles per 32 rows, after which
// lane l holds the warp sum of rows l and 32 + l.  Staging the weights in
// shared memory and reducing the coefficient rows as a (3 * n_sh, 256) x
// (256, splats) product was the other choice; it costs the same whatever the
// pixels hit, where the shuffles are skipped for a splat that no lane of the
// warp hit (__any_sync).  The eight warp sums go to shared memory, and after
// a round of kRound splats the block adds them up and issues one atomicAdd
// per (splat, tile, row), skipping zero sums, as B2 does.
//
// What bounds it on the H100: per splat-pixel pair that a pixel reaches
// before T < T_EPS, B2's ~60 float32 operations with the colour terms
// replaced by the contraction (2 * 3 * n_sh), A (2 * 3), and the
// coefficient rows (2 * 3 * n_sh), ~250 at n_sh = 16, against 67 TFLOP/s;
// plus 62 shuffles per warp and splat and two barriers per round.  Device
// memory traffic is small next to that (features, basis, raw output and
// cotangent read once, the gradient written by atomics).
#include "common.cuh"

namespace gs {
namespace {

constexpr int kRound = 16;  // splats per block-wide reduction round

template <int NSH>
struct ShBwd {
  static constexpr int kCoeffRows = 3 * NSH;
  static constexpr int kRows = kShCoeff0 + kCoeffRows;  // rows of grad_feat
  static constexpr int kRowsPad = (kRows + kWarpSize - 1) / kWarpSize * kWarpSize;
  static constexpr int kSmemBytes =
      kPixelsPerTile * (int(sizeof(SplatGeom)) + kCoeffRows * int(sizeof(float)) +
                        int(sizeof(int))) +
      kWarps * kRound * kRowsPad * int(sizeof(float));
};

// One step of the warp's recursive halving: lanes with the bit HALF set
// keep the upper half of each group of 2 * HALF rows and send the lower
// half to their partner, the others the reverse.
template <int HALF, int R>
__device__ __forceinline__ void halve(float (&v)[R], int lane) {
  const bool upper = (lane & HALF) != 0;
#pragma unroll
  for (int m = 0; m < R; m += kWarpSize) {
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const float send = upper ? v[m + i] : v[m + i + HALF];
      const float keep = upper ? v[m + i + HALF] : v[m + i];
      v[m + i] = keep + __shfl_xor_sync(kFullMask, send, HALF);
    }
  }
}

// Sums v over the warp; afterwards v[32 * m] holds, in lane l, the warp sum
// of row 32 * m + l.  R is a multiple of 32.  Each step is a template, so
// every index is a constant and v stays in registers.
template <int R>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[R], int lane) {
  halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
}

template <int NSH>
__global__ void __launch_bounds__(kPixelsPerTile)
    render_sh_bwd_kernel(const float* __restrict__ feat, int n,
                         const float* __restrict__ basis,
                         const int* __restrict__ gaussian_idx,
                         const int* __restrict__ tile_starts, int x_tiles,
                         int n_pix, const float* __restrict__ raw,
                         const float* __restrict__ grad_raw,
                         float* __restrict__ grad_feat) {
  using L = ShBwd<NSH>;
  extern __shared__ float s_mem[];
  SplatGeom* s_geom = reinterpret_cast<SplatGeom*>(s_mem);
  // s_coeff[r * kPixelsPerTile + j]: coefficient row r of batch splat j
  float* s_coeff = reinterpret_cast<float*>(s_geom + kPixelsPerTile);
  int* s_gid = reinterpret_cast<int*>(s_coeff + L::kCoeffRows * kPixelsPerTile);
  // s_part[(warp * kRound + jj) * kRowsPad + row]: a warp's sum for splat jj
  float* s_part = reinterpret_cast<float*>(s_gid + kPixelsPerTile);

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p / kWarpSize;
  const int lane = p % kWarpSize;
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
  const float g_r = grad_raw[0 * n_pix + o];
  const float g_g = grad_raw[1 * n_pix + o];
  const float g_b = grad_raw[2 * n_pix + o];
  const float g_t = grad_raw[3 * n_pix + o];
  const float e = raw[0 * n_pix + o] * g_r + raw[1 * n_pix + o] * g_g +
                  raw[2 * n_pix + o] * g_b + g_t * raw[3 * n_pix + o];

  float T = 1.0f;
  float pg = 0.0f;
  bool done = false;
  for (int base = lo; base < hi; base += kPixelsPerTile) {
    // also the barrier that keeps the previous batch alive until every
    // pixel has finished with it
    if (__syncthreads_count(!done) == 0) break;
    const int i = base + p;
    if (i < hi) {
      const int g = gaussian_idx[i];
      s_gid[p] = g;
      s_geom[p] = load_geom(feat, n, g, ox, oy);
#pragma unroll
      for (int r = 0; r < L::kCoeffRows; ++r) {
        s_coeff[r * kPixelsPerTile + p] = feat[(kShCoeff0 + r) * n + g];
      }
    }
    __syncthreads();
    const int count = min(kPixelsPerTile, hi - base);
    for (int r0 = 0; r0 < count; r0 += kRound) {
      for (int jj = 0; jj < kRound; ++jj) {
        const int j = r0 + jj;
        // this pixel's terms for splat j; zero unless the splat composites
        // here, so a lane that did not hit adds exact zeros
        float q = 0.0f, rq = 0.0f, w = 0.0f, sop = 0.0f;
        float du = 0.0f, dv = 0.0f, mh = 0.0f, sa = 0.0f, sb = 0.0f, sc = 0.0f;
        bool hit = false;
        if (j < count && !done) {
          if (T < kTEps) {
            done = true;
          } else {
            const SplatGeom& s = s_geom[j];
            const SplatPixel t = splat_pixel(s, up, vp);
            if (t.alpha >= kAlphaSkip) {
              hit = true;
              const float at = fminf(t.alpha, kAlphaClamp);
              w = at * T;
              const float* c = s_coeff + j;
              const float col_r = sh_colour<NSH>(c, b);
              const float col_g = sh_colour<NSH>(c + NSH * kPixelsPerTile, b);
              const float col_b = sh_colour<NSH>(c + 2 * NSH * kPixelsPerTile, b);
              const float A = g_r * col_r + g_g * col_g + g_b * col_b;
              pg += A * w;
              const float d = e - pg;
              const float roma = 1.0f / (1.0f - at);
              q = at * (A * T - d * roma);
              rq = q * s.rdet;
              du = t.du, dv = t.dv, mh = t.mh;
              sop = s.op, sa = s.a, sb = s.b, sc = s.c;
              T *= 1.0f - at;
            }
          }
        }
        float* part = s_part + (warp * kRound + jj) * L::kRowsPad + lane;
        // warp-uniform: every lane runs the loops above the same number of
        // times; with no hit in the warp every row sums to zero
        if (__any_sync(kFullMask, hit)) {
          float v[L::kRowsPad];
          v[0] = rq * (sc * du - sb * dv);
          v[1] = rq * (sa * dv - sb * du);
          v[2] = q / fmaxf(sop, 1e-30f);
          v[3] = (-0.5f * rq) * (dv * dv - sc * mh);
          v[4] = rq * (du * dv - sb * mh);
          v[5] = (-0.5f * rq) * (du * du - sa * mh);
#pragma unroll
          for (int k = 0; k < NSH; ++k) {
            v[kShCoeff0 + k] = (g_r * b[k]) * w;
            v[kShCoeff0 + NSH + k] = (g_g * b[k]) * w;
            v[kShCoeff0 + 2 * NSH + k] = (g_b * b[k]) * w;
          }
#pragma unroll
          for (int k = L::kRows; k < L::kRowsPad; ++k) v[k] = 0.0f;
          warp_reduce_scatter(v, lane);
#pragma unroll
          for (int m = 0; m < L::kRowsPad; m += kWarpSize) part[m] = v[m];
        } else {
#pragma unroll
          for (int m = 0; m < L::kRowsPad; m += kWarpSize) part[m] = 0.0f;
        }
      }
      __syncthreads();
      for (int x = p; x < kRound * L::kRows; x += kPixelsPerTile) {
        const int jj = x / L::kRows;
        const int k = x % L::kRows;
        const int j = r0 + jj;
        if (j < count) {
          float sum = 0.0f;
#pragma unroll
          for (int wp = 0; wp < kWarps; ++wp) {
            sum += s_part[(wp * kRound + jj) * L::kRowsPad + k];
          }
          // adding zero changes nothing; NaN still goes through
          if (sum != 0.0f) atomicAdd(&grad_feat[k * n + s_gid[j]], sum);
        }
      }
      // s_part is rewritten by the next round
      __syncthreads();
    }
    done = done || T < kTEps;
  }
}

template <int NSH>
cudaError_t launch(const float* feat, int n, const float* basis,
                   const int* gaussian_idx, const int* tile_starts,
                   int n_tiles, int x_tiles, const float* raw,
                   const float* grad_raw, float* grad_feat,
                   cudaStream_t stream) {
  constexpr int smem = ShBwd<NSH>::kSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      render_sh_bwd_kernel<NSH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  render_sh_bwd_kernel<NSH><<<n_tiles, kPixelsPerTile, smem, stream>>>(
      feat, n, basis, gaussian_idx, tile_starts, x_tiles,
      n_tiles * kPixelsPerTile, raw, grad_raw, grad_feat);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gs

// feat, basis, gaussian_idx, tile_starts, n_sh as for gs_render_sh_fwd; raw:
// (4, n_tiles * 256) float32, gs_render_sh_fwd's output; grad_raw: its
// cotangent, same shape; grad_feat: (6 + 3 * n_sh, n) float32, zero-filled
// by the caller, receives the gradient of every feature row.  n_sh other
// than 4, 9 or 16 returns cudaErrorInvalidValue and launches nothing.
extern "C" int gs_render_sh_bwd(const float* feat, int n, const float* basis,
                                int n_sh, const int* gaussian_idx,
                                const int* tile_starts, int n_tiles,
                                int x_tiles, const float* raw,
                                const float* grad_raw, float* grad_feat,
                                cudaStream_t stream) {
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  switch (n_sh) {
    case 4:
      return static_cast<int>(gs::launch<4>(feat, n, basis, gaussian_idx,
                                            tile_starts, n_tiles, x_tiles, raw,
                                            grad_raw, grad_feat, stream));
    case 9:
      return static_cast<int>(gs::launch<9>(feat, n, basis, gaussian_idx,
                                            tile_starts, n_tiles, x_tiles, raw,
                                            grad_raw, grad_feat, stream));
    case 16:
      return static_cast<int>(gs::launch<16>(feat, n, basis, gaussian_idx,
                                             tile_starts, n_tiles, x_tiles,
                                             raw, grad_raw, grad_feat, stream));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
