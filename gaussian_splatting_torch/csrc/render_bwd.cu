// B2: DC backward rasterizer, the VJP of B1's raw output.
//
// Replaces the Pallas kernel gaussian_splatting_tpu/ops/render.py::_bwd_kernel
// (launched by _render_bwd) and the permutation-inversion sort that reduces
// its per-splat rows onto gaussians (culling.py::_reduce_splat_grads).  The
// plain PyTorch version is
// gaussian_splatting_torch/ops/render.py::render_bwd_plain.
//
// Semantics (the JAX backward's): per pixel, E = sum_ch raw_ch * g_ch +
// g_T * T is what the loss sees behind the pixel's front.  The splats are
// walked front to back again with alpha clamped at kAlphaClamp (in T, in the
// T_EPS stop, in the weights and in 1 / (1 - alpha)), carrying T and the
// inclusive colour prefix pg = sum A * w, A = sum_ch g_ch * rgb_ch.  Then
// D = E - pg is what lies behind a splat and q = alpha * dL/dalpha =
// at * (A * T - D / (1 - at)); the nine gradient terms are the direct
// per-pixel derivatives of alpha = op * exp(-mh / 2) (docs/MATH.md).
//
// Design: B1's skeleton.  One thread block per tile, one thread per pixel;
// the block gathers 256 splats at a time through gaussian_idx into shared
// memory.  Walking front to back needs nothing from B1 beyond its output.
// A pixel stops once T < T_EPS; the block leaves once every pixel has
// stopped (__syncthreads_count).  Each pixel's nine terms for a splat are
// summed over the warp with shuffles (skipped when no lane of the warp saw
// the splat), the eight warp sums go to shared memory, and after a round of
// kRound splats the block adds them up and issues one atomicAdd per (splat,
// tile, row) into grad_feat.  That replaces the TPU's scatter-free
// reduction by sorting; per-pixel atomics would be 256 times as many, all on
// one address per splat.
//
// What bounds it on the H100: like B1, latency-bound scalar float32 work per
// splat-pixel pair (one expf, ~60 flops) plus 45 shuffles per warp and
// splat, and two barriers per round of kRound splats; device memory traffic
// is small (features read once per tile, nine atomics per splat and tile).
// The Pallas kernel's moment matmul and triangular prefix matmuls are MXU
// devices and are not carried over.  Load balance across tiles and the
// barrier cost are left for later work.
#include "common.cuh"

namespace gs {
namespace {

constexpr int kGradRows = 9;  // grad_feat has the rows of feat
constexpr int kRound = 32;    // splats per block-wide reduction round

struct SplatColour {
  float r, g, b;
};

__global__ void __launch_bounds__(kPixelsPerTile)
    render_bwd_kernel(const float* __restrict__ feat, int n,
                      const int* __restrict__ gaussian_idx,
                      const int* __restrict__ tile_starts, int x_tiles,
                      int n_pix, const float* __restrict__ raw,
                      const float* __restrict__ grad_raw,
                      float* __restrict__ grad_feat) {
  __shared__ SplatGeom s_geom[kPixelsPerTile];
  __shared__ SplatColour s_col[kPixelsPerTile];
  __shared__ int s_gid[kPixelsPerTile];
  __shared__ float s_part[kWarps][kRound][kGradRows];

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
      s_col[p] = {feat[kFeatR * n + g], feat[kFeatG * n + g],
                  feat[kFeatBCol * n + g]};
    }
    __syncthreads();
    const int count = min(kPixelsPerTile, hi - base);
    for (int r0 = 0; r0 < count; r0 += kRound) {
      for (int jj = 0; jj < kRound; ++jj) {
        const int j = r0 + jj;
        float v[kGradRows];
#pragma unroll
        for (int k = 0; k < kGradRows; ++k) v[k] = 0.0f;
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
              const float w = at * T;
              const SplatColour col = s_col[j];
              const float A = g_r * col.r + g_g * col.g + g_b * col.b;
              pg += A * w;
              const float d = e - pg;
              const float roma = 1.0f / (1.0f - at);
              const float q = at * (A * T - d * roma);
              const float rq = q * s.rdet;
              v[0] = rq * (s.c * t.du - s.b * t.dv);
              v[1] = rq * (s.a * t.dv - s.b * t.du);
              v[2] = q / fmaxf(s.op, 1e-30f);
              v[3] = (-0.5f * rq) * (t.dv * t.dv - s.c * t.mh);
              v[4] = rq * (t.du * t.dv - s.b * t.mh);
              v[5] = (-0.5f * rq) * (t.du * t.du - s.a * t.mh);
              v[6] = g_r * w;
              v[7] = g_g * w;
              v[8] = g_b * w;
              T *= 1.0f - at;
            }
          }
        }
        // warp-uniform: every lane runs the loops above the same number of
        // times
        if (__any_sync(kFullMask, hit)) {
#pragma unroll
          for (int k = 0; k < kGradRows; ++k) {
#pragma unroll
            for (int off = kWarpSize / 2; off > 0; off /= 2) {
              v[k] += __shfl_down_sync(kFullMask, v[k], off);
            }
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int k = 0; k < kGradRows; ++k) s_part[warp][jj][k] = v[k];
        }
      }
      __syncthreads();
      for (int x = p; x < kRound * kGradRows; x += kPixelsPerTile) {
        const int jj = x / kGradRows;
        const int k = x % kGradRows;
        const int j = r0 + jj;
        if (j < count) {
          float sum = 0.0f;
#pragma unroll
          for (int wp = 0; wp < kWarps; ++wp) sum += s_part[wp][jj][k];
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

}  // namespace
}  // namespace gs

// feat: (9, n) float32 feature rows as for gs_render_fwd; raw: (4, n_tiles *
// 256) float32, gs_render_fwd's output; grad_raw: its cotangent, same shape;
// grad_feat: (9, n) float32, zero-filled by the caller, receives the
// gradient of every feature row.
extern "C" int gs_render_bwd(const float* feat, int n, const int* gaussian_idx,
                             const int* tile_starts, int n_tiles, int x_tiles,
                             const float* raw, const float* grad_raw,
                             float* grad_feat, cudaStream_t stream) {
  if (n_tiles > 0) {
    gs::render_bwd_kernel<<<n_tiles, gs::kPixelsPerTile, 0, stream>>>(
        feat, n, gaussian_idx, tile_starts, x_tiles,
        n_tiles * gs::kPixelsPerTile, raw, grad_raw, grad_feat);
  }
  return static_cast<int>(cudaGetLastError());
}
