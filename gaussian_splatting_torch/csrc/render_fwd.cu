// B1: DC forward rasterizer, front-to-back compositing per 16x16 tile.
//
// Replaces the Pallas kernel gaussian_splatting_tpu/ops/render.py::_fwd_kernel
// (launched by _render_fwd).  The plain PyTorch version is
// gaussian_splatting_torch/ops/render.py::render_fwd_plain.
//
// Design: one thread block per tile, one thread per pixel (256 threads).
// The block walks its tile's range of the depth-sorted splat list in batches
// of 256: each thread gathers one splat's features through gaussian_idx
// into shared memory, then every pixel composites the batch in order.  A
// pixel stops once its transmittance T < T_EPS; the block leaves once every
// pixel has stopped (__syncthreads_count), which replaces the Pallas
// kernel's chunk-level saturation flag.
//
// What bounds it on the H100: the per-pixel loop is latency-bound scalar
// float32 work (one expf and ~15 flops per splat-pixel pair) with a
// sequential dependence on T; device memory traffic is small (the features
// of a 64k-gaussian scene fit in L2, and each splat is read once per tile).
// Batching through shared memory turns the 256 per-pixel reads of a splat
// into one gather; the early exit skips the work behind saturated pixels.
// Load balance across tiles (one tile can hold 10x the mean) and warp
// divergence from the per-pixel exit are left for later work.
#include "common.cuh"

namespace gs {
namespace {

struct SplatColour {
  float r, g, b;
};

__global__ void __launch_bounds__(kPixelsPerTile)
    render_fwd_kernel(const float* __restrict__ feat, int n,
                      const int* __restrict__ gaussian_idx,
                      const int* __restrict__ tile_starts, int x_tiles,
                      int n_pix, float* __restrict__ out) {
  __shared__ SplatGeom s_geom[kPixelsPerTile];
  __shared__ SplatColour s_col[kPixelsPerTile];

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const float ox = float((tile % x_tiles) * kTilePx);
  const float oy = float((tile / x_tiles) * kTilePx);
  const float up = float(p % kTilePx) - kHalfTile;
  const float vp = float(p / kTilePx) - kHalfTile;
  const int lo = tile_starts[tile];
  const int hi = tile_starts[tile + 1];

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
      s_col[p] = {feat[kFeatR * n + g], feat[kFeatG * n + g],
                  feat[kFeatBCol * n + g]};
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
      cr += s_col[j].r * w;
      cg += s_col[j].g * w;
      cb += s_col[j].b * w;
      T *= 1.0f - alpha;
    }
    done = done || T < kTEps;
  }
  const int o = tile * kPixelsPerTile + p;
  out[0 * n_pix + o] = cr;
  out[1 * n_pix + o] = cg;
  out[2 * n_pix + o] = cb;
  out[3 * n_pix + o] = T;
}

}  // namespace
}  // namespace gs

// feat: (9, n) float32 rows u, v, op, a+.25, b/2, c+.25, r, g, b (colour
// pre-scaled by SH_0); gaussian_idx: (S,) int32; tile_starts: (n_tiles+1,)
// int32; out: (4, n_tiles * 256) float32 rows premultiplied r, g, b and T.
extern "C" int gs_render_fwd(const float* feat, int n, const int* gaussian_idx,
                             const int* tile_starts, int n_tiles, int x_tiles,
                             float* out, cudaStream_t stream) {
  if (n_tiles > 0) {
    gs::render_fwd_kernel<<<n_tiles, gs::kPixelsPerTile, 0, stream>>>(
        feat, n, gaussian_idx, tile_starts, x_tiles,
        n_tiles * gs::kPixelsPerTile, out);
  }
  return static_cast<int>(cudaGetLastError());
}
