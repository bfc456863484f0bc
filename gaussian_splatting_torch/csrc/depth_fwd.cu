// B5: forward-only depth renderer, first alpha crossing per pixel.
//
// Replaces the Pallas kernel gaussian_splatting_tpu/ops/depth.py::_depth_kernel
// (launched by _depth_call).  The plain PyTorch version is
// gaussian_splatting_torch/ops/depth.py::depth_fwd_plain.
//
// Per pixel, walk the tile's depth-sorted splats front to back with the raw
// alpha (no 1/255 skip, no saturation stop), T *= 1 - alpha, and return the
// camera distance of the first splat after which 1 - T > alpha_threshold;
// -1 if none does.
//
// Design: the same block shape as B1 (render_fwd.cu): one block per 16x16
// tile, one thread per pixel, the tile's splats gathered through
// gaussian_idx into shared memory in batches of 256.  A pixel stops at its
// crossing and the block leaves once every pixel has found one
// (__syncthreads_count), which replaces the Pallas kernel's done flag.
//
// What bounds it on the H100: as B1, latency-bound scalar float32 work per
// splat-pixel pair (one expf) with a sequential dependence on T; the walk
// usually ends early because a surface is crossed within the first splats.
#include "common.cuh"

namespace gs {
namespace {

__global__ void __launch_bounds__(kPixelsPerTile)
    depth_fwd_kernel(const float* __restrict__ feat, int n,
                     const int* __restrict__ gaussian_idx,
                     const int* __restrict__ tile_starts, int x_tiles,
                     float alpha_threshold, float* __restrict__ out) {
  __shared__ SplatGeom s_geom[kPixelsPerTile];
  __shared__ float s_dist[kPixelsPerTile];

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const float ox = float((tile % x_tiles) * kTilePx);
  const float oy = float((tile / x_tiles) * kTilePx);
  const float up = float(p % kTilePx) - kHalfTile;
  const float vp = float(p / kTilePx) - kHalfTile;
  const int lo = tile_starts[tile];
  const int hi = tile_starts[tile + 1];

  float T = 1.0f;
  float depth = -1.0f;
  bool found = false;
  for (int base = lo; base < hi; base += kPixelsPerTile) {
    if (__syncthreads_count(!found) == 0) break;
    const int i = base + p;
    if (i < hi) {
      const int g = gaussian_idx[i];
      s_geom[p] = load_geom(feat, n, g, ox, oy);
      s_dist[p] = feat[kFeatDepth * n + g];
    }
    __syncthreads();
    const int count = min(kPixelsPerTile, hi - base);
    for (int j = 0; j < count && !found; ++j) {
      T *= 1.0f - splat_alpha(s_geom[j], up, vp);
      if (1.0f - T > alpha_threshold) {
        depth = s_dist[j];
        found = true;
      }
    }
  }
  out[tile * kPixelsPerTile + p] = depth;
}

}  // namespace
}  // namespace gs

// feat: (7, n) float32 rows u, v, op, a+.25, b/2, c+.25, distance;
// gaussian_idx: (S,) int32; tile_starts: (n_tiles+1,) int32;
// out: (n_tiles * 256,) float32 depth, -1 where nothing crosses.
extern "C" int gs_depth_fwd(const float* feat, int n, const int* gaussian_idx,
                            const int* tile_starts, int n_tiles, int x_tiles,
                            float alpha_threshold, float* out,
                            cudaStream_t stream) {
  if (n_tiles > 0) {
    gs::depth_fwd_kernel<<<n_tiles, gs::kPixelsPerTile, 0, stream>>>(
        feat, n, gaussian_idx, tile_starts, x_tiles, alpha_threshold, out);
  }
  return static_cast<int>(cudaGetLastError());
}
