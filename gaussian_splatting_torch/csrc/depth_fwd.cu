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
// What bounds it on the H100: as B1, latency-bound scalar float32 work per
// splat-pixel pair (one expf) with a sequential dependence on T; most
// pixels cross within their first splats, but a block lasts as long as its
// slowest pixel, and a pixel that never crosses (sky, the image's edges)
// walks its tile's whole list.
//
// Design (common.cuh): the wrapper packs the (7, n) depth rows into
// gaussian-major records of two 16-byte words, u, v, op, a, b, c, rdet,
// distance (gs_pack_fwd_rows in render_fwd.cu: the distance lands on the
// float that staged_geom leaves spare), and orders the tiles by splat count,
// largest first (gs_tile_order), as for B1.  One block of 256 threads per
// tile, one pixel each; the tile's splat list is staged in batches of 64,
// the next gathered by cp.async while this one is walked (fwd_batches).  A
// pixel stops at its crossing; the block leaves once all 256 pixels have
// crossed (__syncthreads_count), which replaces the Pallas kernel's done
// flag.  B1's two pixels a thread do not pay here: most pixels stop within
// a few splats, and a thread walks on while either of its pixels has not
// crossed, so on the H100 that shape took 11% longer than one pixel a
// thread over the row-major matrix, and 48% longer than this kernel
// (PERF.md).  The alpha comes from the operations of load_geom and
// splat_alpha in their order (rdet from the pack, u and v made tile-local as
// (u - ox) - 7.5), so the depth equals depth_fwd_plain(chunk=1)'s, which
// multiplies T in the same order, bit for bit.
#include "common.cuh"

namespace gs {
namespace {

constexpr int kWords = packed_stride(kFeatDepth + 1) / 4;  // 2 words a splat
constexpr int kBatch = 64;  // splats gathered at a time

// One pixel's walk: T, and the distance of the first crossing.
struct DepthPixel {
  float T = 1.0f, depth = -1.0f;
  bool found = false;
  __device__ __forceinline__ void add(float alpha, float dist, float threshold) {
    T *= 1.0f - alpha;
    if (1.0f - T > threshold) {
      depth = dist;
      found = true;
    }
  }
};

__global__ void __launch_bounds__(kPixelsPerTile)
    depth_fwd_kernel(const float4* __restrict__ rec,
                     const int* __restrict__ gaussian_idx,
                     const int* __restrict__ tile_starts,
                     const int* __restrict__ tile_order, int x_tiles,
                     float alpha_threshold, float* __restrict__ out) {
  __shared__ float4 s_rec[2 * kBatch * kWords];

  const int tile = tile_order[blockIdx.x];
  const int p = threadIdx.x;
  const float ox = float((tile % x_tiles) * kTilePx);
  const float oy = float((tile / x_tiles) * kTilePx);
  const float up = float(p % kTilePx) - kHalfTile;
  const float vp = float(p / kTilePx) - kHalfTile;

  DepthPixel px;
  fwd_batches<kWords, kBatch, kPixelsPerTile>(
      s_rec, rec, gaussian_idx, tile_starts[tile], tile_starts[tile + 1], ox,
      oy, [&](const float4* st, int count) {
        for (int j = 0; j < count && !px.found; ++j) {
          const float4* sj = st + j * kWords;
          px.add(splat_alpha(staged_geom(sj), up, vp), sj[1].w, alpha_threshold);
        }
        return !px.found;
      });
  out[tile * kPixelsPerTile + p] = px.depth;
}

}  // namespace
}  // namespace gs

// rec: (n, 8) float32 records of gs_pack_fwd_rows over the (7, n) rows u, v,
// op, a+.25, b/2, c+.25, distance; gaussian_idx: (S,) int32; tile_starts:
// (n_tiles+1,) int32; tile_order: (n_tiles,) int32, a permutation of the
// tiles (gs_tile_order's); out: (n_tiles * 256,) float32 depth, -1 where
// nothing crosses.
extern "C" int gs_depth_fwd(const float* rec, const int* gaussian_idx,
                            const int* tile_starts, const int* tile_order,
                            int n_tiles, int x_tiles, float alpha_threshold,
                            float* out, cudaStream_t stream) {
  if (n_tiles > 0) {
    gs::depth_fwd_kernel<<<n_tiles, gs::kPixelsPerTile, 0, stream>>>(
        reinterpret_cast<const float4*>(rec), gaussian_idx, tile_starts,
        tile_order, x_tiles, alpha_threshold, out);
  }
  return static_cast<int>(cudaGetLastError());
}
