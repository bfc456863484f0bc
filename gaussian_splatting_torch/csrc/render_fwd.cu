// B1: DC forward rasterizer, front-to-back compositing per 16x16 tile, and
// the pack of the per-gaussian rows and the tile order that B1, B3 and B5
// read.
//
// Replaces the Pallas kernel gaussian_splatting_tpu/ops/render.py::_fwd_kernel
// (launched by _render_fwd).  The plain PyTorch version is
// gaussian_splatting_torch/ops/render.py::render_fwd_plain; the pack's is
// ops/render.py::pack_fwd_rows_plain, which the pack matches bitwise.
//
// What bounds it on the H100: the walk, scalar float32 work (one expf and
// ~15 operations per splat-pixel pair a pixel reaches before T < T_EPS, 10
// more where the splat composites) with a sequential dependence on T per
// pixel.  Device memory traffic is small: the features of a 64k-gaussian
// scene fit in L2, and each splat is read once per tile.
//
// Design (common.cuh): one block of 128 threads per tile, each thread two
// vertically adjacent pixels.  The wrapper first packs the (9, n) rows into
// 12-float gaussian-major records (gs_pack_fwd_rows: u, v, op, a, b, c,
// rdet, r, g, b), so a splat's gather is three 16-byte loads (two 32-byte
// sectors) where the row-major matrix took nine one-float reads (nine
// sectors), and orders the tiles by splat count (gs_tile_order): block i
// takes the i-th heaviest tile, so the longest lists (up to 8x the median
// on the garden view) no longer start in the last wave and end the launch.
// The block walks its tile's range of the depth-sorted splat list in
// batches staged in shared memory, gathering the next batch (cp.async)
// while it walks this one; the staged geometry is two 16-byte words read
// as broadcasts, the colour the spare float of the second and a third
// word, read only where one of the thread's pixels composites.  A pixel stops once its T < T_EPS; the block leaves once
// every pixel has stopped (__syncthreads_count), which replaces the Pallas
// kernel's chunk-level saturation flag.
#include "common.cuh"

namespace gs {
namespace {

constexpr int kWords = packed_stride(kFeatBCol + 1) / 4;  // 3 words a splat
constexpr int kBatch = 128;  // splats gathered at a time

__global__ void __launch_bounds__(256)
    pack_fwd_rows_kernel(const float* __restrict__ feat, int n, int rows,
                         float4* __restrict__ rec) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  auto at = [&](int i) -> float {
    if (i < kRecRdet) return feat[i * n + g];
    if (i == kRecRdet) {
      // load_geom's operations, in its order
      const float a = feat[kFeatA * n + g];
      const float b = feat[kFeatB * n + g];
      const float c = feat[kFeatC * n + g];
      const float det = a * c - b * b;
      return 1.0f / det;
    }
    return i - 1 < rows ? feat[(i - 1) * n + g] : 0.0f;
  };
  const int words = packed_stride(rows) / 4;
  for (int w = 0; w < words; ++w) {
    rec[size_t(g) * words + w] =
        make_float4(at(4 * w), at(4 * w + 1), at(4 * w + 2), at(4 * w + 3));
  }
}

// One block: a counting sort of the tiles by splat count, largest first,
// over kOrderBuckets buckets (common.cuh); one thread per bucket.
__global__ void __launch_bounds__(kOrderBuckets)
    tile_order_kernel(const int* __restrict__ tile_starts, int n_tiles,
                      int* __restrict__ order) {
  __shared__ int s_bucket[kOrderBuckets];
  __shared__ int s_warp[kOrderBuckets / kWarpSize];
  const int t = threadIdx.x;
  const int lane = t % kWarpSize, warp = t / kWarpSize;
  auto bucket = [&](int tile) {
    const int count = tile_starts[tile + 1] - tile_starts[tile];
    return kOrderBuckets - 1 - min(count, kOrderBuckets - 1);
  };
  s_bucket[t] = 0;
  __syncthreads();
  for (int tile = t; tile < n_tiles; tile += kOrderBuckets) {
    atomicAdd(&s_bucket[bucket(tile)], 1);
  }
  __syncthreads();
  // exclusive prefix sum of the bucket sizes: within each warp, then over
  // the warps' totals
  const int size = s_bucket[t];
  int incl = size;
  for (int d = 1; d < kWarpSize; d <<= 1) {
    const int y = __shfl_up_sync(kFullMask, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == kWarpSize - 1) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = s_warp[lane];
    for (int d = 1; d < kWarpSize; d <<= 1) {
      const int y = __shfl_up_sync(kFullMask, w, d);
      if (lane >= d) w += y;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  s_bucket[t] = incl - size + (warp > 0 ? s_warp[warp - 1] : 0);
  __syncthreads();
  for (int tile = t; tile < n_tiles; tile += kOrderBuckets) {
    order[atomicAdd(&s_bucket[bucket(tile)], 1)] = tile;
  }
}

__global__ void __launch_bounds__(kFwdThreads)
    render_fwd_kernel(const float4* __restrict__ rec,
                      const int* __restrict__ gaussian_idx,
                      const int* __restrict__ tile_starts,
                      const int* __restrict__ tile_order, int x_tiles,
                      int n_pix, float* __restrict__ out) {
  __shared__ float4 s_rec[2 * kBatch * kWords];

  const int tile = tile_order[blockIdx.x];
  const int t = threadIdx.x;
  const float ox = float((tile % x_tiles) * kTilePx);
  const float oy = float((tile / x_tiles) * kTilePx);
  const int row0 = 2 * (t / kTilePx);
  const float up = float(t % kTilePx) - kHalfTile;
  const float vp0 = float(row0) - kHalfTile;
  const float vp1 = float(row0 + 1) - kHalfTile;

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
            const float cr = sj[1].w;
            const float4 z = sj[2];
            if (h0) px0.add(a0, cr, z.x, z.y);
            if (h1) px1.add(a1, cr, z.x, z.y);
          }
        }
        return px0.live() || px1.live();
      });
  const int o = tile * kPixelsPerTile + row0 * kTilePx + t % kTilePx;
  store_fwd_pixel(out, n_pix, o, px0);
  store_fwd_pixel(out, n_pix, o + kTilePx, px1);
}

}  // namespace
}  // namespace gs

// feat: (rows, n) float32 feature rows, the first six u, v, op, a+.25, b/2,
// c+.25 (B1's or B3's matrix); rec: (n, packed_stride(rows)) float32, 16-byte
// aligned, receives each gaussian's record (common.cuh).  rows < 6 returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int gs_pack_fwd_rows(const float* feat, int n, int rows, float* rec,
                                cudaStream_t stream) {
  if (rows < gs::kShCoeff0) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    gs::pack_fwd_rows_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
        feat, n, rows, reinterpret_cast<float4*>(rec));
  }
  return static_cast<int>(cudaGetLastError());
}

// tile_starts: (n_tiles+1,) int32; order: (n_tiles,) int32, receives the
// tiles by splat count, largest first (counts of 1023 and more tie; ties in
// any order).
extern "C" int gs_tile_order(const int* tile_starts, int n_tiles, int* order,
                             cudaStream_t stream) {
  if (n_tiles > 0) {
    gs::tile_order_kernel<<<1, gs::kOrderBuckets, 0, stream>>>(tile_starts,
                                                               n_tiles, order);
  }
  return static_cast<int>(cudaGetLastError());
}

// rec: (n, 12) float32 records of gs_pack_fwd_rows over the (9, n) rows u, v,
// op, a+.25, b/2, c+.25, r, g, b (colour pre-scaled by SH_0); gaussian_idx:
// (S,) int32; tile_starts: (n_tiles+1,) int32; tile_order: (n_tiles,) int32,
// a permutation of the tiles (gs_tile_order's); out: (4, n_tiles * 256)
// float32 rows premultiplied r, g, b and T.
extern "C" int gs_render_fwd(const float* rec, const int* gaussian_idx,
                             const int* tile_starts, const int* tile_order,
                             int n_tiles, int x_tiles, float* out,
                             cudaStream_t stream) {
  if (n_tiles > 0) {
    gs::render_fwd_kernel<<<n_tiles, gs::kFwdThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(rec), gaussian_idx, tile_starts,
        tile_order, x_tiles, n_tiles * gs::kPixelsPerTile, out);
  }
  return static_cast<int>(cudaGetLastError());
}
