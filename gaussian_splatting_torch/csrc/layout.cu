// The tile layout: which 16x16 tiles each gaussian's ellipse reaches, and
// every tile's splats front to back.  One count kernel, one scan, one fill
// kernel and one stable radix sort.
//
// Replaces no Pallas kernel: the JAX package builds its layout in XLA
// (gaussian_splatting_tpu/culling.py), and the original CUDA reference in
// tile_culling.cu (compute_num_splats_kernel, compute_tiles_kernel, then a
// sort).  The plain PyTorch version is
// gaussian_splatting_torch/culling.py::_layout_plain: ~200 launches and 10
// blocking host reads a layout, the candidate cells (gaussian, tile x, tile
// y) materialised at 12 bytes a cell and gathered several times over.
//
// Per gaussian, the plain version's float32 operations in its order
// (-fmad=false; IEEE division and sqrt, the full-precision atan2f, cosf,
// sinf, logf; min and max that propagate NaN as torch.minimum and amin
// do): the sanitised rows (_sanitised), the opacity-aware Mahalanobis
// radius, the ellipse's oriented box (_obb_and_radius), its clipped tile
// window (_window), then the separating-axis test (_split_axis_test) of
// each of the window's first kMaxWindowCells cells, x outer, y inner.
//   layout_count_kernel  writes each gaussian's hit count and adds the
//                        layout's sizes (splats, visible gaussians, cells
//                        past the cap) into three int64 words;
//   cub ExclusiveSum     turns the counts into each gaussian's first slot;
//   layout_fill_kernel   repeats the test and writes each hit's key
//                        tile << 32 | float32_bits(max(z, 1e-30)) and its
//                        gaussian id from that slot on;
//   cub SortPairs        sorts the keys, carrying the ids, over bits
//                        [0, 32 + bits of the largest tile index): stable,
//                        so equal keys, which only different gaussians can
//                        have (a gaussian meets a tile once), keep the
//                        order of their ids, as the plain stable sort of a
//                        candidate list in gaussian order does;
//   layout_starts_kernel each tile's first splat in the sorted list;
//   layout_tiles_kernel  each tile's count and whether it has any.
// The host reads the three sizes once, between the scan and the fill, to
// size the key and id buffers.
//
// What bounds it on the H100: bytes, most of them the sort's.  A gaussian's
// rows are read twice (count and fill: u, v, a, b, c, z, the visible byte
// and the opacity, 29 B) and its count and first slot written and read
// (20 B); a splat's key and id are written once (12 B), the sort reads its
// keys once for its histograms (8 B) and then reads and writes key and id
// once a pass of 8 bits (24 B a pass: six passes at 45 bits), and the tile
// starts read the sorted keys (8 B).  The separating-axis test is ~70
// float32 operations a cell.  (chip_smoke.py::layout_bytes counts the same.)
//
// Design: one thread a gaussian, 256 a block.  A window of up to
// kOwnCells cells is walked by its own thread; a larger one (up to 4096
// cells) by its whole warp, 32 cells at a time, its box broadcast by
// shuffles, so no thread walks a long window while the other 31 wait.  A
// block's sizes are summed in shared memory and added to device memory by
// one atomic each.  The fill writes a warp-shared window's hits in cell
// order by ballot; a gaussian's own hits in any order would do, since the
// sort key tells them apart.  Kernel names avoid the rasterizer kernels'
// names, which a trace reader matches by substring.
#include <cub/device/device_radix_sort.cuh>
#include <cub/device/device_scan.cuh>
#include <cuda_runtime.h>

#include "common.cuh"

namespace gs {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxWindowCells = 4096;  // culling.MAX_WINDOW_CELLS
constexpr int kOwnCells = 8;           // windows one thread walks alone
// the float32 of the plain code's Python doubles
constexpr float kHalfPi = static_cast<float>(1.5707963267948966);
constexpr float kNeedle = static_cast<float>(1e-16);
constexpr float kOpacityFloor = static_cast<float>(1e-12);
constexpr float kSkip = static_cast<float>(0.00392156862);  // ALPHA_SKIP
constexpr float kInvAlphaSkip = static_cast<float>(1.0 / 0.00392156862);
constexpr float kDepthFloor = static_cast<float>(1e-30);
constexpr float kTile = static_cast<float>(kTilePx);

// The layout's inputs: (N,) rows read through their strides (in elements);
// a null opacity turns the opacity-aware window off.
struct Rows {
  const float* u;
  const float* v;
  const float* a;
  const float* b;
  const float* c;
  const float* z;
  const bool* visible;
  const float* opacity;
  long long su, sv, sa, sb, sc, sz, svis, sop;
  int n;
  float mh_dist;
  int x_tiles, y_tiles;
};

// torch.minimum / maximum / clamp on the card: NaN in, NaN out
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return x != x ? x : fminf(x, hi);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// A gaussian's oriented box (corners tl, tr, bl, br as x, y pairs), its
// axis-aligned bounds and its clipped window: area cells from tile (sx,
// sy), wy tiles high; area 0 where the gaussian is not visible.
struct Splat {
  float o[8];
  float xmin, xmax, ymin, ymax;
  int sx, sy, wy;
  long long area;
};

// (lo, hi) tile bounds of [vmin, vmax] on an axis of n tiles (_window's
// lo_hi): clamped before the cast, as float, then cast as torch casts.
__device__ __forceinline__ void lo_hi(float vmin, float vmax, int n, long long& lo,
                                      long long& hi) {
  lo = static_cast<long long>(clamp(floorf(vmin / kTile), 0.0f, float(n)));
  hi = static_cast<long long>(clamp(floorf(vmax / kTile) + 1.0f, 0.0f, float(n)));
}

__device__ __forceinline__ Splat prep(const Rows& r, int g) {
  Splat s;
  s.area = 0;
  float u = r.u[g * r.su], v = r.v[g * r.sv];
  float a = r.a[g * r.sa], b = r.b[g * r.sb], c = r.c[g * r.sc];
  const float z = r.z[g * r.sz];
  bool vis = r.visible[g * r.svis];
  // _sanitised
  const bool finite = isfinite(u) && isfinite(v) && isfinite(z) && isfinite(a) &&
                      isfinite(b) && isfinite(c);
  if (!finite) {
    u = 0.0f, v = 0.0f, a = 1.0f, b = 0.0f, c = 1.0f;
  }
  vis = vis && finite;
  float mh = r.mh_dist;
  if (r.opacity != nullptr) {
    // the iso-alpha ellipse {mh = 2 ln(op / ALPHA_SKIP)}
    const float op = r.opacity[g * r.sop];
    const float q_max = 2.0f * logf(clamp_min(op, kOpacityFloor) * kInvAlphaSkip);
    mh = clamp_max(sqrtf(clamp_min(q_max, 0.0f)), r.mh_dist);
    vis = vis && op > kSkip;
  }
  if (!vis) return s;
  // _obb_and_radius
  const float mean = (a + c) * 0.5f;
  const float half = sqrtf((a - c) * (a - c) * 0.25f + b * b);
  const float lam1 = mean + half;
  const float lam2 = mean - half;
  const float r_major = mh * sqrtf(clamp_min(lam1, 0.0f));
  const float r_minor = mh * sqrtf(clamp_min(lam2, 0.0f));
  const float theta = fabsf(b) < kNeedle ? (a >= c ? 0.0f : kHalfPi) : atan2f(lam1 - a, b);
  const float ct = cosf(theta), st = sinf(theta);
  s.o[0] = -r_major * ct + r_minor * st + u;
  s.o[1] = -r_major * st - r_minor * ct + v;
  s.o[2] = r_major * ct + r_minor * st + u;
  s.o[3] = r_major * st - r_minor * ct + v;
  s.o[4] = -r_major * ct - r_minor * st + u;
  s.o[5] = -r_major * st + r_minor * ct + v;
  s.o[6] = r_major * ct - r_minor * st + u;
  s.o[7] = r_major * st + r_minor * ct + v;
  // _window
  s.xmin = nan_min(nan_min(nan_min(s.o[0], s.o[2]), s.o[4]), s.o[6]);
  s.xmax = nan_max(nan_max(nan_max(s.o[0], s.o[2]), s.o[4]), s.o[6]);
  s.ymin = nan_min(nan_min(nan_min(s.o[1], s.o[3]), s.o[5]), s.o[7]);
  s.ymax = nan_max(nan_max(nan_max(s.o[1], s.o[3]), s.o[5]), s.o[7]);
  long long sx, ex, sy, ey;
  lo_hi(s.xmin, s.xmax, r.x_tiles, sx, ex);
  lo_hi(s.ymin, s.ymax, r.y_tiles, sy, ey);
  const long long wx = ex - sx > 0 ? ex - sx : 0;
  const long long wy = ey - sy > 0 ? ey - sy : 0;
  s.area = wx * wy;
  s.sx = static_cast<int>(sx);
  s.sy = static_cast<int>(sy);
  s.wy = static_cast<int>(wy);
  return s;
}

__device__ __forceinline__ int window_cells(const Splat& s) {
  return static_cast<int>(s.area < kMaxWindowCells ? s.area : kMaxWindowCells);
}

// One separating axis (ax, ay): the tile's corners' projections against the
// segment p0-p1's (axis_overlap).
__device__ __forceinline__ bool overlap(float ax, float ay, float p0x, float p0y,
                                        float p1x, float p1y, float left, float right,
                                        float top, float bottom) {
  const float tl = ax * left + ay * top;
  const float tr = ax * right + ay * top;
  const float bl = ax * left + ay * bottom;
  const float br = ax * right + ay * bottom;
  const float tmin = nan_min(nan_min(tl, tr), nan_min(bl, br));
  const float tmax = nan_max(nan_max(tl, tr), nan_max(bl, br));
  const float o0 = ax * p0x + ay * p0y;
  const float o1 = ax * p1x + ay * p1y;
  const float omin = nan_min(o0, o1);
  const float omax = nan_max(o0, o1);
  return !((tmin > omax) || (tmax < omin));
}

// Cell k of the window (x outer, y inner): its tile index, or -1 where the
// separating-axis test finds the box clear of it.
__device__ __forceinline__ int cell_tile(const Splat& s, int k, int x_tiles) {
  const int tx = s.sx + k / s.wy;
  const int ty = s.sy + k % s.wy;
  const float left = float(tx) * kTile;
  const float right = left + kTile;
  const float top = float(ty) * kTile;
  const float bottom = top + kTile;
  bool ok = !((s.xmin > right) || (s.xmax < left));
  ok &= !((s.ymin > bottom) || (s.ymax < top));
  // the box's major axis (tr - tl) and minor axis (tr - br)
  ok &= overlap(s.o[2] - s.o[0], s.o[3] - s.o[1], s.o[0], s.o[1], s.o[2], s.o[3], left,
                right, top, bottom);
  ok &= overlap(s.o[2] - s.o[6], s.o[3] - s.o[7], s.o[2], s.o[3], s.o[6], s.o[7], left,
                right, top, bottom);
  return ok ? ty * x_tiles + tx : -1;
}

// Lane src's splat, as every lane of the warp sees it.
__device__ __forceinline__ Splat broadcast(const Splat& s, int src) {
  Splat out;
#pragma unroll
  for (int i = 0; i < 8; ++i) out.o[i] = __shfl_sync(kFullMask, s.o[i], src);
  out.xmin = __shfl_sync(kFullMask, s.xmin, src);
  out.xmax = __shfl_sync(kFullMask, s.xmax, src);
  out.ymin = __shfl_sync(kFullMask, s.ymin, src);
  out.ymax = __shfl_sync(kFullMask, s.ymax, src);
  out.sx = __shfl_sync(kFullMask, s.sx, src);
  out.sy = __shfl_sync(kFullMask, s.sy, src);
  out.wy = __shfl_sync(kFullMask, s.wy, src);
  out.area = __shfl_sync(kFullMask, s.area, src);
  return out;
}

// The block's sum of x, added to *out by thread 0 (every thread calls it).
__device__ __forceinline__ void block_add(unsigned x, unsigned* s_part,
                                          unsigned long long* out) {
  const int lane = threadIdx.x % kWarpSize, warp = threadIdx.x / kWarpSize;
  x = __reduce_add_sync(kFullMask, x);
  if (lane == 0) s_part[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t = 0;
    for (int w = 0; w < kThreads / kWarpSize; ++w) t += s_part[w];
    if (t != 0) atomicAdd(out, t);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    layout_count_kernel(const Rows r, int* __restrict__ counts,
                        unsigned long long* __restrict__ sizes) {
  __shared__ unsigned s_part[kThreads / kWarpSize];
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x % kWarpSize;
  Splat s;
  s.area = 0;
  if (g < r.n) s = prep(r, g);
  const int cells = window_cells(s);
  unsigned hits = 0;
  if (cells <= kOwnCells) {
    for (int k = 0; k < cells; ++k) hits += cell_tile(s, k, r.x_tiles) >= 0;
  }
  // the warp walks each larger window together
  for (unsigned big = __ballot_sync(kFullMask, cells > kOwnCells); big; big &= big - 1) {
    const int src = __ffs(big) - 1;
    const Splat w = broadcast(s, src);
    const int w_cells = window_cells(w);
    unsigned total = 0;
    for (int k0 = 0; k0 < w_cells; k0 += kWarpSize) {
      const int k = k0 + lane;
      total += __popc(__ballot_sync(kFullMask, k < w_cells && cell_tile(w, k, r.x_tiles) >= 0));
    }
    if (lane == src) hits = total;
  }
  if (g < r.n) counts[g] = static_cast<int>(hits);
  const long long past = s.area - kMaxWindowCells;
  block_add(hits, s_part, sizes);
  block_add(s.area > 0 ? 1u : 0u, s_part, sizes + 1);
  block_add(past > 0 ? static_cast<unsigned>(past) : 0u, s_part, sizes + 2);
}

__global__ void __launch_bounds__(kThreads)
    layout_fill_kernel(const Rows r, const int* __restrict__ counts,
                       const int* __restrict__ first, unsigned long long* __restrict__ keys,
                       int* __restrict__ ids) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x % kWarpSize;
  Splat s;
  s.area = 0;
  int slot = 0;
  unsigned long long depth = 0;
  // a gaussian without hits has nothing to write
  if (g < r.n && counts[g] > 0) {
    s = prep(r, g);
    slot = first[g];
    depth = static_cast<unsigned>(__float_as_int(clamp_min(r.z[g * r.sz], kDepthFloor)));
  }
  const int cells = window_cells(s);
  if (cells <= kOwnCells) {
    for (int k = 0; k < cells; ++k) {
      const int tile = cell_tile(s, k, r.x_tiles);
      if (tile >= 0) {
        keys[slot] = static_cast<unsigned long long>(tile) << 32 | depth;
        ids[slot] = g;
        ++slot;
      }
    }
  }
  for (unsigned big = __ballot_sync(kFullMask, cells > kOwnCells); big; big &= big - 1) {
    const int src = __ffs(big) - 1;
    const Splat w = broadcast(s, src);
    const int w_cells = window_cells(w);
    const int w_g = __shfl_sync(kFullMask, g, src);
    const unsigned long long w_depth = __shfl_sync(kFullMask, depth, src);
    int w_slot = __shfl_sync(kFullMask, slot, src);
    for (int k0 = 0; k0 < w_cells; k0 += kWarpSize) {
      const int k = k0 + lane;
      const int tile = k < w_cells ? cell_tile(w, k, r.x_tiles) : -1;
      const unsigned m = __ballot_sync(kFullMask, tile >= 0);
      if (tile >= 0) {
        const int at = w_slot + __popc(m & ((1u << lane) - 1));
        keys[at] = static_cast<unsigned long long>(tile) << 32 | w_depth;
        ids[at] = w_g;
      }
      w_slot += __popc(m);
    }
  }
}

// starts[t] = the first i with key[i] >> 32 >= t, for t = 0..n_tiles (the
// plain version's searchsorted); thread i writes the starts of the tiles in
// (tile of i - 1, tile of i], with tile n_tiles past the end.
__global__ void layout_starts_kernel(const unsigned long long* __restrict__ keys, int s,
                                     int n_tiles, int* __restrict__ starts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i > s) return;
  const int t = i < s ? static_cast<int>(keys[i] >> 32) : n_tiles;
  const int prev = i > 0 ? static_cast<int>(keys[i - 1] >> 32) : -1;
  for (int tt = prev + 1; tt <= t; ++tt) starts[tt] = i;
}

__global__ void layout_tiles_kernel(const int* __restrict__ starts, int n_tiles,
                                    int* __restrict__ tile_counts, bool* __restrict__ has) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_tiles) return;
  const int c = starts[t + 1] - starts[t];
  tile_counts[t] = c;
  has[t] = c > 0;
}

Rows unpack(const long long* ptrs, const long long* strides, int n, float mh_dist,
            int x_tiles, int y_tiles) {
  Rows r;
  r.u = reinterpret_cast<const float*>(ptrs[0]);
  r.v = reinterpret_cast<const float*>(ptrs[1]);
  r.a = reinterpret_cast<const float*>(ptrs[2]);
  r.b = reinterpret_cast<const float*>(ptrs[3]);
  r.c = reinterpret_cast<const float*>(ptrs[4]);
  r.z = reinterpret_cast<const float*>(ptrs[5]);
  r.visible = reinterpret_cast<const bool*>(ptrs[6]);
  r.opacity = reinterpret_cast<const float*>(ptrs[7]);
  r.su = strides[0], r.sv = strides[1], r.sa = strides[2], r.sb = strides[3];
  r.sc = strides[4], r.sz = strides[5], r.svis = strides[6], r.sop = strides[7];
  r.n = n;
  r.mh_dist = mh_dist;
  r.x_tiles = x_tiles;
  r.y_tiles = y_tiles;
  return r;
}

}  // namespace
}  // namespace gs

// The scratch bytes (host) of the scan of n counts and of the sort of s
// keys over bits [0, end_bit): out[0] and out[1].  Launches nothing.
extern "C" int gs_layout_temp_bytes(int n, int s, int end_bit, long long* out) {
  size_t scan = 0, sort = 0;
  cudaError_t err = cub::DeviceScan::ExclusiveSum(nullptr, scan, static_cast<const int*>(nullptr),
                                                  static_cast<int*>(nullptr), n > 0 ? n : 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cub::DoubleBuffer<unsigned long long> keys(nullptr, nullptr);
  cub::DoubleBuffer<int> ids(nullptr, nullptr);
  err = cub::DeviceRadixSort::SortPairs(nullptr, sort, keys, ids, s > 0 ? s : 1, 0, end_bit);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = static_cast<long long>(scan);
  out[1] = static_cast<long long>(sort);
  return 0;
}

// ptrs, strides (host, int64, strides in elements): u, v, a, b, c, z
// (float32), visible (bool), opacity (float32; 0 for none); the regularised
// entries a = conic0 + 1/4, b = conic1 / 2, c = conic2 + 1/4.  Writes counts
// (n,) int32, first (n,) int32 (their exclusive prefix sum) and sizes (3,)
// int64: splats, visible gaussians, window cells past the cap.  temp: the
// scan's scratch (gs_layout_temp_bytes' out[0]).
extern "C" int gs_layout_count(const long long* ptrs, const long long* strides, int n,
                               float mh_dist, int x_tiles, int y_tiles, int* counts,
                               int* first, unsigned long long* sizes, void* temp,
                               long long temp_bytes, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(sizes, 0, 3 * sizeof(unsigned long long), stream);
  if (err != cudaSuccess || n <= 0) return static_cast<int>(err);
  const gs::Rows r = gs::unpack(ptrs, strides, n, mh_dist, x_tiles, y_tiles);
  gs::layout_count_kernel<<<(n + gs::kThreads - 1) / gs::kThreads, gs::kThreads, 0, stream>>>(
      r, counts, sizes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t bytes = static_cast<size_t>(temp_bytes);
  err = cub::DeviceScan::ExclusiveSum(temp, bytes, counts, first, n, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ptrs, strides, n, mh_dist and the grid as for gs_layout_count; counts and
// first its outputs.  Writes keys (S,) int64 and ids (S,) int32, S = the
// sum of counts, each gaussian's hits from its first slot on.
extern "C" int gs_layout_fill(const long long* ptrs, const long long* strides, int n,
                              float mh_dist, int x_tiles, int y_tiles, const int* counts,
                              const int* first, unsigned long long* keys, int* ids,
                              cudaStream_t stream) {
  if (n <= 0) return 0;
  const gs::Rows r = gs::unpack(ptrs, strides, n, mh_dist, x_tiles, y_tiles);
  gs::layout_fill_kernel<<<(n + gs::kThreads - 1) / gs::kThreads, gs::kThreads, 0, stream>>>(
      r, counts, first, keys, ids);
  return static_cast<int>(cudaGetLastError());
}

// keys0/ids0: gs_layout_fill's (s,) keys and ids; keys1/ids1: (s,) buffers
// of the same types.  Sorts the pairs by the key's bits [0, end_bit)
// (stable), then writes starts (n_tiles+1,) int32, tile_counts (n_tiles,)
// int32 and has (n_tiles,) bool.  *selector (host) receives which buffer,
// 0 or 1, holds the sorted pairs.  temp: the sort's scratch
// (gs_layout_temp_bytes' out[1]).
extern "C" int gs_layout_sort(unsigned long long* keys0, unsigned long long* keys1, int* ids0,
                              int* ids1, int s, int end_bit, void* temp, long long temp_bytes,
                              int n_tiles, int* starts, int* tile_counts, bool* has,
                              int* selector, cudaStream_t stream) {
  cub::DoubleBuffer<unsigned long long> keys(keys0, keys1);
  cub::DoubleBuffer<int> ids(ids0, ids1);
  if (s > 0) {
    size_t bytes = static_cast<size_t>(temp_bytes);
    const cudaError_t err =
        cub::DeviceRadixSort::SortPairs(temp, bytes, keys, ids, s, 0, end_bit, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (keys.selector != ids.selector) return static_cast<int>(cudaErrorUnknown);
  }
  *selector = keys.selector;
  gs::layout_starts_kernel<<<(s + 1 + 255) / 256, 256, 0, stream>>>(keys.Current(), s, n_tiles,
                                                                    starts);
  if (n_tiles > 0) {
    gs::layout_tiles_kernel<<<(n_tiles + 255) / 256, 256, 0, stream>>>(starts, n_tiles,
                                                                      tile_counts, has);
  }
  return static_cast<int>(cudaGetLastError());
}
