// Shared constants and per-splat math of the tile rasterizer kernels.
// Values match gaussian_splatting_torch/ops/common.py.
#pragma once

#include <cuda_runtime.h>

namespace gs {

constexpr int kTilePx = 16;
constexpr int kPixelsPerTile = kTilePx * kTilePx;  // one thread per pixel
constexpr float kHalfTile = 7.5f;                  // (kTilePx - 1) / 2
constexpr float kAlphaSkip = 0.00392156862f;
constexpr float kTEps = 1e-4f;
constexpr float kAlphaClamp = 0.9999f;  // the backward's alpha cap

// Feature rows of the per-gaussian matrices (row r of gaussian g at
// feat[r * n + g]); the depth rows end with the camera distance at row 6.
constexpr int kFeatU = 0, kFeatV = 1, kFeatOpacity = 2;
constexpr int kFeatA = 3, kFeatB = 4, kFeatC = 5;
constexpr int kFeatR = 6, kFeatG = 7, kFeatBCol = 8;
constexpr int kFeatDepth = 6;
// The per-pixel SH matrix keeps rows u..c and then 3 * n_sh coefficients,
// row kShCoeff0 + c * n_sh + k for channel c and basis function k.  The DC
// coefficient is not scaled by SH_0: basis row 0 carries it.
constexpr int kShCoeff0 = 6;
constexpr int kWarpSize = 32;
constexpr int kWarps = kPixelsPerTile / kWarpSize;
constexpr unsigned kFullMask = 0xffffffffu;

// One splat's geometry relative to the tile centre, staged in shared memory.
struct SplatGeom {
  float ul, vl;  // centre minus (tile origin + 7.5)
  float op, a, b, c, rdet;
};

// Tile-local geometry of gaussian g for tile origin (ox, oy): the same
// operations in the same order as ops/render.py::_splat_chunk.
__device__ __forceinline__ SplatGeom load_geom(const float* __restrict__ feat,
                                               int n, int g, float ox,
                                               float oy) {
  SplatGeom s;
  s.ul = (feat[kFeatU * n + g] - ox) - kHalfTile;
  s.vl = (feat[kFeatV * n + g] - oy) - kHalfTile;
  s.op = feat[kFeatOpacity * n + g];
  s.a = feat[kFeatA * n + g];
  s.b = feat[kFeatB * n + g];
  s.c = feat[kFeatC * n + g];
  const float det = s.a * s.c - s.b * s.b;
  s.rdet = 1.0f / det;
  return s;
}

// Terms of splat s at tile-local pixel (up, vp): the offsets du, dv from its
// centre, the Mahalanobis term mh and the raw alpha op * exp(-mh / 2), zero
// unless mh is positive.
struct SplatPixel {
  float du, dv, mh, alpha;
};

__device__ __forceinline__ SplatPixel splat_pixel(const SplatGeom& s, float up,
                                                  float vp) {
  SplatPixel t;
  t.du = up - s.ul;
  t.dv = vp - s.vl;
  t.mh = (s.c * t.du * t.du - 2.0f * s.b * t.du * t.dv + s.a * t.dv * t.dv) *
         s.rdet;
  const float prob = t.mh > 0.0f ? expf(-0.5f * t.mh) : 0.0f;
  t.alpha = s.op * prob;
  return t;
}

// The backward kernels B2 and B4 (render_bwd.cu, render_sh_bwd.cu) work in
// rounds of kRound splats.  In phase A every pixel walks the round front to
// back and stages, per splat, (q, w): q = alpha * dL/dalpha and the weight
// w = alpha * T, zero where the splat does not composite.  Each warp stages
// in a buffer of its own, (kRound, 32) pairs for its 32 pixels, with pixel i
// of splat jj at stage_slot(jj, i) = jj * 32 + (i ^ jj): the pixels' writes
// of one splat and the lanes' reads of one pixel across the round's splats
// (half a warp of 64-bit accesses at a time) are both free of bank
// conflicts.  In phase B lane jj takes splat jj and sums over the warp's
// pixels that composited anything in the round, from the ballot of phase A;
// then the warp writes its sums over the buffer it has read, and the block
// adds up the eight warps' sums (add_round_rows).
constexpr int kRound = 32;
constexpr int kStageFloats = 2 * kRound * kWarpSize;  // one warp's buffer

__device__ __forceinline__ int stage_slot(int jj, int i) {
  return jj * kWarpSize + (i ^ jj);
}

// The lowest pixel of the set m, taken out of m; -1 once m is empty.
__device__ __forceinline__ int take_pixel(unsigned& m) {
  const int i = __ffs(m) - 1;
  m &= m - 1;
  return i;
}

// A splat's geometry in shared memory as two 16-byte words, so that a read
// is two 128-bit loads (a SplatGeom array is read one float at a time).
__device__ __forceinline__ void store_geom(float4* at, const SplatGeom& s) {
  at[0] = make_float4(s.ul, s.vl, s.op, s.a);
  at[1] = make_float4(s.b, s.c, s.rdet, 0.0f);
}

__device__ __forceinline__ SplatGeom read_geom(const float4* at) {
  const float4 x = at[0], y = at[1];
  return {x.x, x.y, x.z, x.w, y.x, y.y, y.z};
}

// Per-splat sums of phase B behind the six geometry rows: with du, dv and mh
// recomputed from the splat's staged geometry with splat_pixel's own
// operations, sum_p q, q du, q dv, q du^2, q dv^2, q du dv and q mh over the
// pixels.  The rows are then q-weighted moments about the splat's own centre
// (where du and dv are the pixel's own offsets, as small as the splat's
// reach), never about the tile centre.  mh has to be rounded as in the walk:
// the conic rows difference dv^2 and c mh, which cancel for a thin splat,
// and a rounding of mh's own (fused multiply-adds, rdet applied per splat)
// moved them by up to 9.6e-5 of a row's max on the garden view.
constexpr int kGeomSums = 7;

// acc points at kGeomSums running sums.
__device__ __forceinline__ void add_geom_sums(float* acc, const SplatGeom& s,
                                              float q, float up, float vp) {
  const float du = up - s.ul;
  const float dv = vp - s.vl;
  const float mh = (s.c * du * du - 2.0f * s.b * du * dv + s.a * dv * dv) * s.rdet;
  const float x = q * du;
  const float y = q * dv;
  acc[0] += q;
  acc[1] += x;
  acc[2] += y;
  acc[3] = fmaf(x, du, acc[3]);
  acc[4] = fmaf(y, dv, acc[4]);
  acc[5] = fmaf(x, dv, acc[5]);
  acc[6] = fmaf(q, mh, acc[6]);
}

// Geometry gradient row k (u, v, opacity, a, b, c) of splat s from its sums
// sum(i) = sum_p of add_geom_sums' term i: the per-pixel terms of
// ops/render.py::bwd_walk (rq = q * rdet) summed over pixels, e.g. row u =
// sum_p rq * (c du - b dv) = rdet * (c * sum q du - b * sum q dv).
template <typename Sum>
__device__ __forceinline__ float geom_row(int k, const SplatGeom& s, Sum sum) {
  switch (k) {
    case 0:
      return s.rdet * (s.c * sum(1) - s.b * sum(2));
    case 1:
      return s.rdet * (s.a * sum(2) - s.b * sum(1));
    case 2:
      return sum(0) / fmaxf(s.op, 1e-30f);
    case 3:
      return (-0.5f * s.rdet) * (sum(4) - s.c * sum(6));
    case 4:
      return s.rdet * (sum(5) - s.b * sum(6));
    default:
      return (-0.5f * s.rdet) * (sum(3) - s.a * sum(6));
  }
}

// The block's last step of a round: adds each (splat, row) sum of the eight
// warps into grad_feat with one atomicAdd, skipping zeros.  sums + w *
// kStageFloats holds warp w's sums, sum k of splat jj at k * kRound + jj:
// the kGeomSums of add_geom_sums, then one per colour row (NCOL rows from
// feature row kShCoeff0 = kFeatR on).
template <int NCOL>
__device__ __forceinline__ void add_round_rows(const float* sums,
                                               const float4* s_geom,
                                               const int* s_gid, int r0,
                                               int count, int n,
                                               float* __restrict__ grad_feat) {
  for (int x = threadIdx.x; x < (kShCoeff0 + NCOL) * kRound;
       x += kPixelsPerTile) {
    const int jj = x % kRound;
    const int row = x / kRound;
    const int j = r0 + jj;
    if (j >= count) continue;
    auto sum = [&](int k) {
      float t = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += sums[w * kStageFloats + k * kRound + jj];
      return t;
    };
    const float v = row < kShCoeff0 ? geom_row(row, read_geom(s_geom + 2 * j), sum)
                                    : sum(kGeomSums + row - kShCoeff0);
    // adding zero changes nothing; NaN still goes through
    if (v != 0.0f) atomicAdd(&grad_feat[row * n + s_gid[j]], v);
  }
}

// Raw alpha of splat s at tile-local pixel (up, vp).
__device__ __forceinline__ float splat_alpha(const SplatGeom& s, float up,
                                             float vp) {
  return splat_pixel(s, up, vp).alpha;
}

// The forward kernels B1, B3 and B5 (render_fwd.cu, render_sh_fwd.cu,
// depth_fwd.cu) read a gaussian-major copy of the feature matrix that
// gs_pack_fwd_rows writes per call: gaussian g's record holds floats
// rec[g * stride + i], i = 0..5 the rows u, v, op, a, b, c, i = kRecRdet its
// rdet = 1 / (a c - b^2) (load_geom's operations), then the remaining rows
// (B1's colour, B3's 3 * n_sh coefficients, B5's distance), zero-padded to
// stride = a multiple of 4.  A
// splat's gather is then stride / 4 16-byte loads (7 sectors of 32 bytes
// for B3 at n_sh 16 where the row-major matrix took 54 one-float reads),
// and rdet is worked out once per gaussian, not once per splat and tile.
constexpr int kRecRdet = 6;
constexpr int kRecRow6 = kRecRdet + 1;  // feature row 6 on, shifted by one

__host__ __device__ constexpr int packed_stride(int rows) {
  return (rows + 1 + 3) / 4 * 4;
}

// 16-byte copies from device to shared memory that bypass the registers
// (cp.async, sm_80 on), so that a batch's gather runs behind the walk.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// B1, B3 and B5 take their tiles heaviest first: block i walks tile
// tile_order[i], an order of the tiles by splat count, largest first
// (gs_tile_order in render_fwd.cu), so that the longest lists start in the
// first wave of blocks instead of ending the launch.  Counts of kOrderBuckets
// - 1 splats or more share the first bucket; within a bucket the order is
// any.
constexpr int kOrderBuckets = 1024;

// B1 and B3 take a 16x16 tile with 128 threads, each owning two vertically
// adjacent pixels (column t % 16, rows 2 (t / 16) and 2 (t / 16) + 1), so
// that one read of a staged splat serves two pixels whose walks end close
// together, and each thread carries two independent T chains.
constexpr int kFwdThreads = kPixelsPerTile / 2;

// A pixel of the forward walk: its transmittance and premultiplied colour.
// Once T < kTEps it takes no more splats, so "stopped" is T < kTEps.
struct FwdPixel {
  float T = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f;
  __device__ __forceinline__ bool live() const { return T >= kTEps; }
  // composite a splat of raw alpha (>= kAlphaSkip) and colour (cr, cg, cb)
  __device__ __forceinline__ void add(float alpha, float cr, float cg,
                                      float cb) {
    const float w = alpha * T;
    r += cr * w;
    g += cg * w;
    b += cb * w;
    T *= 1.0f - alpha;
  }
};

// Pixel o's premultiplied r, g, b and T into the (4, n_pix) output.
__device__ __forceinline__ void store_fwd_pixel(float* __restrict__ out,
                                                int n_pix, int o,
                                                const FwdPixel& px) {
  out[0 * n_pix + o] = px.r;
  out[1 * n_pix + o] = px.g;
  out[2 * n_pix + o] = px.b;
  out[3 * n_pix + o] = px.T;
}

// A staged splat's geometry: the first two words of its record, word 0's u
// and v made tile-local when staged; word 1's last float is the record's
// float 7 (B1's red, B3's coefficient 0, B5's distance).
__device__ __forceinline__ SplatGeom staged_geom(const float4* at) {
  const float4 x = at[0], y = at[1];
  return {x.x, x.y, x.z, x.w, y.x, y.y, y.z};
}

// The batches of a tile's splat list [lo, hi), kBatch splats at a time, in
// two stage buffers of kBatch records of W 16-byte words each (s_rec holds
// 2 * kBatch * W words), each record contiguous.  While batch k is walked,
// batch k + 1 is gathered into the other buffer: words 1.. by cp.async,
// word 0 through registers, stored tile-local (u - ox - 7.5, load_geom's
// operations) once it has landed.  walk(buffer, count) walks one batch and
// returns whether any of the thread's pixels is still live; the block
// leaves once none is.  The block has kThreads threads: B1 and B3's 128 of
// two pixels, B5's 256 of one.  (With the tiles heaviest first, one buffer
// filled after the walk took B1 18% longer on the H100: PERF.md.)
template <int W, int kBatch, int kThreads = kFwdThreads, typename Walk>
__device__ __forceinline__ void fwd_batches(float4* s_rec,
                                            const float4* __restrict__ rec,
                                            const int* __restrict__ gaussian_idx,
                                            int lo, int hi, float ox, float oy,
                                            Walk walk) {
  constexpr int kHeads = (kBatch + kThreads - 1) / kThreads;
  const int t = threadIdx.x;
  float4 head[kHeads];  // word 0 of splats t, t + 128, ... of the next batch
  auto start = [&](float4* buf, int base) {
    const int count = min(kBatch, hi - base);
#pragma unroll
    for (int i = 0; i < kHeads; ++i) {
      const int j = t + i * kThreads;
      if (j < count) head[i] = rec[size_t(gaussian_idx[base + j]) * W];
    }
    for (int x = t; x < count * (W - 1); x += kThreads) {
      const int j = x / (W - 1);
      const int w = 1 + x - j * (W - 1);
      cp_async16(buf + j * W + w, rec + size_t(gaussian_idx[base + j]) * W + w);
    }
    cp_async_commit();
  };
  if (lo < hi) start(s_rec, lo);
  int stage = 0;
  for (int base = lo; base < hi; base += kBatch, stage ^= 1) {
    float4* cur = s_rec + stage * kBatch * W;
    const int count = min(kBatch, hi - base);
#pragma unroll
    for (int i = 0; i < kHeads; ++i) {
      const int j = t + i * kThreads;
      if (j < count) {
        float4 x = head[i];
        x.x = (x.x - ox) - kHalfTile;
        x.y = (x.y - oy) - kHalfTile;
        cur[j * W] = x;
      }
    }
    cp_async_wait_all();
    // the batch is staged; the other buffer was last read before the
    // previous batch's closing barrier
    __syncthreads();
    if (base + kBatch < hi) start(s_rec + (stage ^ 1) * kBatch * W, base + kBatch);
    // also keeps this buffer alive until every pixel has finished with it
    if (__syncthreads_count(walk(cur, count)) == 0) break;
  }
  cp_async_wait_all();  // no copy outlives the block
}

// The colour of a staged splat at the thread's two pixels, channel by
// channel: sum_k coeff[c * NSH + k] * basis[k] in order of k, in fused
// multiply-adds (as render_sh_bwd.cu's sh_colour_packed).  sj is the
// splat's staged record: coefficient r is its float kRecRow6 + r, so
// coefficient 0 is word 1's last float and the rest are 16-byte broadcast
// loads from word 2 on.
template <int NSH>
__device__ __forceinline__ void sh_colour_pair(const float4* sj,
                                               const float (&b0)[NSH],
                                               const float (&b1)[NSH],
                                               float (&col0)[3],
                                               float (&col1)[3]) {
  constexpr int kCoeff = 3 * NSH;
  constexpr int kWords = packed_stride(kShCoeff0 + kCoeff) / 4;
  const float c0 = sj[1].w;
  col0[0] = c0 * b0[0];
  col1[0] = c0 * b1[0];
#pragma unroll
  for (int w = 2; w < kWords; ++w) {
    const float4 v = sj[w];
    const float cv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 4 * w + e - kRecRow6;
      if (r < kCoeff) {
        const int ch = r / NSH, k = r % NSH;
        col0[ch] = k == 0 ? cv[e] * b0[0] : fmaf(cv[e], b0[k], col0[ch]);
        col1[ch] = k == 0 ? cv[e] * b1[0] : fmaf(cv[e], b1[k], col1[ch]);
      }
    }
  }
}

}  // namespace gs
