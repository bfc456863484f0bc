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

// One channel of a splat's colour at a pixel: sum_k coeff[k] * basis[k],
// summed in order of k (ops/render_sh.py::_sh_colour).  coeff points at the
// splat's coefficient k = 0 in shared memory, one row of kPixelsPerTile
// splats per k; basis is the pixel's own basis in registers.
template <int NSH>
__device__ __forceinline__ float sh_colour(const float* coeff,
                                           const float (&basis)[NSH]) {
  float col = coeff[0] * basis[0];
#pragma unroll
  for (int k = 1; k < NSH; ++k) col += coeff[k * kPixelsPerTile] * basis[k];
  return col;
}

}  // namespace gs
