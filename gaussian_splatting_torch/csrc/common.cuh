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
