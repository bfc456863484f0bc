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

}  // namespace gs
