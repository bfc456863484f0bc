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
// at * (A * T - D / (1 - at)); the nine gradient rows are the direct
// per-pixel derivatives of alpha = op * exp(-mh / 2) (docs/MATH.md) and
// g_ch * w, summed over the tile's pixels.
//
// What bounded the first version on the H100 (NVIDIA H100 80GB HBM3,
// 700 W, garden view 0 at 1296x840, bwd_bench.py): it summed each pixel's
// nine terms over the warp with 45 shuffles per warp and splat, 3.31M warp
// steps with a hit.  Shuffles and shared-memory accesses issue through one
// pipe of the SM.  Compiled without the shuffles it took 0.880 ms instead of
// 1.348 ms, without its atomics 1.337 ms.
//
// Design: two phases per round of kRound = 32 splats (common.cuh).  One
// block per 16x16 tile, one thread per pixel; the block gathers kBatch
// splats at a time through gaussian_idx into shared memory (geometry as two
// float4, colour as one).
//   A. Each pixel walks the round front to back, carrying T and pg, and
//      stages (q, w) for each splat: one conflict-free 64-bit store per
//      splat-pixel pair, no reduction.
//   B. Lane jj takes splat jj and sums over the warp's pixels that
//      composited anything in the round (a ballot skips the others; two
//      pixels a step): the colour rows sum_p w g_ch, and the geometry rows
//      as sums of q times du, dv and mh recomputed from the splat's staged
//      geometry with splat_pixel's operations.  The eight warps' sums meet
//      in the staging buffers, and one atomicAdd per (splat, tile, row)
//      adds the row into grad_feat, as before.
// The block leaves once every pixel has stopped (__syncthreads_count).
//
// What bounds it now: phase A is B1's walk with the q terms, latency-bound
// at 3 blocks (24 warps) per SM, which the 64 KB of staging buffers allow;
// phase B issues ~35 instructions per warp and pixel-round with a hit
// (5.61M of them), near the SM's issue rate.  Compiled without phase B the
// first two-phase version took 0.717 of its 1.034 ms, without the rows'
// atomics 0.998.  A gather of 256 splats (2 blocks per SM) took 1.133 ms
// against 0.982 at 128, rounds of 16 splats 1.006 against 0.984.
#include "common.cuh"

namespace gs {
namespace {

constexpr int kBatch = 128;  // splats gathered at a time (a multiple of kRound)
constexpr int kColourRows = 3;
constexpr int kSums = kGeomSums + kColourRows;  // and sum_p w * g_ch

// Dynamic shared memory, in bytes: the warps' staging buffers, then per
// pixel its colour cotangent, then per batch splat its geometry (two
// float4), colour (one) and gaussian id.
constexpr int kOffG = kWarps * kStageFloats * int(sizeof(float));
constexpr int kOffGeom = kOffG + kPixelsPerTile * int(sizeof(float4));
constexpr int kOffCol = kOffGeom + 2 * kBatch * int(sizeof(float4));
constexpr int kOffGid = kOffCol + kBatch * int(sizeof(float4));
constexpr int kSmemBytes = kOffGid + kBatch * int(sizeof(int));

__global__ void __launch_bounds__(kPixelsPerTile)
    render_bwd_kernel(const float* __restrict__ feat, int n,
                      const int* __restrict__ gaussian_idx,
                      const int* __restrict__ tile_starts, int x_tiles,
                      int n_pix, const float* __restrict__ raw,
                      const float* __restrict__ grad_raw,
                      float* __restrict__ grad_feat) {
  extern __shared__ float4 s_mem[];
  char* smem = reinterpret_cast<char*>(s_mem);
  float* s_stage = reinterpret_cast<float*>(smem);
  float4* s_g = reinterpret_cast<float4*>(smem + kOffG);
  float4* s_geom = reinterpret_cast<float4*>(smem + kOffGeom);
  float4* s_col = reinterpret_cast<float4*>(smem + kOffCol);
  int* s_gid = reinterpret_cast<int*>(smem + kOffGid);

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
  // this warp's buffer: (q, w) pairs in phase A, its sums after phase B
  float2* stage = reinterpret_cast<float2*>(s_stage + warp * kStageFloats);
  float* part = s_stage + warp * kStageFloats;
  // phase B: pixel i of the warp lies in tile row 2 warp + i / 16
  const float vp_row0 = float(2 * warp) - kHalfTile;
  const float vp_row1 = float(2 * warp + 1) - kHalfTile;

  const int o = tile * kPixelsPerTile + p;
  const float g_r = grad_raw[0 * n_pix + o];
  const float g_g = grad_raw[1 * n_pix + o];
  const float g_b = grad_raw[2 * n_pix + o];
  const float g_t = grad_raw[3 * n_pix + o];
  const float e = raw[0 * n_pix + o] * g_r + raw[1 * n_pix + o] * g_g +
                  raw[2 * n_pix + o] * g_b + g_t * raw[3 * n_pix + o];
  // s_g[p]: pixel p's colour cotangent and its column up
  s_g[p] = make_float4(g_r, g_g, g_b, up);

  float T = 1.0f;
  float pg = 0.0f;
  bool done = false;
  for (int base = lo; base < hi; base += kBatch) {
    // also the barrier that keeps the previous batch alive until every
    // pixel has finished with it
    if (__syncthreads_count(!done) == 0) break;
    const int count = min(kBatch, hi - base);
    if (p < count) {
      const int g = gaussian_idx[base + p];
      s_gid[p] = g;
      store_geom(s_geom + 2 * p, load_geom(feat, n, g, ox, oy));
      s_col[p] = make_float4(feat[kFeatR * n + g], feat[kFeatG * n + g],
                             feat[kFeatBCol * n + g], 0.0f);
    }
    __syncthreads();
    for (int r0 = 0; r0 < count; r0 += kRound) {
      // A: the walk; q and w are zero unless the splat composites here
      bool hit_any = false;
#pragma unroll 4
      for (int jj = 0; jj < kRound; ++jj) {
        const int j = r0 + jj;
        float q = 0.0f, w = 0.0f;
        if (j < count && !done) {
          if (T < kTEps) {
            done = true;
          } else {
            const SplatPixel t = splat_pixel(read_geom(s_geom + 2 * j), up, vp);
            if (t.alpha >= kAlphaSkip) {
              hit_any = true;
              const float at = fminf(t.alpha, kAlphaClamp);
              w = at * T;
              const float4 col = s_col[j];
              const float A = g_r * col.x + g_g * col.y + g_b * col.z;
              pg += A * w;
              const float d = e - pg;
              const float roma = 1.0f / (1.0f - at);
              q = at * (A * T - d * roma);
              T *= 1.0f - at;
            }
          }
        }
        stage[stage_slot(jj, lane)] = make_float2(q, w);
      }
      // B: lane jj sums splat r0 + jj over the warp's pixels that
      // composited anything; past the batch's end it reads zeros
      const unsigned mask = __ballot_sync(kFullMask, hit_any);
      __syncwarp();
      const int jj = lane;
      const SplatGeom s = read_geom(s_geom + 2 * (r0 + jj));
      float acc[kSums];
#pragma unroll
      for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
      auto add_pixel = [&](int i, float2 qw, float4 gp) {
        if (qw.x != 0.0f) {
          add_geom_sums(acc, s, qw.x, gp.w, i < kTilePx ? vp_row0 : vp_row1);
        }
        acc[kGeomSums + 0] = fmaf(qw.y, gp.x, acc[kGeomSums + 0]);
        acc[kGeomSums + 1] = fmaf(qw.y, gp.y, acc[kGeomSums + 1]);
        acc[kGeomSums + 2] = fmaf(qw.y, gp.z, acc[kGeomSums + 2]);
      };
      // two pixels at a time, both pixels' loads issued first
      for (unsigned m = mask; m != 0;) {
        const int i0 = take_pixel(m);
        const int i1 = take_pixel(m);
        const float2 qw0 = stage[stage_slot(jj, i0)];
        const float4 gp0 = s_g[warp * kWarpSize + i0];
        float2 qw1 = make_float2(0.0f, 0.0f);
        float4 gp1 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (i1 >= 0) {
          qw1 = stage[stage_slot(jj, i1)];
          gp1 = s_g[warp * kWarpSize + i1];
        }
        add_pixel(i0, qw0, gp0);
        if (i1 >= 0) add_pixel(i1, qw1, gp1);
      }
      // every lane has read its pairs: the sums go over the buffer
      __syncwarp();
#pragma unroll
      for (int k = 0; k < kSums; ++k) part[k * kRound + jj] = acc[k];
      __syncthreads();
      add_round_rows<kColourRows>(s_stage, s_geom, s_gid, r0, count, n, grad_feat);
      // the sums are read before the next round stages over them
      if (__syncthreads_count(!(done || T < kTEps)) == 0) break;
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
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  const cudaError_t err = cudaFuncSetAttribute(
      gs::render_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      gs::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  gs::render_bwd_kernel<<<n_tiles, gs::kPixelsPerTile, gs::kSmemBytes,
                          stream>>>(feat, n, gaussian_idx, tile_starts,
                                    x_tiles, n_tiles * gs::kPixelsPerTile, raw,
                                    grad_raw, grad_feat);
  return static_cast<int>(cudaGetLastError());
}
