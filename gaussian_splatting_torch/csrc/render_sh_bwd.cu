// B4: per-pixel spherical-harmonics backward rasterizer, the VJP of B3's
// raw output.
//
// Replaces the Pallas kernel gaussian_splatting_tpu/ops/render_sh.py::_bwd_kernel
// (launched by _render_bwd) and the permutation-inversion sort that reduces
// its per-splat rows onto gaussians.  The plain PyTorch version is
// gaussian_splatting_torch/ops/render_sh.py::render_sh_bwd_plain.
//
// Semantics (the JAX backward's, as B2's in render_bwd.cu): per pixel, E =
// sum_c raw_c * g_c + g_T * T; the splats are walked front to back again
// with alpha clamped at kAlphaClamp (in T, in the T_EPS stop, in the weights
// and in 1 / (1 - alpha)), carrying T and the inclusive prefix pg = sum A *
// w, where A = sum_c g_c * colour_c and colour_c = sum_k coeff[c * n_sh + k]
// * basis_k is the splat's colour at the pixel.  q = at * (A * T - (E - pg)
// / (1 - at)) gives the six geometry rows as in B2; the 3 * n_sh coefficient
// rows are (g_c * basis_k) * w.  The basis gets no gradient, so in this path
// a gaussian's centre gets its gradient only through u, v and the conic.
//
// What bounded the first version on the H100 (NVIDIA H100 80GB HBM3,
// 700 W, garden view 0 at 1296x840, n_sh = 16, bwd_bench.py): each warp
// summed its pixels' 54 rows per splat by a reduce-scatter of 62 shuffles,
// after contracting the colour from 48 coefficients read one float at a
// time; shuffles and shared-memory accesses issue through one pipe of the
// SM.  Compiled without the reduce-scatter it took 1.538 ms instead of
// 3.165 ms, without its atomics 3.112 ms.
//
// Design: B2's two phases (render_bwd.cu, common.cuh), a template on n_sh
// (4, 9, 16).  One block per tile, one thread per pixel, whose basis stays
// in registers for phase A.  The block gathers kBatch splats at a time:
// their geometry, and their 3 * n_sh coefficients contiguous per splat
// (padded to a multiple of 4), so that phase A contracts a splat's colour
// from 16-byte broadcast loads, in fused multiply-adds.  Phase B reads each
// pixel's cotangent and basis from shared memory and sums the coefficient
// rows as sum_p (w * g_c) * basis_k: 3 * n_sh fused multiply-adds per lane
// and pixel against 2 + n_sh / 4 loads.  Everything lives in dynamic shared
// memory (the launcher raises the limit with cudaFuncSetAttribute).
//
// What bounds it now: registers.  Phase B's 7 + 3 * n_sh sums and phase A's
// basis take 127 of the 128 registers that two blocks (16 warps) per SM
// allow, and the walk is latency-bound at that occupancy; phase B issues
// ~100 instructions per warp and pixel-round with a hit (5.61M of them), 48
// of them the coefficient rows' fused multiply-adds, near the SM's issue
// rate.  Compiled without phase B the first two-phase version took 1.549 of
// its 2.302 ms, without the rows' atomics 2.124.  Rounds of 16 splats took
// 2.282 ms against 2.394 at 32 before phase B took two pixels a step.
#include "common.cuh"

namespace gs {
namespace {

constexpr int kBatch = 64;  // splats gathered at a time (a multiple of kRound)

constexpr int round4(int x) { return (x + 3) / 4 * 4; }

template <int NSH>
struct ShBwd {
  static constexpr int kCoeff = 3 * NSH;
  static constexpr int kCoeffPad = round4(kCoeff);  // a splat's stride
  static constexpr int kBasisPad = round4(NSH);     // a pixel's stride
  static constexpr int kSums = kGeomSums + kCoeff;
  static_assert(kSums * kRound <= kStageFloats, "the sums fit a warp's buffer");
  // dynamic shared memory, in bytes: the warps' staging buffers, per pixel
  // its colour cotangent and basis, per batch splat its coefficients,
  // geometry (two float4) and gaussian id
  static constexpr int kOffG = kWarps * kStageFloats * int(sizeof(float));
  static constexpr int kOffBasis = kOffG + kPixelsPerTile * int(sizeof(float4));
  static constexpr int kOffCoeff =
      kOffBasis + kPixelsPerTile * kBasisPad * int(sizeof(float));
  static constexpr int kOffGeom = kOffCoeff + kBatch * kCoeffPad * int(sizeof(float));
  static constexpr int kOffGid = kOffGeom + 2 * kBatch * int(sizeof(float4));
  static constexpr int kSmemBytes = kOffGid + kBatch * int(sizeof(int));
};

// The colour of a splat at a pixel, channel by channel: sum_k coeff[c * NSH
// + k] * basis[k] in order of k, as ops/render_sh.py::_sh_colour sums it,
// here in fused multiply-adds (it only feeds A); coeff is the splat's
// contiguous, 16-byte aligned row.
template <int NSH>
__device__ __forceinline__ void sh_colour_packed(const float* coeff,
                                                 const float (&basis)[NSH],
                                                 float (&col)[3]) {
#pragma unroll
  for (int r4 = 0; r4 < 3 * NSH; r4 += 4) {
    const float4 c4 = *reinterpret_cast<const float4*>(coeff + r4);
    const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r4 + e;
      if (r < 3 * NSH) {
        const int ch = r / NSH, k = r % NSH;
        col[ch] = k == 0 ? cv[e] * basis[k] : fmaf(cv[e], basis[k], col[ch]);
      }
    }
  }
}

// two blocks per SM: at most 128 registers a thread
template <int NSH>
__global__ void __launch_bounds__(kPixelsPerTile, 2)
    render_sh_bwd_kernel(const float* __restrict__ feat, int n,
                         const float* __restrict__ basis,
                         const int* __restrict__ gaussian_idx,
                         const int* __restrict__ tile_starts, int x_tiles,
                         int n_pix, const float* __restrict__ raw,
                         const float* __restrict__ grad_raw,
                         float* __restrict__ grad_feat) {
  using L = ShBwd<NSH>;
  extern __shared__ float4 s_mem[];
  char* smem = reinterpret_cast<char*>(s_mem);
  float* s_stage = reinterpret_cast<float*>(smem);
  float4* s_g = reinterpret_cast<float4*>(smem + L::kOffG);
  // s_basis[p * kBasisPad + k]: basis k at pixel p
  float* s_basis = reinterpret_cast<float*>(smem + L::kOffBasis);
  // s_coeff[j * kCoeffPad + r]: coefficient row r of batch splat j
  float* s_coeff = reinterpret_cast<float*>(smem + L::kOffCoeff);
  float4* s_geom = reinterpret_cast<float4*>(smem + L::kOffGeom);
  int* s_gid = reinterpret_cast<int*>(smem + L::kOffGid);

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
  float b[NSH];
#pragma unroll
  for (int k = 0; k < NSH; ++k) {
    b[k] = basis[k * n_pix + o];
    s_basis[p * L::kBasisPad + k] = b[k];
  }
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
    }
    for (int x = p; x < count * L::kCoeff; x += kPixelsPerTile) {
      const int j = x / L::kCoeff;
      const int r = x - j * L::kCoeff;
      s_coeff[j * L::kCoeffPad + r] = feat[(kShCoeff0 + r) * n + gaussian_idx[base + j]];
    }
    __syncthreads();
    for (int r0 = 0; r0 < count; r0 += kRound) {
      // A: the walk; q and w are zero unless the splat composites here
      bool hit_any = false;
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
              float col[3];
              sh_colour_packed<NSH>(s_coeff + j * L::kCoeffPad, b, col);
              const float A = g_r * col[0] + g_g * col[1] + g_b * col[2];
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
      float acc[L::kSums];
#pragma unroll
      for (int k = 0; k < L::kSums; ++k) acc[k] = 0.0f;
      auto add_pixel = [&](int i, float2 qw, float4 gp) {
        const float4* bp = reinterpret_cast<const float4*>(
            s_basis + (warp * kWarpSize + i) * L::kBasisPad);
        float4 b4[L::kBasisPad / 4];
#pragma unroll
        for (int k4 = 0; k4 < L::kBasisPad / 4; ++k4) b4[k4] = bp[k4];
        if (qw.x != 0.0f) {
          add_geom_sums(acc, s, qw.x, gp.w, i < kTilePx ? vp_row0 : vp_row1);
        }
        const float wg[3] = {qw.y * gp.x, qw.y * gp.y, qw.y * gp.z};
#pragma unroll
        for (int k = 0; k < NSH; ++k) {
          const float4 v = b4[k / 4];
          const float bk = k % 4 == 0 ? v.x : k % 4 == 1 ? v.y : k % 4 == 2 ? v.z : v.w;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            float& a = acc[kGeomSums + ch * NSH + k];
            a = fmaf(wg[ch], bk, a);
          }
        }
      };
      // two pixels at a time, both pixels' pairs and cotangents loaded first
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
      for (int k = 0; k < L::kSums; ++k) part[k * kRound + jj] = acc[k];
      __syncthreads();
      add_round_rows<L::kCoeff>(s_stage, s_geom, s_gid, r0, count, n, grad_feat);
      // the sums are read before the next round stages over them
      if (__syncthreads_count(!(done || T < kTEps)) == 0) break;
    }
    done = done || T < kTEps;
  }
}

template <int NSH>
cudaError_t launch(const float* feat, int n, const float* basis,
                   const int* gaussian_idx, const int* tile_starts,
                   int n_tiles, int x_tiles, const float* raw,
                   const float* grad_raw, float* grad_feat,
                   cudaStream_t stream) {
  constexpr int smem = ShBwd<NSH>::kSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      render_sh_bwd_kernel<NSH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  render_sh_bwd_kernel<NSH><<<n_tiles, kPixelsPerTile, smem, stream>>>(
      feat, n, basis, gaussian_idx, tile_starts, x_tiles,
      n_tiles * kPixelsPerTile, raw, grad_raw, grad_feat);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gs

// feat, basis, gaussian_idx, tile_starts, n_sh as for gs_render_sh_fwd; raw:
// (4, n_tiles * 256) float32, gs_render_sh_fwd's output; grad_raw: its
// cotangent, same shape; grad_feat: (6 + 3 * n_sh, n) float32, zero-filled
// by the caller, receives the gradient of every feature row.  n_sh other
// than 4, 9 or 16 returns cudaErrorInvalidValue and launches nothing.
extern "C" int gs_render_sh_bwd(const float* feat, int n, const float* basis,
                                int n_sh, const int* gaussian_idx,
                                const int* tile_starts, int n_tiles,
                                int x_tiles, const float* raw,
                                const float* grad_raw, float* grad_feat,
                                cudaStream_t stream) {
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  switch (n_sh) {
    case 4:
      return static_cast<int>(gs::launch<4>(feat, n, basis, gaussian_idx,
                                            tile_starts, n_tiles, x_tiles, raw,
                                            grad_raw, grad_feat, stream));
    case 9:
      return static_cast<int>(gs::launch<9>(feat, n, basis, gaussian_idx,
                                            tile_starts, n_tiles, x_tiles, raw,
                                            grad_raw, grad_feat, stream));
    case 16:
      return static_cast<int>(gs::launch<16>(feat, n, basis, gaussian_idx,
                                             tile_starts, n_tiles, x_tiles,
                                             raw, grad_raw, grad_feat, stream));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
