// Per-gaussian geometry and features: one launch forward, one backward.
//
// Replaces no Pallas kernel: the JAX package leaves this chain to XLA
// (gaussian_splatting_tpu/geometry.py, rasterize.py), and the original CUDA
// reference ran it as per-stage kernels (CameraPointProjection ...
// PrecomputeRGBFromSH).  The plain PyTorch version is
// gaussian_splatting_torch/ops/geometry.py::splat_rows_plain: geometry.py's
// rows chain and the feature stack, differentiated by autograd, some 330
// elementwise launches forward and 575 backward at SH band 3.
//
// Forward, per gaussian, the chain's float32 operations in the chain's order
// (-fmad=false; IEEE division, sqrt and expf): the camera transform, the
// pinhole projection (|z| <= 1e-12 gives inv_z = 0), the guarded quaternion
// normalisation (a squared norm <= 1e-24 gives the identity), R S S^T R^T
// with S = exp(log-scale), the conic of J W Sigma W^T J^T, the opacity
// (sigmoid of the parameter, or the decoded rows' activated value) and the
// colour; then the frustum test & alive.  It writes the rasterizer's feature
// rows (rows, N): u, v, opacity, a + 1/4, b / 2, c + 1/4 and the colour rows
// of one of three epilogues, chosen by the wrapper from its inputs:
//   kModeDC    scene parameters, SH evaluated once per gaussian along its
//              view direction (n_sh 1, 4, 9, 16), colour x SH_0: 9 rows;
//   kModeSH    scene parameters, the raw coefficients c*n_sh + k for the
//              per-pixel SH kernels: 6 + 3 n_sh rows;
//   kModeRows  decoded rows (Scaffold-GS): activated opacity and direct
//              colour as they are, read through their row strides: 9 rows.
// and the camera-frame depth and the visibility the layout takes.
//
// Backward: the feature rows' gradient (B2's or B4's) back to every
// parameter, the forward recomputed from the inputs; the reverse of each
// forward operation, with the chain's guards and no others, so a guarded
// slot gets zero and a NaN or inf parameter still gives a non-finite
// gradient.  The inactive SH columns get exactly zero; the pose and K none.
// On the per-pixel path the coefficients' gradients are rows of B4's
// gradient as they stand, so the wrapper hands them on as views, as
// autograd did, and the kernel writes the geometry leaves only: a copy
// would hold 180 more bytes a slot beside B4's rows at the step's peak.
// The decoded rows' opacity and colour gradients are rows of B2's gradient
// likewise.  No backward reads rgb: the colour is linear in it.
//
// What bounds it on the H100: bytes.  At 2^21 slots and band 3 the forward
// reads 59 floats, the alive byte and 2 uv-offset floats and writes 9 rows,
// the depth and the visible byte (~278 B, 0.17 ms at 3.35 TB/s); the
// backward reads 56 floats (all but rgb) and 9 gradient rows and writes 59
// gradients (~496 B, 0.31 ms); per pixel it reads 11 floats and 6 rows and
// writes 11 (112 B), for decoded rows 10 floats and 5 rows in, 10 out
// (100 B).  Arithmetic is ~300 operations a gaussian: 0.01 ms.
//
// Design: one thread a gaussian, 128 a block.  Feature rows are (row, N),
// so each row's stores coalesce as they are.  The 180-byte sh records of a
// block's gaussians (and, backward, their gradients) go through shared
// memory in 16-byte coalesced words, so a warp never strides 180 bytes per
// lane in device memory; a quaternion is one float4 where its rows are 16
// bytes.  The pose and K are read from their device tensors, so nothing is
// read on the host.  Kernel names avoid the rasterizer kernels' names, which
// a trace reader matches by substring.
#include <cuda_runtime.h>

namespace gs {
namespace {

constexpr int kThreads = 128;
constexpr int kShRec = 45;  // floats of one gaussian's (3, 15) sh record
constexpr int kModeDC = 0;
constexpr int kModeSH = 1;
constexpr int kModeRows = 2;

// the float32 of the plain code's Python doubles
constexpr float kSH0 = static_cast<float>(0.28209479177387814);
constexpr float kRSH0 = static_cast<float>(3.544907701811032);
constexpr float kSH1_0 = static_cast<float>(-0.4886025119029199);
constexpr float kSH1_1 = static_cast<float>(0.4886025119029199);
constexpr float kSH1_2 = static_cast<float>(-0.4886025119029199);
constexpr float kSH2_0 = static_cast<float>(1.0925484305920792);
constexpr float kSH2_1 = static_cast<float>(-1.0925484305920792);
constexpr float kSH2_2 = static_cast<float>(0.31539156525252005);
constexpr float kSH2_3 = static_cast<float>(-1.0925484305920792);
constexpr float kSH2_4 = static_cast<float>(0.5462742152960396);
constexpr float kSH3_0 = static_cast<float>(-0.5900435899266435);
constexpr float kSH3_1 = static_cast<float>(2.890611442640554);
constexpr float kSH3_2 = static_cast<float>(-0.4570457994644658);
constexpr float kSH3_3 = static_cast<float>(0.263875515352797);
constexpr float kSH3_4 = static_cast<float>(-0.4570457994644658);
constexpr float kSH3_5 = static_cast<float>(1.445305721320277);
constexpr float kSH3_6 = static_cast<float>(-0.5900435899266435);

// The inputs, by pointer, with the row strides (in floats) of the per-gaussian
// rows; a row's own entries are contiguous.  sh is (N, 3, 15) contiguous;
// uv_offset (2, N), or null; alive (N,), or null.
struct Inputs {
  const float* xyz;
  const float* quat;
  const float* scale;
  const float* opacity;
  const float* rgb;
  const float* sh;
  const float* uv_offset;
  const bool* alive;
  const float* pose;
  const float* K;
  long long s_xyz, s_quat, s_scale, s_opacity, s_rgb;
  int n;
  int quat_vec;  // quaternion rows are 16-byte aligned float4s
  int sh_vec;    // sh is 16-byte aligned
};

struct Grads {
  float* xyz;      // (N, 3)
  float* quat;     // (N, 4)
  float* scale;    // (N, 3)
  float* opacity;  // (N,) or (N, 1)
  float* rgb;      // (N, 3)
  float* sh;       // (N, 3, 15), or null
};

// near, far, -pad, width + pad, height + pad as float32, as the plain code's
// comparisons round them
struct Cull {
  float near_z, far_z, lo, hi_u, hi_v;
};

struct Cam {
  float R[3][3];
  float t[3];
  float fx, fy, cx, cy;
};

__device__ __forceinline__ Cam load_cam(const float* pose, const float* K) {
  Cam c;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) c.R[i][j] = __ldg(pose + 4 * i + j);
    c.t[i] = __ldg(pose + 4 * i + 3);
  }
  c.fx = __ldg(K + 0);
  c.cx = __ldg(K + 2);
  c.fy = __ldg(K + 4);
  c.cy = __ldg(K + 5);
  return c;
}

// One gaussian's parameters as the kernels read them.
struct Params {
  float p[3];  // xyz
  float q[4];  // wxyz quaternion as stored
  float sc[3];  // log-scale
  float op;  // opacity parameter or activated value
};

// The opacity is left out where the caller reads none (the decoded rows'
// backward, whose opacity gradient is its feature row's).
__device__ __forceinline__ Params load_params(const Inputs& in, int i, bool opacity = true) {
  Params a;
  const float* x = in.xyz + i * in.s_xyz;
  const float* s = in.scale + i * in.s_scale;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a.p[k] = __ldg(x + k);
    a.sc[k] = __ldg(s + k);
  }
  if (in.quat_vec) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(in.quat) + i);
    a.q[0] = q.x;
    a.q[1] = q.y;
    a.q[2] = q.z;
    a.q[3] = q.w;
  } else {
    const float* q = in.quat + i * in.s_quat;
#pragma unroll
    for (int k = 0; k < 4; ++k) a.q[k] = __ldg(q + k);
  }
  a.op = opacity ? __ldg(in.opacity + i * in.s_opacity) : 0.0f;
  return a;
}

// Everything the forward forms on the way to the conic, kept for the
// backward's recomputation.
struct Geo {
  float xc, yc, zc, inv_z;
  bool okz;
  float qnorm, inv_norm;
  bool okq;
  float w, x, y, z;  // the normalised quaternion (the identity when guarded)
  float r[3][3];
  float s[3];
  float sig[6];  // xx, xy, xz, yy, yz, zz
  float j00, j02, j11, j12;
  float m[2][3];
  float t[2][3];
  float c0, c1, c2;
};

// geometry.py's transform_rows, project_rows' inv_z, sigma_world_rows and
// conic_rows, operation for operation.
__device__ __forceinline__ void geometry(const Cam& c, const Params& a, Geo& g) {
  g.xc = c.R[0][0] * a.p[0] + c.R[0][1] * a.p[1] + c.R[0][2] * a.p[2] + c.t[0];
  g.yc = c.R[1][0] * a.p[0] + c.R[1][1] * a.p[1] + c.R[1][2] * a.p[2] + c.t[1];
  g.zc = c.R[2][0] * a.p[0] + c.R[2][1] * a.p[1] + c.R[2][2] * a.p[2] + c.t[2];
  g.okz = fabsf(g.zc) > 1e-12f;
  g.inv_z = g.okz ? 1.0f / g.zc : 0.0f;

  const float sumsq = a.q[0] * a.q[0] + a.q[1] * a.q[1] + a.q[2] * a.q[2] + a.q[3] * a.q[3];
  g.okq = sumsq > 1e-24f;
  g.qnorm = sqrtf(g.okq ? sumsq : 1.0f);
  g.inv_norm = g.okq ? 1.0f / g.qnorm : 0.0f;
  g.w = g.okq ? a.q[0] * g.inv_norm : 1.0f;
  g.x = a.q[1] * g.inv_norm;
  g.y = a.q[2] * g.inv_norm;
  g.z = a.q[3] * g.inv_norm;
  const float w = g.w, x = g.x, y = g.y, z = g.z;
  g.r[0][0] = 1.0f - 2.0f * y * y - 2.0f * z * z;
  g.r[0][1] = 2.0f * x * y - 2.0f * z * w;
  g.r[0][2] = 2.0f * z * x + 2.0f * w * y;
  g.r[1][0] = 2.0f * x * y + 2.0f * z * w;
  g.r[1][1] = 1.0f - 2.0f * x * x - 2.0f * z * z;
  g.r[1][2] = 2.0f * y * z - 2.0f * w * x;
  g.r[2][0] = 2.0f * z * x - 2.0f * w * y;
  g.r[2][1] = 2.0f * y * z + 2.0f * w * x;
  g.r[2][2] = 1.0f - 2.0f * x * x - 2.0f * y * y;
#pragma unroll
  for (int k = 0; k < 3; ++k) g.s[k] = expf(2.0f * a.sc[k]);
  const float(&r)[3][3] = g.r;
  const float s0 = g.s[0], s1 = g.s[1], s2 = g.s[2];
  g.sig[0] = r[0][0] * r[0][0] * s0 + r[0][1] * r[0][1] * s1 + r[0][2] * r[0][2] * s2;
  g.sig[1] = r[0][0] * r[1][0] * s0 + r[0][1] * r[1][1] * s1 + r[0][2] * r[1][2] * s2;
  g.sig[2] = r[0][0] * r[2][0] * s0 + r[0][1] * r[2][1] * s1 + r[0][2] * r[2][2] * s2;
  g.sig[3] = r[1][0] * r[1][0] * s0 + r[1][1] * r[1][1] * s1 + r[1][2] * r[1][2] * s2;
  g.sig[4] = r[1][0] * r[2][0] * s0 + r[1][1] * r[2][1] * s1 + r[1][2] * r[2][2] * s2;
  g.sig[5] = r[2][0] * r[2][0] * s0 + r[2][1] * r[2][1] * s1 + r[2][2] * r[2][2] * s2;

  const float(&W)[3][3] = c.R;
  g.j00 = c.fx * g.inv_z;
  g.j02 = -c.fx * g.xc * g.inv_z * g.inv_z;
  g.j11 = c.fy * g.inv_z;
  g.j12 = -c.fy * g.yc * g.inv_z * g.inv_z;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g.m[0][k] = g.j00 * W[0][k] + g.j02 * W[2][k];
    g.m[1][k] = g.j11 * W[1][k] + g.j12 * W[2][k];
  }
  const float xx = g.sig[0], xy = g.sig[1], xz = g.sig[2];
  const float yy = g.sig[3], yz = g.sig[4], zz = g.sig[5];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    g.t[i][0] = g.m[i][0] * xx + g.m[i][1] * xy + g.m[i][2] * xz;
    g.t[i][1] = g.m[i][0] * xy + g.m[i][1] * yy + g.m[i][2] * yz;
    g.t[i][2] = g.m[i][0] * xz + g.m[i][1] * yz + g.m[i][2] * zz;
  }
  const float(&m)[2][3] = g.m;
  const float(&t)[2][3] = g.t;
  g.c0 = t[0][0] * m[0][0] + t[0][1] * m[0][1] + t[0][2] * m[0][2];
  g.c1 = (t[0][0] * m[1][0] + t[0][1] * m[1][1] + t[0][2] * m[1][2]) +
         (t[1][0] * m[0][0] + t[1][1] * m[0][1] + t[1][2] * m[0][2]);
  g.c2 = t[1][0] * m[1][0] + t[1][1] * m[1][1] + t[1][2] * m[1][2];
}

__device__ __forceinline__ float sigmoid(float o) { return 1.0f / (1.0f + expf(-o)); }

// The unit view direction from the camera centre, as precompute_rgb_from_sh
// forms it: the centre -(R^T t), d = view / |view|, zero where |view|^2 <=
// 1e-24.  Returns whether it was not guarded.
__device__ __forceinline__ bool view_dir(const Cam& c, const float p[3], float view[3],
                                         float& norm, float d[3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float centre = -(c.R[0][j] * c.t[0] + c.R[1][j] * c.t[1] + c.R[2][j] * c.t[2]);
    view[j] = p[j] - centre;
  }
  const float sumsq = view[0] * view[0] + view[1] * view[1] + view[2] * view[2];
  const bool ok = sumsq > 1e-24f;
  norm = sqrtf(ok ? sumsq : 1.0f);
#pragma unroll
  for (int j = 0; j < 3; ++j) d[j] = ok ? view[j] / norm : 0.0f;
  return ok;
}

// geometry.py's sh_basis, bands 0..3, at the unit direction d.
template <int kNSh>
__device__ __forceinline__ void sh_basis(const float d[3], float b[kNSh]) {
  const float x = d[0], y = d[1], z = d[2];
  b[0] = kSH0;
  if (kNSh >= 4) {
    b[1] = kSH1_0 * y;
    b[2] = kSH1_1 * z;
    b[3] = kSH1_2 * x;
  }
  if (kNSh >= 9) {
    const float xx = x * x, yy = y * y, zz = z * z;
    b[4] = kSH2_0 * x * y;
    b[5] = kSH2_1 * y * z;
    b[6] = kSH2_2 * (3.0f * zz - 1.0f);
    b[7] = kSH2_3 * x * z;
    b[8] = kSH2_4 * (xx - yy);
    if (kNSh >= 16) {
      b[9] = kSH3_0 * y * (3.0f * xx - yy);
      b[10] = kSH3_1 * x * y * z;
      b[11] = kSH3_2 * y * (5.0f * zz - 1.0f);
      b[12] = kSH3_3 * z * (5.0f * zz - 3.0f);
      b[13] = kSH3_4 * x * (5.0f * zz - 1.0f);
      b[14] = kSH3_5 * z * (xx - yy);
      b[15] = kSH3_6 * x * (xx - 3.0f * yy);
    }
  }
}

// The reverse of sh_basis: d/dd of sum_k gb[k] b[k] (b[0] is a constant).
template <int kNSh>
__device__ __forceinline__ void sh_basis_grad(const float d[3], const float gb[kNSh],
                                              float gd[3]) {
  const float x = d[0], y = d[1], z = d[2];
  float gx = 0.0f, gy = 0.0f, gz = 0.0f;
  if (kNSh >= 4) {
    gy += kSH1_0 * gb[1];
    gz += kSH1_1 * gb[2];
    gx += kSH1_2 * gb[3];
  }
  if (kNSh >= 9) {
    const float xx = x * x, yy = y * y, zz = z * z;
    float gxx = 0.0f, gyy = 0.0f, gzz = 0.0f;
    gx += kSH2_0 * (gb[4] * y);
    gy += gb[4] * (kSH2_0 * x);
    gy += kSH2_1 * (gb[5] * z);
    gz += gb[5] * (kSH2_1 * y);
    gzz += 3.0f * (kSH2_2 * gb[6]);
    gx += kSH2_3 * (gb[7] * z);
    gz += gb[7] * (kSH2_3 * x);
    gxx += kSH2_4 * gb[8];
    gyy -= kSH2_4 * gb[8];
    if (kNSh >= 16) {
      const float a9 = kSH3_0 * y;
      gy += kSH3_0 * (gb[9] * (3.0f * xx - yy));
      gxx += 3.0f * (gb[9] * a9);
      gyy -= gb[9] * a9;
      const float a10 = kSH3_1 * x, b10 = a10 * y;
      const float g10 = gb[10] * z;
      gz += gb[10] * b10;
      gy += g10 * a10;
      gx += kSH3_1 * (g10 * y);
      const float a11 = kSH3_2 * y;
      gy += kSH3_2 * (gb[11] * (5.0f * zz - 1.0f));
      gzz += 5.0f * (gb[11] * a11);
      const float a12 = kSH3_3 * z;
      gz += kSH3_3 * (gb[12] * (5.0f * zz - 3.0f));
      gzz += 5.0f * (gb[12] * a12);
      const float a13 = kSH3_4 * x;
      gx += kSH3_4 * (gb[13] * (5.0f * zz - 1.0f));
      gzz += 5.0f * (gb[13] * a13);
      const float a14 = kSH3_5 * z;
      gz += kSH3_5 * (gb[14] * (xx - yy));
      gxx += gb[14] * a14;
      gyy -= gb[14] * a14;
      const float a15 = kSH3_6 * x;
      gx += kSH3_6 * (gb[15] * (xx - 3.0f * yy));
      gxx += gb[15] * a15;
      gyy -= 3.0f * (gb[15] * a15);
    }
    gx += 2.0f * x * gxx;
    gy += 2.0f * y * gyy;
    gz += 2.0f * z * gzz;
  }
  gd[0] = gx;
  gd[1] = gy;
  gd[2] = gz;
}

// The coefficient c*n_sh + k of a gaussian: rgb for k = 0, else its staged
// sh record's entry (c, k - 1).
__device__ __forceinline__ float coeff(const float rgb[3], const float* rec, int c, int k) {
  return k == 0 ? rgb[c] : rec[c * 15 + k - 1];
}

// A block's sh records, count floats from g + first, into shared memory in
// 16-byte words where g is 16-byte aligned (first is a multiple of 4: a
// block's first record starts at a multiple of 128 * 45 floats).
__device__ __forceinline__ void stage_in(float* s, const float* g, long long first,
                                         int count, bool vec) {
  int e = threadIdx.x;
  if (vec) {
    const float4* g4 = reinterpret_cast<const float4*>(g + first);
    float4* s4 = reinterpret_cast<float4*>(s);
    for (; e < count / 4; e += kThreads) s4[e] = __ldg(g4 + e);
    e = count / 4 * 4 + threadIdx.x;
  }
  for (; e < count; e += kThreads) s[e] = __ldg(g + first + e);
}

__device__ __forceinline__ void stage_out(float* g, const float* s, long long first,
                                          int count, bool vec) {
  int e = threadIdx.x;
  if (vec) {
    float4* g4 = reinterpret_cast<float4*>(g + first);
    const float4* s4 = reinterpret_cast<const float4*>(s);
    for (; e < count / 4; e += kThreads) g4[e] = s4[e];
    e = count / 4 * 4 + threadIdx.x;
  }
  for (; e < count; e += kThreads) g[first + e] = s[e];
}

template <int kMode, int kNSh>
__global__ void __launch_bounds__(kThreads)
    geometry_fwd_kernel(const Inputs in, const Cull cull, float* __restrict__ feat,
                        float* __restrict__ z_out, bool* __restrict__ vis_out) {
  constexpr bool kStage = kMode != kModeRows && kNSh > 1;
  __shared__ float4 staged4[kStage ? kThreads * kShRec / 4 : 1];
  float* staged = reinterpret_cast<float*>(staged4);
  const int base = blockIdx.x * kThreads;
  if (kStage) {
    stage_in(staged, in.sh, static_cast<long long>(base) * kShRec,
             min(kThreads, in.n - base) * kShRec, in.sh_vec);
    __syncthreads();
  }
  const int i = base + threadIdx.x;
  if (i >= in.n) return;  // past the block's only barrier
  const long long n = in.n;
  const Cam c = load_cam(in.pose, in.K);
  const Params a = load_params(in, i);
  Geo g;
  geometry(c, a, g);
  float u = c.fx * g.xc * g.inv_z + c.cx;
  float v = c.fy * g.yc * g.inv_z + c.cy;
  if (in.uv_offset != nullptr) {
    u = u + __ldg(in.uv_offset + i);
    v = v + __ldg(in.uv_offset + n + i);
  }
  const float op = kMode == kModeRows ? a.op : sigmoid(a.op);
  float rgb[3];
  const float* x = in.rgb + i * in.s_rgb;
#pragma unroll
  for (int k = 0; k < 3; ++k) rgb[k] = __ldg(x + k);

  bool culled = (g.zc < cull.near_z) | (g.zc > cull.far_z);
  culled |= (u < cull.lo) | (u > cull.hi_u);
  culled |= (v < cull.lo) | (v > cull.hi_v);
  bool vis = !culled;
  if (in.alive != nullptr) vis = vis & in.alive[i];
  z_out[i] = g.zc;
  vis_out[i] = vis;

  feat[0 * n + i] = u;
  feat[1 * n + i] = v;
  feat[2 * n + i] = op;
  feat[3 * n + i] = g.c0 + 0.25f;
  feat[4 * n + i] = g.c1 * 0.5f;
  feat[5 * n + i] = g.c2 + 0.25f;
  if (kMode == kModeRows) {
#pragma unroll
    for (int k = 0; k < 3; ++k) feat[(6 + k) * n + i] = rgb[k];
  } else if (kMode == kModeSH) {
    const float* rec = staged + threadIdx.x * kShRec;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
#pragma unroll
      for (int k = 0; k < kNSh; ++k) {
        feat[(6 + ch * kNSh + k) * n + i] = coeff(rgb, rec, ch, k);
      }
    }
  } else if (kNSh == 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) feat[(6 + k) * n + i] = rgb[k] * kSH0;
  } else {
    float view[3], norm, d[3], b[kNSh];
    view_dir(c, a.p, view, norm, d);
    sh_basis<kNSh>(d, b);
    const float* rec = staged + threadIdx.x * kShRec;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float sum = coeff(rgb, rec, ch, 0) * b[0];
#pragma unroll
      for (int k = 1; k < kNSh; ++k) sum = sum + coeff(rgb, rec, ch, k) * b[k];
      feat[(6 + ch) * n + i] = sum * kRSH0 * kSH0;
    }
  }
}

template <int kMode, int kNSh>
__global__ void __launch_bounds__(kThreads)
    geometry_bwd_kernel(const Inputs in, const float* __restrict__ gfeat, const Grads out) {
  constexpr bool kStage = kMode == kModeDC && kNSh > 1;
  __shared__ float4 staged4[kStage ? kThreads * kShRec / 4 : 1];
  float* staged = reinterpret_cast<float*>(staged4);
  const int base = blockIdx.x * kThreads;
  const long long first = static_cast<long long>(base) * kShRec;
  const int count = min(kThreads, in.n - base) * kShRec;
  if (kStage) {
    stage_in(staged, in.sh, first, count, in.sh_vec);
    __syncthreads();
  }
  const int i = base + threadIdx.x;
  const bool live = i < in.n;
  const long long n = in.n;
  // the colour's coefficient gradients, written to the staged records once
  // every thread of the block has read its own
  float gsum[3] = {0.0f, 0.0f, 0.0f};
  float b[kNSh];
  if (live) {
    const Cam c = load_cam(in.pose, in.K);
    const Params a = load_params(in, i, kMode != kModeRows);
    Geo g;
    geometry(c, a, g);
    // the decoded rows' opacity gradient is their opacity row's, as it stands
    float gf[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      gf[r] = r == 2 && kMode == kModeRows ? 0.0f : __ldg(gfeat + r * n + i);
    }
    float gp[3] = {0.0f, 0.0f, 0.0f};  // d/dxyz besides the camera transform's

    // colour: the SH colour's gradient reads the sh record and not rgb (the
    // colour is linear in its coefficients); the per-pixel and decoded rows'
    // colour gradients are the wrapper's views of gfeat
    float grgb[3] = {0.0f, 0.0f, 0.0f};
    if (kMode == kModeRows || kMode == kModeSH) {
    } else if (kNSh == 1) {
#pragma unroll
      for (int k = 0; k < 3; ++k) grgb[k] = __ldg(gfeat + (6 + k) * n + i) * kSH0;
    } else {
      float view[3], norm, d[3];
      const bool ok = view_dir(c, a.p, view, norm, d);
      sh_basis<kNSh>(d, b);
      const float* rec = staged + threadIdx.x * kShRec;
      float gb[kNSh];
#pragma unroll
      for (int k = 0; k < kNSh; ++k) gb[k] = 0.0f;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        gsum[ch] = __ldg(gfeat + (6 + ch) * n + i) * kSH0 * kRSH0;
#pragma unroll
        for (int k = 1; k < kNSh; ++k) gb[k] = gb[k] + gsum[ch] * rec[ch * 15 + k - 1];
        grgb[ch] = gsum[ch] * b[0];
      }
      float gd[3];
      sh_basis_grad<kNSh>(d, gb, gd);
      if (ok) {
        // d = view / norm, norm = sqrt(view . view)
        float gnorm = 0.0f;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          gp[j] = gd[j] / norm;
          gnorm = gnorm - gd[j] * view[j] / (norm * norm);
        }
        const float gsumsq = gnorm / (2.0f * norm);
#pragma unroll
        for (int j = 0; j < 3; ++j) gp[j] = gp[j] + 2.0f * view[j] * gsumsq;
      }
    }

    // opacity: sigmoid's (the decoded rows' is not written)
    const float op = sigmoid(a.op);
    const float gop = gf[2] * (1.0f - op) * op;

    // projection: u = fx xc inv_z + cx (+ offset), v likewise
    float gxc = gf[0] * g.inv_z * c.fx;
    float gyc = gf[1] * g.inv_z * c.fy;
    float ginv = gf[0] * (c.fx * g.xc) + gf[1] * (c.fy * g.yc);

    // conic [a, 2b, c] from t = M Sigma and M
    const float gc0 = gf[3], gc1 = gf[4] * 0.5f, gc2 = gf[5];
    float gt[2][3], gm[2][3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      gt[0][k] = gc0 * g.m[0][k] + gc1 * g.m[1][k];
      gt[1][k] = gc1 * g.m[0][k] + gc2 * g.m[1][k];
      gm[0][k] = gc0 * g.t[0][k] + gc1 * g.t[1][k];
      gm[1][k] = gc1 * g.t[0][k] + gc2 * g.t[1][k];
    }
    const float S[3][3] = {{g.sig[0], g.sig[1], g.sig[2]},
                           {g.sig[1], g.sig[3], g.sig[4]},
                           {g.sig[2], g.sig[4], g.sig[5]}};
    float gS[3][3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int k = 0; k < 3; ++k) gS[j][k] = gt[0][k] * g.m[0][j] + gt[1][k] * g.m[1][j];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        gm[r][j] = gm[r][j] + (gt[r][0] * S[j][0] + gt[r][1] * S[j][1] + gt[r][2] * S[j][2]);
      }
    }
    const float gxx = gS[0][0], gxy = gS[0][1] + gS[1][0], gxz = gS[0][2] + gS[2][0];
    const float gyy = gS[1][1], gyz = gS[1][2] + gS[2][1], gzz = gS[2][2];

    // M = J W
    const float(&W)[3][3] = c.R;
    const float gj00 = gm[0][0] * W[0][0] + gm[0][1] * W[0][1] + gm[0][2] * W[0][2];
    const float gj02 = gm[0][0] * W[2][0] + gm[0][1] * W[2][1] + gm[0][2] * W[2][2];
    const float gj11 = gm[1][0] * W[1][0] + gm[1][1] * W[1][1] + gm[1][2] * W[1][2];
    const float gj12 = gm[1][0] * W[2][0] + gm[1][1] * W[2][1] + gm[1][2] * W[2][2];
    // J: j00 = fx inv_z, j02 = ((-fx xc) inv_z) inv_z, j11, j12 likewise
    ginv = ginv + gj00 * c.fx + gj11 * c.fy;
    {
      const float A = -c.fx * g.xc, B = A * g.inv_z;
      const float gB = gj02 * g.inv_z;
      ginv = ginv + gj02 * B + gB * A;
      gxc = gxc + gB * g.inv_z * (-c.fx);
    }
    {
      const float A = -c.fy * g.yc, B = A * g.inv_z;
      const float gB = gj12 * g.inv_z;
      ginv = ginv + gj12 * B + gB * A;
      gyc = gyc + gB * g.inv_z * (-c.fy);
    }
    // inv_z = 1 / zc where |zc| > 1e-12
    const float gzc = g.okz ? -ginv * ((1.0f / g.zc) / g.zc) : 0.0f;
    float* ox = out.xyz + 3LL * i;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      ox[j] = gp[j] + (c.R[0][j] * gxc + c.R[1][j] * gyc + c.R[2][j] * gzc);
    }

    // Sigma = R diag(s) R^T and s = exp(2 log-scale)
    float gr[3][3];
    float* os = out.scale + 3LL * i;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float r0 = g.r[0][k], r1 = g.r[1][k], r2 = g.r[2][k], sk = g.s[k];
      const float gs = gxx * r0 * r0 + gxy * r0 * r1 + gxz * r0 * r2 + gyy * r1 * r1 +
                       gyz * r1 * r2 + gzz * r2 * r2;
      gr[0][k] = (2.0f * gxx * r0 + gxy * r1 + gxz * r2) * sk;
      gr[1][k] = (gxy * r0 + 2.0f * gyy * r1 + gyz * r2) * sk;
      gr[2][k] = (gxz * r0 + gyz * r1 + 2.0f * gzz * r2) * sk;
      os[k] = gs * sk * 2.0f;
    }
    // R from the normalised quaternion
    const float w = g.w, qx = g.x, qy = g.y, qz = g.z;
    const float gw = 2.0f * (-qz * gr[0][1] + qy * gr[0][2] + qz * gr[1][0] - qx * gr[1][2] -
                             qy * gr[2][0] + qx * gr[2][1]);
    const float gx = 2.0f * (qy * gr[0][1] + qz * gr[0][2] + qy * gr[1][0] -
                             2.0f * qx * gr[1][1] - w * gr[1][2] + qz * gr[2][0] +
                             w * gr[2][1] - 2.0f * qx * gr[2][2]);
    const float gy = 2.0f * (-2.0f * qy * gr[0][0] + qx * gr[0][1] + w * gr[0][2] +
                             qx * gr[1][0] + qz * gr[1][2] - w * gr[2][0] + qz * gr[2][1] -
                             2.0f * qy * gr[2][2]);
    const float gz = 2.0f * (-2.0f * qz * gr[0][0] - w * gr[0][1] + qx * gr[0][2] +
                             w * gr[1][0] - 2.0f * qz * gr[1][1] + qy * gr[1][2] +
                             qx * gr[2][0] + qy * gr[2][1]);
    // the normalisation q / |q|; a guarded quaternion passes w = 1 and
    // inv_norm = 0 on, so its gradient is zero
    float gq[4] = {g.okq ? gw * g.inv_norm : 0.0f, gx * g.inv_norm, gy * g.inv_norm,
                   gz * g.inv_norm};
    float gsumsq = 0.0f;
    if (g.okq) {  // inv_norm = 1 / qnorm, qnorm = sqrt(sumsq)
      const float ginv_norm = gw * a.q[0] + gx * a.q[1] + gy * a.q[2] + gz * a.q[3];
      gsumsq = -ginv_norm * ((1.0f / g.qnorm) / g.qnorm) / (2.0f * g.qnorm);
    }
    float* oq = out.quat + 4LL * i;
#pragma unroll
    for (int k = 0; k < 4; ++k) oq[k] = gq[k] + 2.0f * a.q[k] * gsumsq;

    if (kMode != kModeRows) out.opacity[i] = gop;
    if (kMode == kModeDC) {
      float* orgb = out.rgb + 3LL * i;
#pragma unroll
      for (int k = 0; k < 3; ++k) orgb[k] = grgb[k];
    }
  }
  if (!kStage) return;
  __syncthreads();  // every thread has read its staged record
  if (live) {
    float* rec = staged + threadIdx.x * kShRec;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
#pragma unroll
      for (int k = 1; k < 16; ++k) {
        rec[ch * 15 + k - 1] = k < kNSh ? gsum[ch] * b[k] : 0.0f;
      }
    }
  }
  __syncthreads();
  stage_out(out.sh, staged, first, count, in.sh_vec);
}

template <int kMode, int kNSh>
int launch_fwd(const Inputs& in, const Cull& cull, float* feat, float* z, bool* vis,
               cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((in.n + kThreads - 1) / kThreads);
  geometry_fwd_kernel<kMode, kNSh><<<blocks, kThreads, 0, stream>>>(in, cull, feat, z, vis);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode, int kNSh>
int launch_bwd(const Inputs& in, const float* gfeat, const Grads& out, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((in.n + kThreads - 1) / kThreads);
  geometry_bwd_kernel<kMode, kNSh><<<blocks, kThreads, 0, stream>>>(in, gfeat, out);
  return static_cast<int>(cudaGetLastError());
}

// ptrs (host): xyz, quaternion, scale, opacity, rgb, sh, uv_offset, alive,
// pose, K; dims (host): the row strides of xyz, quaternion, scale, opacity,
// rgb in floats, then n, the quaternion and sh alignment flags.
Inputs unpack(const long long* ptrs, const long long* dims) {
  Inputs in;
  in.xyz = reinterpret_cast<const float*>(ptrs[0]);
  in.quat = reinterpret_cast<const float*>(ptrs[1]);
  in.scale = reinterpret_cast<const float*>(ptrs[2]);
  in.opacity = reinterpret_cast<const float*>(ptrs[3]);
  in.rgb = reinterpret_cast<const float*>(ptrs[4]);
  in.sh = reinterpret_cast<const float*>(ptrs[5]);
  in.uv_offset = reinterpret_cast<const float*>(ptrs[6]);
  in.alive = reinterpret_cast<const bool*>(ptrs[7]);
  in.pose = reinterpret_cast<const float*>(ptrs[8]);
  in.K = reinterpret_cast<const float*>(ptrs[9]);
  in.s_xyz = dims[0];
  in.s_quat = dims[1];
  in.s_scale = dims[2];
  in.s_opacity = dims[3];
  in.s_rgb = dims[4];
  in.n = static_cast<int>(dims[5]);
  in.quat_vec = static_cast<int>(dims[6]);
  in.sh_vec = static_cast<int>(dims[7]);
  return in;
}

}  // namespace
}  // namespace gs

// mode: 0 scene parameters with SH once per gaussian, 1 per-pixel SH rows,
// 2 decoded rows; n_sh 1, 4, 9 or 16 (1 for mode 2).  cull (host): near, far,
// -pad, width + pad, height + pad.  Writes feat (rows, n), z (n,), visible (n,).
extern "C" int gs_geometry_fwd(const long long* ptrs, const long long* dims, int mode,
                               int n_sh, const float* cull, float* feat, float* z,
                               bool* visible, cudaStream_t stream) {
  const gs::Inputs in = gs::unpack(ptrs, dims);
  if (in.n <= 0) return 0;
  const gs::Cull c{cull[0], cull[1], cull[2], cull[3], cull[4]};
  using namespace gs;
  if (mode == kModeDC && n_sh == 1) return launch_fwd<kModeDC, 1>(in, c, feat, z, visible, stream);
  if (mode == kModeDC && n_sh == 4) return launch_fwd<kModeDC, 4>(in, c, feat, z, visible, stream);
  if (mode == kModeDC && n_sh == 9) return launch_fwd<kModeDC, 9>(in, c, feat, z, visible, stream);
  if (mode == kModeDC && n_sh == 16) return launch_fwd<kModeDC, 16>(in, c, feat, z, visible, stream);
  if (mode == kModeSH && n_sh == 4) return launch_fwd<kModeSH, 4>(in, c, feat, z, visible, stream);
  if (mode == kModeSH && n_sh == 9) return launch_fwd<kModeSH, 9>(in, c, feat, z, visible, stream);
  if (mode == kModeSH && n_sh == 16) return launch_fwd<kModeSH, 16>(in, c, feat, z, visible, stream);
  if (mode == kModeRows && n_sh == 1) return launch_fwd<kModeRows, 1>(in, c, feat, z, visible, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ptrs and dims as for gs_geometry_fwd (uv_offset and alive unused); gfeat
// (rows, n) contiguous; grads (host): xyz, quaternion, scale, opacity (null in
// mode 2), rgb (null in modes 1 and 2), sh (null unless mode 0 with n_sh > 1),
// each contiguous.
extern "C" int gs_geometry_bwd(const long long* ptrs, const long long* dims, int mode,
                               int n_sh, const float* gfeat, const long long* grads,
                               cudaStream_t stream) {
  const gs::Inputs in = gs::unpack(ptrs, dims);
  if (in.n <= 0) return 0;
  const gs::Grads g{reinterpret_cast<float*>(grads[0]), reinterpret_cast<float*>(grads[1]),
                    reinterpret_cast<float*>(grads[2]), reinterpret_cast<float*>(grads[3]),
                    reinterpret_cast<float*>(grads[4]), reinterpret_cast<float*>(grads[5])};
  using namespace gs;
  if (mode == kModeDC && n_sh == 1) return launch_bwd<kModeDC, 1>(in, gfeat, g, stream);
  if (mode == kModeDC && n_sh == 4) return launch_bwd<kModeDC, 4>(in, gfeat, g, stream);
  if (mode == kModeDC && n_sh == 9) return launch_bwd<kModeDC, 9>(in, gfeat, g, stream);
  if (mode == kModeDC && n_sh == 16) return launch_bwd<kModeDC, 16>(in, gfeat, g, stream);
  if (mode == kModeSH && (n_sh == 4 || n_sh == 9 || n_sh == 16)) {
    return launch_bwd<kModeSH, 1>(in, gfeat, g, stream);  // geometry leaves only
  }
  if (mode == kModeRows && n_sh == 1) return launch_bwd<kModeRows, 1>(in, gfeat, g, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
