// E2: segmented exclusive prefix sum over float32 rows (a probe of the
// prefix-transmittance step of the render kernels, not on the render path).
//
// Replaces the Pallas kernel experiments/cumsum_bench.py::mk_kernel (its
// inner `kernel`), whose three modes (a strictly upper-triangular ones
// matmul, cumsum, associative_scan) compute the same function.  The plain
// PyTorch version is
// gaussian_splatting_torch/experiments/cumsum_bench.py::scan_plain.
//
// x is (P, T) float32, cut into segments of C elements along each row; the
// rows are contiguous, so segment w covers x[w*C, (w+1)*C) of the flat
// array.  out[w*C + k] = sum over k' < k of x[w*C + k'].
//
// Design: one warp per segment, 8 warps a block.  Lane l owns the run of
// C / 32 contiguous elements starting at l * C / 32 (8 at C = 256, 16 at
// C = 512), which it loads as float4 and sums serially; a warp-shuffle
// scan of the lanes' totals gives each lane the sum of the runs before its
// own, and the lane writes its run's exclusive prefix as float4.  No shared
// memory and no barrier; the kernel is a template on C (256, 512).
//
// What bounds it on the H100: bytes.  x is read once and out written once,
// 2 * P * T * 4 bytes (2.15 GB at P = 256, T = 2^20: 0.641 ms at
// 3.35 TB/s), against two float32 adds an element (0.008 ms at 67 TFLOP/s).
#include "../common.cuh"

namespace gs {
namespace {

constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / kWarpSize;

template <int C>
__global__ void __launch_bounds__(kScanThreads)
    scan_probe_kernel(const float* __restrict__ x, long long n_seg,
                      float* __restrict__ out) {
  constexpr int kRun = C / kWarpSize;
  constexpr int kVec = kRun / 4;
  const long long seg =
      (long long)blockIdx.x * kScanWarps + threadIdx.x / kWarpSize;
  if (seg >= n_seg) return;  // warp-uniform: the whole warp leaves
  const int lane = threadIdx.x % kWarpSize;
  const size_t first = size_t(seg) * C + size_t(lane) * kRun;

  const float4* src = reinterpret_cast<const float4*>(x + first);
  float v[kRun];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const float4 q = src[i];
    v[4 * i] = q.x;
    v[4 * i + 1] = q.y;
    v[4 * i + 2] = q.z;
    v[4 * i + 3] = q.w;
  }
  float total = v[0];
#pragma unroll
  for (int k = 1; k < kRun; ++k) total += v[k];

  // inclusive scan of the lanes' totals, then shift by one lane
  float incl = total;
#pragma unroll
  for (int o = 1; o < kWarpSize; o <<= 1) {
    const float y = __shfl_up_sync(kFullMask, incl, o);
    if (lane >= o) incl += y;
  }
  float acc = __shfl_up_sync(kFullMask, incl, 1);
  if (lane == 0) acc = 0.0f;

  float4* dst = reinterpret_cast<float4*>(out + first);
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    float4 q;
    q.x = acc;
    acc += v[4 * i];
    q.y = acc;
    acc += v[4 * i + 1];
    q.z = acc;
    acc += v[4 * i + 2];
    q.w = acc;
    acc += v[4 * i + 3];
    dst[i] = q;
  }
}

template <int C>
void launch_scan(const float* x, long long n_seg, float* out,
                 cudaStream_t stream) {
  const long long blocks = (n_seg + kScanWarps - 1) / kScanWarps;
  scan_probe_kernel<C><<<unsigned(blocks), kScanThreads, 0, stream>>>(
      x, n_seg, out);
}

}  // namespace
}  // namespace gs

// x, out: n_seg * chunk contiguous float32, 16-byte aligned; chunk is 256
// or 512.
extern "C" int gs_scan_probe(const float* x, long long n_seg, int chunk,
                             float* out, cudaStream_t stream) {
  if (n_seg <= 0) return static_cast<int>(cudaGetLastError());
  switch (chunk) {
    case 256:
      gs::launch_scan<256>(x, n_seg, out, stream);
      break;
    case 512:
      gs::launch_scan<512>(x, n_seg, out, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
