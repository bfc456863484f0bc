// E1: group-local permutation of int32 rows (a probe, not on the render path).
//
// Replaces the Pallas kernel experiments/permute_probe.py::make_permute (its
// inner `kernel`), which applies the permutation as a one-hot (G, G) float32
// product over the payload's 16-bit halves because the TPU has no vector
// scatter.  The plain PyTorch version is
// gaussian_splatting_torch/experiments/permute_probe.py::permute_plain.
//
// For every row r < R and group g of G elements:
//   out[r, g*G + dest[g, j]] = vals[r, g*G + j],
// where dest[g] is a permutation of [0, G).
//
// Design: Hopper scatters into shared memory, so no one-hot product and no
// 16-bit halves.  One block per group, 256 threads, G / 256 elements a
// thread.  Each thread loads its dest entries once and keeps them in
// registers: it alone reads them back.  Per row it scatters its values into
// a shared-memory row at their destinations and, after a barrier, writes
// the row out coalesced.  Two row buffers alternate, so one barrier a row
// suffices (row r + 2 reuses row r's buffer only after every thread passed
// row r + 1's barrier, which follows its reads of row r), and the next
// row's loads are issued before the barrier, so they are in flight while
// the block waits and writes.  Shared memory: 2 * G * 4 bytes, 16 KB at
// G = 2048, static.  The kernel is a template on G (256, 512, 1024, 2048).
//
// What bounds it on the H100: bytes.  Each element of vals and dest is read
// once and each of out written once, (2R + 1) * N * 4 bytes (109 MB at
// N = 2^21, R = 6: 0.033 ms at 3.35 TB/s); the shared-memory scatter costs
// a few bank conflicts per warp store and no device-memory traffic.
#include "../common.cuh"

namespace gs {
namespace {

constexpr int kPermuteThreads = 256;

template <int G>
__global__ void __launch_bounds__(kPermuteThreads)
    permute_probe_kernel(const int* __restrict__ vals,
                         const int* __restrict__ dest, int n, int rows,
                         int* __restrict__ out) {
  constexpr int kPer = G / kPermuteThreads;
  __shared__ int s_row[2][G];
  const size_t base = size_t(blockIdx.x) * G;
  const int t = threadIdx.x;

  int d[kPer], v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    // masked into the group, so a bad entry cannot write past the row
    d[k] = dest[base + k * kPermuteThreads + t] & (G - 1);
    v[k] = vals[base + k * kPermuteThreads + t];
  }
  for (int r = 0; r < rows; ++r) {
    int* buf = s_row[r & 1];
#pragma unroll
    for (int k = 0; k < kPer; ++k) buf[d[k]] = v[k];
    if (r + 1 < rows) {
      const int* src = vals + size_t(r + 1) * n + base;
#pragma unroll
      for (int k = 0; k < kPer; ++k) v[k] = src[k * kPermuteThreads + t];
    }
    __syncthreads();
    int* dst = out + size_t(r) * n + base;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      dst[k * kPermuteThreads + t] = buf[k * kPermuteThreads + t];
    }
  }
}

template <int G>
void launch_permute(const int* vals, const int* dest, int n, int rows,
                    int* out, cudaStream_t stream) {
  permute_probe_kernel<G><<<n / G, kPermuteThreads, 0, stream>>>(
      vals, dest, n, rows, out);
}

}  // namespace
}  // namespace gs

// vals: (rows, n) int32; dest: (n / group, group) int32, each row a
// permutation of [0, group); out: (rows, n) int32.  group is 256, 512, 1024
// or 2048 and divides n.
extern "C" int gs_permute_probe(const int* vals, const int* dest, int n,
                                int rows, int group, int* out,
                                cudaStream_t stream) {
  if (n <= 0 || rows <= 0) return static_cast<int>(cudaGetLastError());
  switch (group) {
    case 256:
      gs::launch_permute<256>(vals, dest, n, rows, out, stream);
      break;
    case 512:
      gs::launch_permute<512>(vals, dest, n, rows, out, stream);
      break;
    case 1024:
      gs::launch_permute<1024>(vals, dest, n, rows, out, stream);
      break;
    case 2048:
      gs::launch_permute<2048>(vals, dest, n, rows, out, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
