// E3: placement of row blocks at data-dependent offsets (a probe of the
// placement pass of a bucket sort, not on the render path).
//
// Replaces the Pallas kernel experiments/dma_scatter_bench.py::make_scatter
// (its inner `kernel`), which issues one DMA per sub-range of a VMEM block
// to a row offset read from a prefetched scalar array.  The plain PyTorch
// version is
// gaussian_splatting_torch/experiments/dma_scatter_bench.py::place_plain.
//
// x is (n_rows, 128) float32, cut into copies of `sub` rows; copy b goes to
// out[off[b], off[b] + sub).  Rows that no copy covers are left as they are;
// a row whose destination falls outside out is dropped.
//
// Design: a grid over 32-row tiles of x, 256 threads a tile.  Each warp
// copies 4 rows, one float4 a lane (a row of 128 float32 is 32 float4), with
// the 4 loads issued before the 4 stores.  A row looks up its copy's offset
// off[row / sub]; where sub >= 32 every row of a tile lies in one copy and
// the lookup is the same cached word for the whole tile, and where sub < 32
// a tile spans several copies.  There is no block per copy: at sub = 2048
// (nsub = 1, rows_blk = 2048) the probe has 16 copies of 1 MB each, and a
// block per copy would leave 116 of the 132 SMs idle; 32-row tiles give
// 1,024 blocks at every sweep point.
//
// What bounds it on the H100: bytes.  x read once, out written once and off
// read once, 2 * n_rows * 128 * 4 + 4 * n_rows / sub bytes (33.6 MB at
// n_rows = 2^15: 0.010 ms at 3.35 TB/s).  That is close to the fixed cost
// of one launch, which the probe's time includes.
#include "../common.cuh"

namespace gs {
namespace {

constexpr int kPlaceThreads = 256;
constexpr int kLanes = 128;                         // float32 per row
constexpr int kRowVec = kLanes / 4;                 // float4 per row
constexpr int kTileRows = 32;
constexpr int kRowsPerWarp = kTileRows / (kPlaceThreads / kWarpSize);  // 4

__global__ void __launch_bounds__(kPlaceThreads)
    place_probe_kernel(const float4* __restrict__ x, int n_rows,
                       const int* __restrict__ off, int sub,
                       float4* __restrict__ out) {
  const int warp = threadIdx.x / kWarpSize;
  const int lane = threadIdx.x % kWarpSize;
  const int row0 = blockIdx.x * kTileRows + warp * kRowsPerWarp;

  float4 v[kRowsPerWarp];
  int dst[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = row0 + i;
    if (row < n_rows) {
      const int b = row / sub;
      dst[i] = off[b] + (row - b * sub);
      v[i] = x[size_t(row) * kRowVec + lane];
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    // a row whose offset falls outside out is dropped, not written past it
    if (row0 + i < n_rows && dst[i] >= 0 && dst[i] < n_rows) {
      out[size_t(dst[i]) * kRowVec + lane] = v[i];
    }
  }
}

}  // namespace
}  // namespace gs

// x, out: (n_rows, 128) float32; off: (n_rows / sub,) int32 row offsets of
// disjoint copies, each off[b] + sub <= n_rows; sub divides n_rows.
extern "C" int gs_place_probe(const float* x, int n_rows, const int* off,
                              int sub, float* out, cudaStream_t stream) {
  if (n_rows > 0) {
    const int blocks = (n_rows + gs::kTileRows - 1) / gs::kTileRows;
    gs::place_probe_kernel<<<blocks, gs::kPlaceThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(x), n_rows, off, sub,
        reinterpret_cast<float4*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
