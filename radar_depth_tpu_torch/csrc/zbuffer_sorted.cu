// Kernel C: min-depth z-buffer over points sorted by pixel, CUDA C++ for sm_90a.
//
// Replaces radar_depth_tpu/ops/pallas_kernels.py::rasterize_min_depth_pallas_sorted
// (kernel body _raster_sorted_kernel). Same contract: lin (B, P) int32 linear
// pixel index v*W+u, ascending along each row, with the sentinel 1<<30 for a
// dropped point (it sorts last and falls in no tile); z (B, P) float32 depth,
// in the same order; out (B, H*W) float32, the minimum depth of the points
// that hit each pixel and 0 where none does. The sort is done by the caller
// (ops/raster.py::sort_points_by_pixel), as the TPU path sorts in XLA outside
// its pallas_call. Within one pixel's run the depths are in input order, not
// sorted, so the kernel takes the min over the whole run.
//
// Design. The TPU kernel loops over pixel tiles in one program per batch row
// and compares each of a tile's points with every pixel of the tile. Here one
// block owns one (batch row, 1024-pixel tile) and all blocks run at once:
//   1. two threads binary-search the row for the tile's point range [s, e)
//      (the TPU wrapper's searchsorted, done in the kernel);
//   2. the tile lives in shared memory as int32 bits, starts at +inf, and
//      each point of [s, e) does one shared-memory atomicMin;
//   3. the tile is written once, coalesced, with +inf -> 0.
// One launch, and the map is written once with no fill or finalize pass.
// Non-negative IEEE floats order like their int32 bit patterns, so the
// integer min is the float min; kept depths are > min_depth >= 0 (the caller,
// ops/raster.py::rasterize_min_depth, raises for min_depth < 0). min is
// order-free, so the result is deterministic and equals kernel A's.
//
// Bound on the H100: bytes. The least traffic is one write of the map plus
// one read of the points (8 B each); at B=8, 450x800 the map's 11.5 MB
// dominates at radar density (P=640) and still at LiDAR density (P=40960,
// 2.6 MB of points). Each point is read once, by the one tile it falls in.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // pixels per block, 4 per thread
constexpr int kInfBits = 0x7f800000;  // +inf as int32

// First index i in [0, n) with row[i] >= key, or n.
__device__ __forceinline__ int lower_bound(const int* __restrict__ row, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (row[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
zbs_tile(const int* __restrict__ lin, const float* __restrict__ z, float* __restrict__ out,
         int points, int hw) {
  __shared__ int tile[kTile];
  __shared__ int range[2];
  const int t0 = blockIdx.x * kTile;
  const long long row = static_cast<long long>(blockIdx.y) * points;
  const int* lrow = lin + row;
  const float* zrow = z + row;

  for (int j = threadIdx.x; j < kTile; j += kThreads) tile[j] = kInfBits;
  if (threadIdx.x < 2) range[threadIdx.x] = lower_bound(lrow, points, t0 + threadIdx.x * kTile);
  __syncthreads();

  const int s = range[0], e = range[1];
  for (int i = s + threadIdx.x; i < e; i += kThreads) {
    // lrow[i] is in [t0, t0 + kTile) by the two searches.
    atomicMin(&tile[lrow[i] - t0], __float_as_int(zrow[i]));
  }
  __syncthreads();

  float* orow = out + static_cast<long long>(blockIdx.y) * hw;
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const int p = t0 + j;
    if (p < hw) {
      const int v = tile[j];
      orow[p] = v == kInfBits ? 0.f : __int_as_float(v);
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = success). The caller
// checks 0 < hw < 1<<30 (so the sentinel lies past every tile) and
// batch <= 65535 (the grid's y limit).
extern "C" int rdt_zbuffer_min_depth_sorted(const void* lin, const void* z, void* out,
                                            int batch, int points, int hw, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((hw + kTile - 1) / kTile, batch);
  zbs_tile<<<grid, kThreads, 0, st>>>(static_cast<const int*>(lin),
                                      static_cast<const float*>(z),
                                      static_cast<float*>(out), points, hw);
  return static_cast<int>(cudaGetLastError());
}
