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
// Bound on the H100: bytes. The least traffic is one write of the map plus
// one read of the points (8 B each); at B=8, 450x800 the map's 11.5 MB
// dominates at radar density (P=640) and still at LiDAR density (P=40960,
// 2.6 MB of points): 3.45 / 4.22 us at 3.35 TB/s. So the kernel must keep
// the card's store path busy from the first cycle to the last, and write each
// map byte once.
//
// Design. The TPU kernel walks the pixel tiles of a row in order inside one
// program. Here one block walks a group of consecutive 1024-pixel tiles of
// one row, and the groups are sized so that the whole grid is resident at
// once (one wave: groups per row = resident blocks / B). Until a block has
// its first points no byte can be stored, so the design keeps the chain of
// dependent loads in front of the first store short:
//   1. the block finds the group's first point with a block-parallel search:
//      64 probes per step (two warps) shrink the range 64x; a range of
//      <= 1024 entries is read whole, up to 4 independent loads a thread, and
//      the entries below the key are counted. That is 1 round trip at P=640
//      and 2 at P=40960 (a search by one warp takes 2 and 4, and measured
//      slower L2-cold; 256 probes per step cost more in L2 requests than they
//      saved, PERF.md);
//   2. the block then holds a chunk of 256 consecutive points, index and
//      depth loaded together, one per thread; each point in the current tile
//      does one shared-memory atomicMin on its int32 bits, and
//      __syncthreads_count of "before the tile's end" says whether the chunk
//      is used up (take the next one) or reaches into a later tile (finish
//      this one). A tile's points start where the last tile's ended, so
//      nothing is searched again; a chunk that lies wholly inside the group
//      has the next one loaded behind it, while its tiles are reduced;
//   3. the finished tile leaves with +inf -> 0 applied on the way out, once,
//      by 16-byte stores from registers, each thread resetting its own words
//      to +inf. They need 16-byte-aligned rows and tile ends, i.e.
//      hw % 4 == 0 (450x800, 90x160); otherwise the tile goes out by 4-byte
//      stores inside the same kernel. A TMA bulk store of the tile from a
//      double buffer, and streaming stores (__stcs), measured no faster
//      (PERF.md); plain stores leave the map in the L2 for its reader.
// One launch, no fill or finalize pass. Non-negative IEEE floats order like
// their int32 bit patterns, so the integer min is the float min; kept depths
// are > min_depth >= 0 (the caller, ops/raster.py::rasterize_min_depth,
// raises for min_depth < 0), and a kept +0.0 comes out as +0.0. min is
// order-free, so the result is deterministic and equals kernel A's.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // pixels per tile, 4 per thread
constexpr int kProbes = 64;  // threads that probe in a search step
constexpr int kWhole = 4;  // a range of <= kThreads * kWhole is read whole
constexpr int kInfBits = 0x7f800000;  // +inf as int32
constexpr int kMaxDevices = 64;

// First index i in [0, n) with row[i] >= key, or n, found by the whole
// block (every thread must call it). Each step probes kProbes evenly spaced
// positions of [lo, hi); the probes below the key are a prefix of the
// probing threads, and the answer lies in the gap after the last of them. A
// small range is read whole and its entries below the key counted.
__device__ __forceinline__ int block_lower_bound(const int* __restrict__ row, int n, int key) {
  int lo = 0, hi = n;
  while (hi - lo > kThreads * kWhole) {  // block-uniform
    const int step = (hi - lo + kProbes - 1) / kProbes;
    const int pos = lo + threadIdx.x * step;
    const int c = __syncthreads_count(threadIdx.x < kProbes && pos < hi && row[pos] < key);
    if (c == 0) {
      hi = lo;
    } else {
      const int last = lo + (c - 1) * step;  // row[last] < key
      hi = min(last + step, hi);
      lo = last + 1;
    }
  }
  int v[kWhole];
#pragma unroll
  for (int k = 0; k < kWhole; ++k) {
    const int pos = lo + threadIdx.x + k * kThreads;
    v[k] = pos < hi ? row[pos] : INT_MAX;
  }
  const int rounds = (hi - lo + kThreads - 1) / kThreads;  // block-uniform
  int below = 0;
#pragma unroll
  for (int k = 0; k < kWhole; ++k) {
    if (k < rounds) below += __syncthreads_count(v[k] < key);
  }
  return lo + below;
}

__device__ __forceinline__ int inf_to_zero(int v) { return v == kInfBits ? 0 : v; }

// Writes tile t0.. of a row from `buf` with +inf -> 0 and resets the words
// it read to +inf. With `vec`, thread j owns words 4j..4j+3 and stores them
// as one float4; otherwise words j, j+256, ... by 4-byte stores.
__device__ __forceinline__ void store_and_reset(int* buf, float* orow, int t0, int hw,
                                                bool vec) {
  if (vec) {
    const int j = 4 * threadIdx.x;
    int4 v = *reinterpret_cast<int4*>(buf + j);
    *reinterpret_cast<int4*>(buf + j) = make_int4(kInfBits, kInfBits, kInfBits, kInfBits);
    if (t0 + j < hw) {
      *reinterpret_cast<float4*>(orow + t0 + j) =
          make_float4(__int_as_float(inf_to_zero(v.x)), __int_as_float(inf_to_zero(v.y)),
                      __int_as_float(inf_to_zero(v.z)), __int_as_float(inf_to_zero(v.w)));
    }
  } else {
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      const int v = buf[j];
      buf[j] = kInfBits;
      if (t0 + j < hw) orow[t0 + j] = __int_as_float(inf_to_zero(v));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
zbs_walk(const int* __restrict__ lin, const float* __restrict__ z, float* __restrict__ out,
         int points, int hw, int tiles_per_group) {
  __shared__ __align__(16) int tile[kTile];
  const int ntiles = (hw + kTile - 1) / kTile;
  const int first = blockIdx.x * tiles_per_group;
  const int last = min(first + tiles_per_group, ntiles);
  const int group_end = last * kTile;
  const long long row = blockIdx.y;
  const int* lrow = lin + row * points;
  const float* zrow = z + row * points;
  float* orow = out + row * hw;
  const bool vec = (hw & 3) == 0;  // rows and tile ends 16-byte aligned

  for (int j = threadIdx.x; j < kTile; j += kThreads) tile[j] = kInfBits;
  // its barriers also order the fill before any atomicMin
  int i = block_lower_bound(lrow, points, first * kTile) + threadIdx.x;

  // this thread's point of the current chunk and of the next; INT_MAX lies
  // past every tile
  int l = INT_MAX, next_l = INT_MAX;
  int zb = 0, next_zb = 0;
  if (i < points) {
    l = lrow[i];
    zb = __float_as_int(zrow[i]);
  }
  bool more = __syncthreads_count(l < group_end) == kThreads;
  if (more && i + kThreads < points) {
    next_l = lrow[i + kThreads];
    next_zb = __float_as_int(zrow[i + kThreads]);
  }
  for (int t = first; t < last; ++t) {
    const int t0 = t * kTile, t1 = t0 + kTile;
    for (;;) {
      // points before t0 went into an earlier tile of this group
      if (l >= t0 && l < t1) atomicMin(tile + (l - t0), zb);
      if (__syncthreads_count(l < t1) < kThreads) break;
      // the whole chunk lies before t1, so it was wholly inside the group
      // and the next one is loaded: take it, and load the one after
      i += kThreads;
      l = next_l;
      zb = next_zb;
      next_l = INT_MAX;
      more = __syncthreads_count(l < group_end) == kThreads;
      if (more && i + kThreads < points) {
        next_l = lrow[i + kThreads];
        next_zb = __float_as_int(zrow[i + kThreads]);
      }
    }
    store_and_reset(tile, orow, t0, hw, vec);
    __syncthreads();
  }
}

// Blocks of zbs_walk resident on the current device at once, cached per
// device; 0 on error.
int resident_blocks() {
  static int cache[kMaxDevices];
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices && cache[dev] > 0) return cache[dev];
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, zbs_walk, kThreads, 0) !=
          cudaSuccess) {
    return 0;
  }
  const int n = sms * per_sm;
  if (dev < kMaxDevices) cache[dev] = n;
  return n;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = success). The caller
// checks 0 < hw < 1<<30 (so the sentinel lies past every tile), batch <=
// 65535 (the grid's y limit) and that `out` is 16-byte aligned (any torch
// allocation is).
extern "C" int rdt_zbuffer_min_depth_sorted(const void* lin, const void* z, void* out,
                                            int batch, int points, int hw, void* stream) {
  const int resident = resident_blocks();
  if (resident <= 0) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidConfiguration);
  }
  const int ntiles = (hw + kTile - 1) / kTile;
  // one wave: as many groups per row as the card holds blocks per row
  const int groups_per_row = resident / batch > 1 ? resident / batch : 1;
  const int per_group = (ntiles + groups_per_row - 1) / groups_per_row;
  const dim3 grid((ntiles + per_group - 1) / per_group, batch);
  zbs_walk<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(lin), static_cast<const float*>(z), static_cast<float*>(out),
      points, hw, per_group);
  return static_cast<int>(cudaGetLastError());
}
