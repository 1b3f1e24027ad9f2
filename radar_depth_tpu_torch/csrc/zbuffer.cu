// Kernel A: min-depth z-buffer for sparse projected points, CUDA C++ for sm_90a.
//
// Replaces radar_depth_tpu/ops/pallas_kernels.py::rasterize_min_depth_pallas
// (kernel body _raster_kernel). Same contract: lin (B, P) int32 linear pixel
// index v*W+u, or -1 for a dropped point; z (B, P) float32 depth; out
// (B, H*W) float32, the minimum depth of the points that hit each pixel and 0
// where none does.
//
// Design. The TPU kernel compares every point with every pixel of a tile
// (P x TILE broadcast compares) because the TPU has no scatter; Hopper has
// native 32-bit atomics, so one thread per point does a single atomicMin.
// Three launches on the caller's stream:
//   1. fill the map with the bits of +inf (16-byte stores);
//   2. one thread per point: atomicMin on the int32 bit pattern of z;
//   3. finalize: +inf -> 0 (16-byte loads and stores).
// Non-negative IEEE floats order like their int32 bit patterns, so the
// integer min is the float min. This holds only for z >= +0.0: the caller
// (ops/raster.py::rasterize_min_depth) raises for min_depth < 0, and
// bin_points keeps only z > min_depth. Negative depths would need the
// sign-flip mapping (bits ^ 0x7fffffff for negatives) and are not accepted.
// min is order-free, so the result is deterministic and bit-identical to a
// sequential loop whatever order the atomics land in.
//
// Bound on the H100: bytes. The map is written by the fill, read and written
// by the finalize (3 x 4 B per pixel), and each point reads 8 B; at the
// serving shape (B=8, 450x800, P=640) the map's 11.5 MB dominates and the
// atomics touch at most B*P = 5120 words. The least traffic for the function
// is one write of the map plus one read of the points. Fusing fill and
// finalize away (a map kept in shared memory per tile, or an epoch-tagged
// buffer) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;
constexpr int kInfBits = 0x7f800000;  // +inf as int32

inline int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

__global__ void zb_fill(int* __restrict__ out, long long n) {
  const long long n4 = n >> 2;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int4 v = make_int4(kInfBits, kInfBits, kInfBits, kInfBits);
  int4* out4 = reinterpret_cast<int4*>(out);
  for (long long i = tid; i < n4; i += stride) out4[i] = v;
  const long long t = (n4 << 2) + tid;  // ragged tail, fewer than 4 words
  if (t < n) out[t] = kInfBits;
}

__global__ void zb_scatter(const int* __restrict__ lin, const float* __restrict__ z,
                           int* __restrict__ out, long long total, int points, int hw) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int l = lin[i];
    if (l >= 0 && l < hw) {
      const long long b = i / points;
      atomicMin(out + b * hw + l, __float_as_int(z[i]));
    }
  }
}

__device__ __forceinline__ int inf_to_zero(int v) { return v == kInfBits ? 0 : v; }

__global__ void zb_finalize(int* __restrict__ out, long long n) {
  const long long n4 = n >> 2;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  int4* out4 = reinterpret_cast<int4*>(out);
  for (long long i = tid; i < n4; i += stride) {
    int4 v = out4[i];
    v.x = inf_to_zero(v.x);
    v.y = inf_to_zero(v.y);
    v.z = inf_to_zero(v.z);
    v.w = inf_to_zero(v.w);
    out4[i] = v;
  }
  const long long t = (n4 << 2) + tid;
  if (t < n) out[t] = inf_to_zero(out[t]);
}

}  // namespace

// Returns cudaGetLastError() after the launches (0 = success). `out` must be
// 16-byte aligned (any torch allocation is).
extern "C" int rdt_zbuffer_min_depth(const void* lin, const void* z, void* out,
                                     int batch, int points, int hw, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* map = static_cast<int*>(out);
  const long long n = static_cast<long long>(batch) * hw;
  const long long total = static_cast<long long>(batch) * points;
  zb_fill<<<blocks_for(n >> 2), kThreads, 0, st>>>(map, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (total > 0) {
    zb_scatter<<<blocks_for(total), kThreads, 0, st>>>(
        static_cast<const int*>(lin), static_cast<const float*>(z), map, total, points, hw);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  zb_finalize<<<blocks_for(n >> 2), kThreads, 0, st>>>(map, n);
  return static_cast<int>(cudaGetLastError());
}
