// Kernel A: min-depth z-buffer for sparse projected points, CUDA C++ for sm_90a.
//
// Replaces radar_depth_tpu/ops/pallas_kernels.py::rasterize_min_depth_pallas
// (kernel body _raster_kernel). Same contract: lin (B, P) int32 linear pixel
// index v*W+u, or -1 for a dropped point; z (B, P) float32 depth; out
// (B, H*W) float32, the minimum depth of the points that hit each pixel and 0
// where none does.
//
// Bound on the H100: bytes. The least traffic is one write of the map plus
// one read of the points (8 B each); at the serving shape (B=8, 450x800,
// P=640) the map's 11.5 MB dominates (3.45 us at 3.35 TB/s) and the points
// touch at most B*P = 5120 words. So the map must be written once and never
// read back.
//
// Design. The TPU kernel compares every point with every pixel of a tile
// (P x TILE broadcast compares) because the TPU has no scatter; Hopper has
// native 32-bit atomics. Two launches on the caller's stream:
//   1. zero the map (16-byte stores): 4 B per pixel, the map's only full
//      pass. Plain stores, not streaming ones (__stcs): the map's lines stay
//      in the L2 for the atomics (3 us less at LiDAR density, L2-cold,
//      PERF.md). Its grid is one wave of 4 blocks per SM, which leaves room
//      for the scatter's blocks, and each block at once allows the next
//      kernel to launch (griddepcontrol.launch_dependents);
//   2. one thread per point, launched with programmatic stream serialization
//      (Hopper's programmatic dependent launch): it loads its point while
//      the fill runs, waits for the fill's completion and memory
//      (griddepcontrol.wait), then applies an atomicCAS loop on the int32
//      bits of z that treats the bits 0 as "empty" and replaces when the
//      pixel is empty or the new bits are smaller.
// So the scatter's launch and its loads overlap the fill instead of
// following it. (One cooperative launch with a grid-wide barrier between
// fill and scatter measured slower than two plain launches, PERF.md.)
// Non-negative IEEE floats order like their int32 bit patterns, so the
// integer min is the float min. This holds only for z >= +0.0: the caller
// (ops/raster.py::rasterize_min_depth) raises for min_depth < 0, and
// bin_points keeps only z > min_depth. A kept +0.0 has the bits of "empty",
// so it is stored as -0.0 (0x80000000, INT_MIN): the least int, it ends the
// CAS loop of its pixel, and it equals 0 as a float, though not bit for bit.
// min is order-free, so the result is deterministic whatever order the
// atomics land in.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFillBlocksPerSm = 4;  // of 8 that fit: the rest is the scatter's
constexpr int kMaxBlocks = 4096;
constexpr int kKeptZero = INT_MIN;  // -0.0f: a kept depth of +0.0
constexpr int kMaxDevices = 64;

inline int blocks_for(long long n, int cap) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return static_cast<int>(b < cap ? b : cap);
}

// SMs of the current device, cached per device; 0 on error.
int sm_count() {
  static int cache[kMaxDevices];
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices && cache[dev] > 0) return cache[dev];
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices) cache[dev] = sms;
  return sms;
}

__global__ void __launch_bounds__(kThreads) zb_zero(float* __restrict__ out, long long n) {
  asm volatile("griddepcontrol.launch_dependents;");
  const long long n4 = n >> 2;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float4* out4 = reinterpret_cast<float4*>(out);
  for (long long i = tid; i < n4; i += stride) out4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const long long t = (n4 << 2) + tid;  // ragged tail, fewer than 4 words
  if (t < n) out[t] = 0.f;
}

// Min of the depth bits v into *pixel, where 0 means "empty".
__device__ __forceinline__ void min_into(int* pixel, int v) {
  if (v == 0) v = kKeptZero;
  int assumed = 0;  // most pixels are hit once: try "empty" first
  int seen = atomicCAS(pixel, assumed, v);
  while (seen != assumed && (seen == 0 || v < seen)) {
    assumed = seen;
    seen = atomicCAS(pixel, assumed, v);
  }
}

__global__ void __launch_bounds__(kThreads)
zb_scatter(const int* __restrict__ lin, const float* __restrict__ z, int* __restrict__ out,
           long long total, int points, int hw) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  int l = -1, v = 0;
  if (tid < total) {
    l = lin[tid];
    v = __float_as_int(z[tid]);
  }
  // the zero fill has completed and its stores are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (l >= 0 && l < hw) min_into(out + (tid / points) * hw + l, v);
  for (long long i = tid + stride; i < total; i += stride) {
    const int li = lin[i];
    if (li >= 0 && li < hw) min_into(out + (i / points) * hw + li, __float_as_int(z[i]));
  }
}

}  // namespace

// Returns cudaGetLastError() after the launches (0 = success). `out` must be
// 16-byte aligned (any torch allocation is).
extern "C" int rdt_zbuffer_min_depth(const void* lin, const void* z, void* out,
                                     int batch, int points, int hw, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(batch) * hw;
  const long long total = static_cast<long long>(batch) * points;
  const int sms = sm_count();
  if (sms <= 0) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidConfiguration);
  }
  zb_zero<<<blocks_for(n >> 2, sms * kFillBlocksPerSm), kThreads, 0, st>>>(
      static_cast<float*>(out), n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || total == 0) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks_for(total, kMaxBlocks));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, zb_scatter, static_cast<const int*>(lin),
                                             static_cast<const float*>(z),
                                             static_cast<int*>(out), total, points, hw));
}
