// Kernel B: eval-mode BatchNorm (+ residual) + ReLU over an NHWC tensor,
// CUDA C++ for sm_90a:
//   out = relu(x*s[c] + b[c] (+ residual)),
// where (s, b) is either given (the folded BN, rdt::scale_bias_relu) or, with
// FOLD, computed inside the kernel from the BN's own weight, bias,
// running_mean, running_var and eps (rdt::batch_norm_relu).
//
// Replaces radar_depth_tpu/ops/pallas_kernels.py::fused_scale_bias_relu
// (kernel bodies _scale_bias_relu_kernel and _scale_bias_add_relu_kernel):
// the residual is a compile-time option, so the two TPU bodies are variants of
// one kernel here. On the TPU the BN fold in front of it was free inside jit;
// in eager PyTorch it is five launches on (C,) vectors per site, so FOLD does
// it in the kernel's registers instead.
//
// Layout: x, residual and out are NHWC in memory (a channels_last NCHW tensor
// or a contiguous (..., C) tensor), so the channel of element e is e % C.
// Parameters are float32 (C,); x, residual and out float32 or bfloat16; the
// math is float32.
//
// Bound on the H100: bytes. Three flops per element against 4 (bf16) to 12
// (fp32 + residual) bytes moved, far below the card's ~295 flop/byte ridge.
// What the design does about it:
//   - 16-byte vectors (8 bf16 or 4 fp32 lanes) for every load and store of
//     x, residual and out, when C is a multiple of the lane count and every
//     pointer is 16-byte aligned; otherwise the same kernel with one lane,
//     in the same single launch;
//   - the channel group is fixed per thread: the grid-stride step is a whole
//     number of pixels, so each thread splits its index into (pixel, channel
//     group) once, in 32-bit math, and keeps its V scale and bias lanes in
//     registers, loaded (or folded) once as 16-byte packs. No division and no
//     parameter load per vector;
//   - 4 independent 16-byte loads in flight per thread (4 of x, or 2 of x and
//     2 of the residual) before any store;
//   - blocks of 256 threads, 4 resident per SM (<= 64 registers a thread),
//     and a grid of at most 16 such waves, each thread striding over the
//     rest with as many steps as every other, give or take one. Swept on
//     the card (scripts/torch_epilogue_sweep.py over the flagship's sites):
//     one wave read the 184 MB stem 9% slower, 8 loads in flight at 3
//     blocks per SM 1.5x slower, and 2 loads in flight no faster;
//   - programmatic dependent launch: the kernel is launched with programmatic
//     stream serialization, so its launch and index arithmetic overlap the
//     previous kernel's tail; it reads nothing before griddepcontrol.wait,
//     since the previous kernel (a cuDNN conv, or any op) may be writing x,
//     the residual or the parameters. It lets the next kernel launch early
//     (griddepcontrol.launch_dependents): such a kernel waits for this grid's
//     completion and memory before it reads.
//
// Rounding: the fold, the multiply and the adds are explicit round-to-nearest
// intrinsics (no fused multiply-add), in the order of the plain PyTorch
// version: s = w * rsqrt(var + eps), b = beta - mean*s, then x*s, + b,
// + residual; bf16 is rounded once at the end. rsqrtf is the function
// torch.rsqrt calls for float32 on the card, both built without fast math,
// so the kernel gives the plain version's bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;  // resident at <= 64 registers a thread
constexpr int kLoadsInFlight = 4;  // 16-byte loads per thread before a store
constexpr int kWaves = 16;  // the grid's cap, in waves of resident blocks
constexpr int kMaxDevices = 64;

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

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

struct Args {
  const void* x;
  const void* res;  // NULL without a residual
  void* out;
  // FOLD: weight, bias, running_mean, running_var; else scale, bias (p2, p3
  // unused)
  const float* p0;
  const float* p1;
  const float* p2;
  const float* p3;
  float eps;
  long long pixels;  // elements / channels
  int groups;        // channel groups of V lanes: channels / V
  int pix_stride;    // pixels per grid step: (grid threads / groups)
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float& o) { o = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16& o) { o = __float2bfloat16_rn(v); }

// V floats of p from channel c0 (a multiple of V): 16-byte packs when V is a
// multiple of 4 (the pointer is then 16-byte aligned, checked at launch).
template <int V>
__device__ __forceinline__ void load_lanes(const float* __restrict__ p, int c0, float (&o)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p + c0 + k));
      o[k] = f.x;
      o[k + 1] = f.y;
      o[k + 2] = f.z;
      o[k + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] = __ldg(p + c0 + k);
  }
}

template <typename T, int V, bool HAS_RES, bool FOLD>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) sbr_kernel(const Args a) {
  using P = Pack<T, V>;
  constexpr int U = HAS_RES ? kLoadsInFlight / 2 : kLoadsInFlight;  // pixels per step
  // index arithmetic only, before the wait
  const int tid = static_cast<int>(blockIdx.x) * kThreads + static_cast<int>(threadIdx.x);
  const int g = tid % a.groups;
  const long long first = tid / a.groups;
  const bool active = tid < a.pix_stride * a.groups;  // the grid's ragged rest idles
  const long long step = static_cast<long long>(U) * a.pix_stride;
  const P* __restrict__ x = static_cast<const P*>(a.x);
  const P* __restrict__ res = static_cast<const P*>(a.res);
  P* __restrict__ out = static_cast<P*>(a.out);
  // the previous kernel has completed and its stores are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;");
  if (!active) return;

  float s[V], b[V];
  const int c0 = g * V;
  if constexpr (FOLD) {
    float w[V], beta[V], mean[V], var[V];
    load_lanes<V>(a.p0, c0, w);
    load_lanes<V>(a.p1, c0, beta);
    load_lanes<V>(a.p2, c0, mean);
    load_lanes<V>(a.p3, c0, var);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      s[k] = __fmul_rn(w[k], rsqrtf(__fadd_rn(var[k], a.eps)));
      b[k] = __fsub_rn(beta[k], __fmul_rn(mean[k], s[k]));
    }
  } else {
    load_lanes<V>(a.p0, c0, s);
    load_lanes<V>(a.p1, c0, b);
  }

  for (long long q0 = first; q0 < a.pixels; q0 += step) {
    P xv[U], rv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long q = q0 + static_cast<long long>(u) * a.pix_stride;
      if (q < a.pixels) {
        const long long i = q * a.groups + g;
        xv[u] = x[i];
        if constexpr (HAS_RES) rv[u] = res[i];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long q = q0 + static_cast<long long>(u) * a.pix_stride;
      if (q < a.pixels) {
        P ov;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          float y = __fadd_rn(__fmul_rn(to_float(xv[u].v[k]), s[k]), b[k]);
          if constexpr (HAS_RES) y = __fadd_rn(y, to_float(rv[u].v[k]));
          from_float(y < 0.f ? 0.f : y, ov.v[k]);  // NaN passes, as torch.relu
        }
        out[q * a.groups + g] = ov;
      }
    }
  }
}

template <typename T, int V, bool HAS_RES, bool FOLD>
int launch(Args a, int sms, cudaStream_t st) {
  constexpr int U = HAS_RES ? kLoadsInFlight / 2 : kLoadsInFlight;
  const long long vectors = a.pixels * a.groups;
  const long long per_block = static_cast<long long>(kThreads) * U;  // vectors a step
  long long blocks = (vectors + per_block - 1) / per_block;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm * kWaves;
  if (blocks > cap) {  // as many steps for every thread, give or take one
    const long long steps = (blocks + cap - 1) / cap;
    blocks = (vectors + per_block * steps - 1) / (per_block * steps);
  }
  const long long least = (a.groups + kThreads - 1) / kThreads;  // a pixel a step
  if (blocks < least) blocks = least;
  a.pix_stride = static_cast<int>(blocks * kThreads / a.groups);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, sbr_kernel<T, V, HAS_RES, FOLD>, a));
}

template <typename T, int V>
int dispatch(const Args& a, int sms, cudaStream_t st) {
  const bool res = a.res != nullptr, fold = a.p2 != nullptr;
  if (res) {
    return fold ? launch<T, V, true, true>(a, sms, st) : launch<T, V, true, false>(a, sms, st);
  }
  return fold ? launch<T, V, false, true>(a, sms, st) : launch<T, V, false, false>(a, sms, st);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int dispatch_lanes(Args a, long long n, int channels, int sms, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = channels % V == 0 && aligned16(a.x) && aligned16(a.out) &&
                   (a.res == nullptr || aligned16(a.res)) && aligned16(a.p0) &&
                   aligned16(a.p1) && (a.p2 == nullptr || (aligned16(a.p2) && aligned16(a.p3)));
  a.pixels = n / channels;
  a.groups = vec ? channels / V : channels;
  return vec ? dispatch<T, V>(a, sms, st) : dispatch<T, 1>(a, sms, st);
}

}  // namespace

// One launch of kernel B on `stream`. x, res (NULL: no residual) and out hold
// n elements, NHWC with `channels` channels (n a multiple of it). With
// running_mean == NULL, p0 and p1 are the folded scale and bias; otherwise p0,
// p1, running_mean, running_var are the BN's weight, bias and running
// statistics, folded in the kernel with eps. dtype: 0 = float32, 1 = bfloat16.
// Returns the launch's CUDA error (0 = success).
extern "C" int rdt_scale_bias_relu(const void* x, const void* res, void* out, const void* p0,
                                   const void* p1, const void* running_mean,
                                   const void* running_var, float eps, long long n,
                                   int channels, int dtype, void* stream) {
  if (channels <= 0 || n % channels != 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((running_mean == nullptr) != (running_var == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const int sms = sm_count();
  if (sms <= 0) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidConfiguration);
  }
  Args a = {};
  a.x = x;
  a.res = res;
  a.out = out;
  a.p0 = static_cast<const float*>(p0);
  a.p1 = static_cast<const float*>(p1);
  a.p2 = static_cast<const float*>(running_mean);
  a.p3 = static_cast<const float*>(running_var);
  a.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_lanes<float>(a, n, channels, sms, st);
    case 1: return dispatch_lanes<__nv_bfloat16>(a, n, channels, sms, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
