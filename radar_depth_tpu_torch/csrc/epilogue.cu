// Kernel B: eval-mode BatchNorm epilogue, out = relu(x*scale[c] + bias[c] (+ residual)),
// CUDA C++ for sm_90a.
//
// Replaces radar_depth_tpu/ops/pallas_kernels.py::fused_scale_bias_relu
// (kernel bodies _scale_bias_relu_kernel and _scale_bias_add_relu_kernel):
// one templated kernel whose residual is a compile-time option, so the two
// TPU bodies are one kernel with two variants here.
//
// Layout: x, residual and out are NHWC in memory (a channels_last NCHW tensor
// or a contiguous (..., C) tensor), so the channel of element e is e % C.
// scale/bias are float32 (C,), the folded BN (gamma/sqrt(var+eps),
// beta - mean*scale). Types: float32 or bfloat16 in and out, float32 math.
//
// Bound on the H100: bytes. Three flops per element against 4 (bf16) to 12
// (fp32 + residual) bytes moved, far below the card's ~295 flop/byte ridge.
// The design therefore only makes the bytes cheap: each thread moves 16 bytes
// per load and store (8 bf16 or 4 fp32 lanes) when C is a multiple of the
// lane count and the pointers are 16-byte aligned, with a scalar pass for
// what is left. scale/bias are read through the read-only cache. Fusing the
// epilogue into the conv that feeds it, which would remove the read of x
// altogether, is later work.
//
// Rounding: the multiply and the adds are explicit round-to-nearest
// intrinsics (no fused multiply-add), in the order of the plain PyTorch
// version (x*scale, + bias, + residual), and bf16 is rounded once at the end,
// so the kernel gives the plain version's bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 65535;

inline int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

template <typename T, int V>
struct alignas(16) Pack {
  T v[V];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float& o) { o = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16& o) { o = __float2bfloat16_rn(v); }

template <bool HAS_RES>
__device__ __forceinline__ float epilogue(float x, float s, float b, float r) {
  float y = __fadd_rn(__fmul_rn(x, s), b);
  if (HAS_RES) y = __fadd_rn(y, r);
  return y < 0.f ? 0.f : y;  // NaN passes through, as in torch.relu
}

template <typename T, bool HAS_RES>
__global__ void sbr_vec(const T* __restrict__ x, const float* __restrict__ scale,
                        const float* __restrict__ bias, const T* __restrict__ res,
                        T* __restrict__ out, long long n_vec, int channels) {
  constexpr int V = 16 / sizeof(T);
  using P = Pack<T, V>;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_vec; i += stride) {
    const int c = static_cast<int>((i * V) % channels);  // C % V == 0: no wrap
    const P xv = reinterpret_cast<const P*>(x)[i];
    P rv;
    if (HAS_RES) rv = reinterpret_cast<const P*>(res)[i];
    P ov;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float r = HAS_RES ? to_float(rv.v[k]) : 0.f;
      from_float(epilogue<HAS_RES>(to_float(xv.v[k]), __ldg(scale + c + k),
                                   __ldg(bias + c + k), r),
                 ov.v[k]);
    }
    reinterpret_cast<P*>(out)[i] = ov;
  }
}

template <typename T, bool HAS_RES>
__global__ void sbr_scalar(const T* __restrict__ x, const float* __restrict__ scale,
                           const float* __restrict__ bias, const T* __restrict__ res,
                           T* __restrict__ out, long long start, long long n, int channels) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = start + static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int c = static_cast<int>(i % channels);
    const float r = HAS_RES ? to_float(res[i]) : 0.f;
    from_float(epilogue<HAS_RES>(to_float(x[i]), __ldg(scale + c), __ldg(bias + c), r), out[i]);
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, bool HAS_RES>
int launch(const void* x_, const float* scale, const float* bias, const void* res_,
           void* out_, long long n, int channels, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const T* x = static_cast<const T*>(x_);
  const T* res = static_cast<const T*>(res_);
  T* out = static_cast<T*>(out_);
  const bool vec = channels % V == 0 && aligned16(x) && aligned16(out) &&
                   (!HAS_RES || aligned16(res));
  const long long n_vec = vec ? n / V : 0;
  if (n_vec > 0) {
    sbr_vec<T, HAS_RES><<<blocks_for(n_vec), kThreads, 0, st>>>(x, scale, bias, res, out,
                                                                 n_vec, channels);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long start = n_vec * V;
  if (start < n) {
    sbr_scalar<T, HAS_RES><<<blocks_for(n - start), kThreads, 0, st>>>(
        x, scale, bias, res, out, start, n, channels);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_res(const void* x, const float* scale, const float* bias, const void* res,
                 void* out, long long n, int channels, cudaStream_t st) {
  return res ? launch<T, true>(x, scale, bias, res, out, n, channels, st)
             : launch<T, false>(x, scale, bias, res, out, n, channels, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. res may be NULL (no residual).
// Returns cudaGetLastError() after the launches (0 = success).
extern "C" int rdt_scale_bias_relu(const void* x, const void* scale, const void* bias,
                                   const void* res, void* out, long long n, int channels,
                                   int dtype, void* stream) {
  if (channels <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  switch (dtype) {
    case 0: return dispatch_res<float>(x, s, b, res, out, n, channels, st);
    case 1: return dispatch_res<__nv_bfloat16>(x, s, b, res, out, n, channels, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
