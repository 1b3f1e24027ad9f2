// Kernel D: train-mode BatchNorm (+ residual) (+ ReLU) and its gradient over
// an NHWC tensor, CUDA C++ for sm_90a. Four entry points, each one call of a
// wrapper in ops/kernels.py:
//   rdt_bnt_stats       per-channel batch mean and biased variance (float32)
//                       over the N*H*W rows: a partial pass and a combine;
//   rdt_bnt_apply       y = relu?(T((x - mean)*(rsqrt(var + eps)*w) + b)
//                       (+ residual)), and the running statistics' update;
//   rdt_bnt_grad_stats  the per-channel sums of dy' and dy'*(x - mean)
//                       (dy' = dy masked by y > 0 under the ReLU) and from
//                       them d weight, d bias, d mean, d var; writes
//                       d residual = dy' on the way: a partial pass and a
//                       combine;
//   rdt_bnt_grad_input  dx = dy'*mul + (x - mean)*2 dvar/N + dmean/N, both
//                       gradients of x (through the apply and through the
//                       moments) in one pass.
//
// Replaces no TPU kernel: the JAX model's train-mode BN is flax's BatchNorm,
// which XLA fuses on the TPU. In eager PyTorch the same function under
// autograd was about 30 launches per call, most of them full float32 passes
// (x.float(), var_mean, x - mean, * mul, + bias, the cast, the residual add,
// the ReLU, and as many backward), and held most of a train step's device
// time.
//
// Layout: x, y, residual, dy and the gradients are NHWC in memory (a
// channels_last NCHW tensor), so the channel of element e is e % C; rows =
// N*H*W. x and its gradients are float32 or bfloat16; statistics, parameters
// and their gradients float32 (C,).
//
// Bound on the H100: bytes. A few flops per element against 2-4 bytes per
// element per tensor read or written, far below the card's ~295 flop/byte
// ridge. What the design does about it:
//   - every tensor is read or written as 16-byte vectors (8 bf16 or 4 fp32
//     channels) when C is a multiple of that lane count and every pointer is
//     16-byte aligned (the wrapper checks and passes `lanes`); otherwise one
//     lane, the same kernels;
//   - the two reducing passes run on a 2-D grid of (channel tiles) x (row
//     chunks): a block of 256 threads is TX vector columns by TY rows (TX a
//     power of two up to 32, TY = 256 / TX), so a block reads whole 16-byte
//     vectors of neighbouring channels of TY rows at once, and the chunks
//     give enough blocks for 132 SMs whether the site has 12,000 rows and 512
//     channels or 3 million rows and 16; each thread keeps 4 loads in flight;
//   - each reducing pass ends in a small combine kernel: 8 channels a block
//     (a 32-byte sector of each chunk's row of partials), 32 lanes folding
//     every 32nd chunk with 4 loads issued ahead of the folds, then a tree;
//   - the elementwise passes (apply, grad_input) use kernel B's scheme: a
//     1-D grid that strides a whole number of pixels, so each thread keeps
//     one channel group and its per-channel coefficients in registers (no
//     cap on registers: at 8 bf16 lanes the coefficients alone take 24-32);
//   - the forward reads x twice (statistics, apply) and writes y once; the
//     backward reads dy, y and x twice and writes dx (and d residual) once.
//
// Determinism: no float atomics. Each thread folds its rows in order
// (Welford), each block combines its threads by a fixed tree (Chan's
// formulas for (count, mean, M2)), and the combine kernel folds the chunks
// in a fixed order, so a shape gives the same bits on every run. The
// statistics and gradient sums may contract to fused multiply-adds and use
// the fast reciprocal: they are held to the plain version within float
// rounding, not bit for bit. The plan
// (TX, chunk rows, chunks) is a function of the shape and the SM count,
// computed by the wrapper (kernels.py::bn_reduce_plan).
//
// Rounding of the apply: separate round-to-nearest operations (no fused
// multiply-add) in the order of the plain version (kernels.py::
// bn_apply_reference): mul = rsqrtf(var + eps) * w, then x - mean, * mul,
// + bias, rounded to x's dtype; then + residual rounded in that dtype; then
// the ReLU. rsqrtf is what torch.rsqrt runs for float32 on the card (kernel
// B relies on the same), so given the same mean and var the output has the
// plain version's bits. The running update, m*running + (1-m)*batch, is
// done by block 0 with the same rounding as torch's (C,) ops.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;          // loads in flight per thread, reducing passes
constexpr int kCombineLanes = 32;   // combine kernels: chunk lanes per channel
constexpr int kBlocksPerSm = 4;     // elementwise passes: the grid's cap, in
constexpr int kWaves = 16;          // waves of kBlocksPerSm blocks per SM
constexpr int kMaxDevices = 64;

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

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float& o) { o = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16& o) { o = __float2bfloat16_rn(v); }

template <typename T>
__device__ __forceinline__ T zero_of() {
  T z;
  from_float(0.f, z);
  return z;
}

// torch.relu's value (NaN passes, -0 becomes +0) and its gradient mask
// (threshold_backward: 0 where y <= 0, so NaN passes the gradient)
__device__ __forceinline__ bool relu_kills(float y) { return y <= 0.f; }

// Chan's combine of (count, mean, M2) b into a, V lanes sharing the count.
template <int V>
__device__ __forceinline__ void chan_combine(float& na, float (&ma)[V], float (&qa)[V], float nb,
                                             const float* mb, const float* qb) {
  if (nb <= 0.f) return;
  const float n = na + nb;
  const float fb = __fdividef(nb, n);
  const float w = na * fb;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float d = mb[k] - ma[k];
    ma[k] = fmaf(d, fb, ma[k]);
    qa[k] = fmaf(d * d, w, qa[k] + qb[k]);
  }
  na = n;
}

// ------------------------------------------------------------ statistics

// Block (TX, TY) of grid (channel tiles, chunks): the (mean, M2) of chunk
// blockIdx.y's rows for its TX*V channels, into part[0][chunk][c] and
// part[1][chunk][c].
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) bnt_stats_part(const T* __restrict__ x,
                                                           float* __restrict__ part,
                                                           long long rows, int groups,
                                                           long long chunk_rows) {
  using P = Pack<T, V>;
  __shared__ float s_mean[kThreads * V];
  __shared__ float s_m2[kThreads * V];
  __shared__ float s_n[kThreads];
  const int tx = threadIdx.x, ty = threadIdx.y, TX = blockDim.x, TY = blockDim.y;
  const int g = blockIdx.x * TX + tx;
  const long long r0 = static_cast<long long>(blockIdx.y) * chunk_rows;
  const long long r1 = r0 + chunk_rows < rows ? r0 + chunk_rows : rows;
  float n = 0.f, mean[V], m2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) mean[k] = m2[k] = 0.f;
  if (g < groups) {
    const P* __restrict__ xp = reinterpret_cast<const P*>(x);
    for (long long r = r0 + ty; r < r1; r += static_cast<long long>(TY) * kUnroll) {
      P v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long q = r + static_cast<long long>(u) * TY;
        if (q < r1) v[u] = xp[q * groups + g];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + static_cast<long long>(u) * TY < r1) {
          n += 1.f;
          const float inv = __fdividef(1.f, n);  // one per row, all lanes
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float xv = to_float(v[u].v[k]);
            const float d = xv - mean[k];
            mean[k] = fmaf(d, inv, mean[k]);
            m2[k] = fmaf(d, xv - mean[k], m2[k]);
          }
        }
      }
    }
  }
  const int slot = ty * TX + tx;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    s_mean[slot * V + k] = mean[k];
    s_m2[slot * V + k] = m2[k];
  }
  s_n[slot] = n;
  for (int s = TY / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (ty < s) {
      const int o = (ty + s) * TX + tx;
      chan_combine<V>(n, mean, m2, s_n[o], s_mean + o * V, s_m2 + o * V);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        s_mean[slot * V + k] = mean[k];
        s_m2[slot * V + k] = m2[k];
      }
      s_n[slot] = n;
    }
  }
  if (ty == 0 && g < groups) {
    const long long c = static_cast<long long>(groups) * V;
    float* pm = part + static_cast<long long>(blockIdx.y) * c + static_cast<long long>(g) * V;
    float* pq = pm + static_cast<long long>(gridDim.y) * c;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      pm[k] = mean[k];
      pq[k] = m2[k];
    }
  }
}

// Block (CX, LY): channel blockIdx.x*CX + threadIdx.x; lane threadIdx.y folds
// chunks lane, lane+LY, ... in order, then a fixed tree over the lanes.
__global__ void __launch_bounds__(kThreads) bnt_stats_combine(const float* __restrict__ part,
                                                              float* __restrict__ mean,
                                                              float* __restrict__ var,
                                                              long long rows, int channels,
                                                              int chunks, long long chunk_rows) {
  __shared__ float s_m[kThreads], s_q[kThreads], s_n[kThreads];
  const int cx = threadIdx.x, ly = threadIdx.y, CX = blockDim.x, LY = blockDim.y;
  const int c = blockIdx.x * CX + cx;
  float n = 0.f, m[1] = {0.f}, q[1] = {0.f};
  if (c < channels) {
    const long long stride = static_cast<long long>(chunks) * channels;
    for (int k0 = ly; k0 < chunks; k0 += LY * kUnroll) {
      float mb[kUnroll], qb[kUnroll];  // the loads first, then the folds
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + u * LY;
        if (k < chunks) {
          mb[u] = part[static_cast<long long>(k) * channels + c];
          qb[u] = part[stride + static_cast<long long>(k) * channels + c];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + u * LY;
        if (k < chunks) {
          const long long left = rows - static_cast<long long>(k) * chunk_rows;
          const float nb = static_cast<float>(left < chunk_rows ? left : chunk_rows);
          chan_combine<1>(n, m, q, nb, mb + u, qb + u);
        }
      }
    }
  }
  const int slot = ly * CX + cx;
  s_m[slot] = m[0];
  s_q[slot] = q[0];
  s_n[slot] = n;
  for (int s = LY / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (ly < s) {
      const int o = (ly + s) * CX + cx;
      chan_combine<1>(n, m, q, s_n[o], s_m + o, s_q + o);
      s_m[slot] = m[0];
      s_q[slot] = q[0];
      s_n[slot] = n;
    }
  }
  if (ly == 0 && c < channels) {
    mean[c] = m[0];
    var[c] = __fdiv_rn(q[0], static_cast<float>(rows));
  }
}

// ------------------------------------------------------------ gradient sums

template <typename T, int V, bool RELU, bool HAS_RES>
__global__ void __launch_bounds__(kThreads) bnt_grad_part(const T* __restrict__ dy,
                                                          const T* __restrict__ y,
                                                          const T* __restrict__ x,
                                                          T* __restrict__ dres,
                                                          const float* __restrict__ mean,
                                                          float* __restrict__ part,
                                                          long long rows, int groups,
                                                          long long chunk_rows) {
  using P = Pack<T, V>;
  constexpr int U = kUnroll / 2;  // two or three loads per row
  __shared__ float s_a[kThreads * V];
  __shared__ float s_b[kThreads * V];
  const int tx = threadIdx.x, ty = threadIdx.y, TX = blockDim.x, TY = blockDim.y;
  const int g = blockIdx.x * TX + tx;
  const long long r0 = static_cast<long long>(blockIdx.y) * chunk_rows;
  const long long r1 = r0 + chunk_rows < rows ? r0 + chunk_rows : rows;
  float s1[V], s2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s1[k] = s2[k] = 0.f;
  if (g < groups) {
    float mu[V];
#pragma unroll
    for (int k = 0; k < V; ++k) mu[k] = __ldg(mean + g * V + k);
    const P* __restrict__ dyp = reinterpret_cast<const P*>(dy);
    const P* __restrict__ yp = reinterpret_cast<const P*>(y);
    const P* __restrict__ xp = reinterpret_cast<const P*>(x);
    P* __restrict__ dp = reinterpret_cast<P*>(dres);
    for (long long r = r0 + ty; r < r1; r += static_cast<long long>(TY) * U) {
      P dv[U], yv[U], xv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long q = r + static_cast<long long>(u) * TY;
        if (q < r1) {
          const long long i = q * groups + g;
          dv[u] = dyp[i];
          if constexpr (RELU) yv[u] = yp[i];
          xv[u] = xp[i];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long q = r + static_cast<long long>(u) * TY;
        if (q < r1) {
          if constexpr (RELU) {
#pragma unroll
            for (int k = 0; k < V; ++k) {
              if (relu_kills(to_float(yv[u].v[k]))) dv[u].v[k] = zero_of<T>();
            }
          }
          if constexpr (HAS_RES) dp[q * groups + g] = dv[u];
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float da = to_float(dv[u].v[k]);
            s1[k] += da;
            s2[k] = fmaf(da, to_float(xv[u].v[k]) - mu[k], s2[k]);
          }
        }
      }
    }
  }
  const int slot = ty * TX + tx;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    s_a[slot * V + k] = s1[k];
    s_b[slot * V + k] = s2[k];
  }
  for (int s = TY / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (ty < s) {
      const int o = (ty + s) * TX + tx;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        s1[k] += s_a[o * V + k];
        s2[k] += s_b[o * V + k];
        s_a[slot * V + k] = s1[k];
        s_b[slot * V + k] = s2[k];
      }
    }
  }
  if (ty == 0 && g < groups) {
    const long long c = static_cast<long long>(groups) * V;
    float* pa = part + static_cast<long long>(blockIdx.y) * c + static_cast<long long>(g) * V;
    float* pb = pa + static_cast<long long>(gridDim.y) * c;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      pa[k] = s1[k];
      pb[k] = s2[k];
    }
  }
}

// Sums the chunks (a fixed order, as bnt_stats_combine), then per channel:
// r = rsqrt(var + eps), dbias = S1, dweight = S2*r,
// dvar = S2*w*(-0.5)*r^3, dmean = -(r*w)*S1.
__global__ void __launch_bounds__(kThreads) bnt_grad_combine(
    const float* __restrict__ part, const float* __restrict__ var, const float* __restrict__ weight,
    float eps, float* __restrict__ dweight, float* __restrict__ dbias, float* __restrict__ dmean,
    float* __restrict__ dvar, int channels, int chunks) {
  __shared__ float s_a[kThreads], s_b[kThreads];
  const int cx = threadIdx.x, ly = threadIdx.y, CX = blockDim.x, LY = blockDim.y;
  const int c = blockIdx.x * CX + cx;
  float a = 0.f, b = 0.f;
  if (c < channels) {
    const long long stride = static_cast<long long>(chunks) * channels;
    for (int k0 = ly; k0 < chunks; k0 += LY * kUnroll) {
      float pa[kUnroll], pb[kUnroll];  // the loads first, then the sums
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + u * LY;
        pa[u] = k < chunks ? part[static_cast<long long>(k) * channels + c] : 0.f;
        pb[u] = k < chunks ? part[stride + static_cast<long long>(k) * channels + c] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        a += pa[u];
        b += pb[u];
      }
    }
  }
  const int slot = ly * CX + cx;
  s_a[slot] = a;
  s_b[slot] = b;
  for (int s = LY / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (ly < s) {
      const int o = (ly + s) * CX + cx;
      a += s_a[o];
      b += s_b[o];
      s_a[slot] = a;
      s_b[slot] = b;
    }
  }
  if (ly == 0 && c < channels) {
    const float r = rsqrtf(__fadd_rn(var[c], eps));
    const float w = weight[c];
    dbias[c] = a;
    dweight[c] = __fmul_rn(b, r);
    dvar[c] = __fmul_rn(__fmul_rn(__fmul_rn(b, w), -0.5f), __fmul_rn(__fmul_rn(r, r), r));
    dmean[c] = -__fmul_rn(__fmul_rn(r, w), a);
  }
}

// ------------------------------------------------------------ elementwise

struct Elem {
  const void* x;
  const void* res;   // apply: the residual (NULL: none)
  const void* dy;    // grad_input: NULL without the apply's part
  const void* y;     // grad_input under the ReLU: the forward's output
  void* out;         // apply: y; grad_input: dx
  const float* mean;
  const float* var;
  const float* weight;
  const float* bias;   // apply
  const float* dmean;  // grad_input: NULL without the moments' part
  const float* dvar;
  float* run_mean;     // apply: NULL, no running update
  float* run_var;
  float eps, keep, fresh, rows_f;
  long long pixels;  // rows
  int channels;
  int groups;      // channels / V
  int pix_stride;  // pixels per grid step
};

template <int V>
__device__ __forceinline__ void lanes_of(const float* __restrict__ p, int c0, float (&o)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) o[k] = __ldg(p + c0 + k);
}

template <typename T, int V, bool HAS_RES, bool RELU>
__global__ void __launch_bounds__(kThreads) bnt_apply(const Elem a) {
  using P = Pack<T, V>;
  constexpr int U = HAS_RES ? 2 : 4;
  if (blockIdx.x == 0 && a.run_mean != nullptr) {
    for (int c = threadIdx.x; c < a.channels; c += kThreads) {
      a.run_mean[c] = __fadd_rn(__fmul_rn(a.keep, a.run_mean[c]), __fmul_rn(a.fresh, a.mean[c]));
      a.run_var[c] = __fadd_rn(__fmul_rn(a.keep, a.run_var[c]), __fmul_rn(a.fresh, a.var[c]));
    }
  }
  const int tid = static_cast<int>(blockIdx.x) * kThreads + static_cast<int>(threadIdx.x);
  if (tid >= a.pix_stride * a.groups) return;
  const int g = tid % a.groups;
  const int c0 = g * V;
  float mu[V], mul[V], beta[V];
  lanes_of<V>(a.mean, c0, mu);
  lanes_of<V>(a.var, c0, mul);
  lanes_of<V>(a.bias, c0, beta);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    mul[k] = __fmul_rn(rsqrtf(__fadd_rn(mul[k], a.eps)), __ldg(a.weight + c0 + k));
  }
  const P* __restrict__ x = static_cast<const P*>(a.x);
  const P* __restrict__ res = static_cast<const P*>(a.res);
  P* __restrict__ out = static_cast<P*>(a.out);
  const long long step = static_cast<long long>(U) * a.pix_stride;
  for (long long q0 = tid / a.groups; q0 < a.pixels; q0 += step) {
    P xv[U], rv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long q = q0 + static_cast<long long>(u) * a.pix_stride;
      if (q < a.pixels) {
        xv[u] = x[q * a.groups + g];
        if constexpr (HAS_RES) rv[u] = res[q * a.groups + g];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long q = q0 + static_cast<long long>(u) * a.pix_stride;
      if (q < a.pixels) {
        P ov;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float v = __fadd_rn(__fmul_rn(__fsub_rn(to_float(xv[u].v[k]), mu[k]), mul[k]),
                                    beta[k]);
          T t;
          from_float(v, t);  // rounded to x's dtype before the residual
          if constexpr (HAS_RES) from_float(__fadd_rn(to_float(t), to_float(rv[u].v[k])), t);
          if constexpr (RELU) {
            if (relu_kills(to_float(t))) t = zero_of<T>();
          }
          ov.v[k] = t;
        }
        out[q * a.groups + g] = ov;
      }
    }
  }
}

template <typename T, int V, bool HAS_DY, bool RELU, bool HAS_MOM>
__global__ void __launch_bounds__(kThreads) bnt_grad_input(const Elem a) {
  using P = Pack<T, V>;
  constexpr int U = 2;
  const int tid = static_cast<int>(blockIdx.x) * kThreads + static_cast<int>(threadIdx.x);
  if (tid >= a.pix_stride * a.groups) return;
  const int g = tid % a.groups;
  const int c0 = g * V;
  float mul[V], mu[V], k1[V], k2[V];
  if constexpr (HAS_DY) {
    lanes_of<V>(a.var, c0, mul);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      mul[k] = __fmul_rn(rsqrtf(__fadd_rn(mul[k], a.eps)), __ldg(a.weight + c0 + k));
    }
  }
  if constexpr (HAS_MOM) {
    lanes_of<V>(a.mean, c0, mu);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      k1[k] = __fdiv_rn(__ldg(a.dmean + c0 + k), a.rows_f);
      k2[k] = __fdiv_rn(__fmul_rn(2.f, __ldg(a.dvar + c0 + k)), a.rows_f);
    }
  }
  const P* __restrict__ dy = static_cast<const P*>(a.dy);
  const P* __restrict__ y = static_cast<const P*>(a.y);
  const P* __restrict__ x = static_cast<const P*>(a.x);
  P* __restrict__ out = static_cast<P*>(a.out);
  const long long step = static_cast<long long>(U) * a.pix_stride;
  for (long long q0 = tid / a.groups; q0 < a.pixels; q0 += step) {
    P dv[U], yv[U], xv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long q = q0 + static_cast<long long>(u) * a.pix_stride;
      if (q < a.pixels) {
        const long long i = q * a.groups + g;
        if constexpr (HAS_DY) dv[u] = dy[i];
        if constexpr (HAS_DY && RELU) yv[u] = y[i];
        if constexpr (HAS_MOM) xv[u] = x[i];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long q = q0 + static_cast<long long>(u) * a.pix_stride;
      if (q < a.pixels) {
        P ov;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          float gx = 0.f;
          if constexpr (HAS_DY) {
            float da = to_float(dv[u].v[k]);
            if constexpr (RELU) {
              if (relu_kills(to_float(yv[u].v[k]))) da = 0.f;
            }
            gx = __fmul_rn(da, mul[k]);
          }
          if constexpr (HAS_MOM) {
            const float m = __fadd_rn(__fmul_rn(__fsub_rn(to_float(xv[u].v[k]), mu[k]), k2[k]), k1[k]);
            gx = HAS_DY ? __fadd_rn(gx, m) : m;
          }
          from_float(gx, ov.v[k]);
        }
        out[q * a.groups + g] = ov;
      }
    }
  }
}

// The elementwise passes' 1-D grid (kernel B's scheme): at most kWaves waves
// of resident blocks, every thread striding a whole number of pixels.
void plan_1d(Elem& a, int pixels_per_step, int sms, unsigned& blocks_out) {
  const long long vectors = a.pixels * a.groups;
  const long long per_block = static_cast<long long>(kThreads) * pixels_per_step;
  long long blocks = (vectors + per_block - 1) / per_block;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm * kWaves;
  if (blocks > cap) {
    const long long steps = (blocks + cap - 1) / cap;
    blocks = (vectors + per_block * steps - 1) / (per_block * steps);
  }
  const long long least = (a.groups + kThreads - 1) / kThreads;
  if (blocks < least) blocks = least;
  a.pix_stride = static_cast<int>(blocks * kThreads / a.groups);
  blocks_out = static_cast<unsigned>(blocks);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// lanes: 1, or 16 / sizeof(T) with C a multiple of it and the given pointers
// 16-byte aligned.
bool lanes_ok(int lanes, int dtype, int channels, std::initializer_list<const void*> ptrs) {
  if (lanes == 1) return true;
  const int v = dtype == 0 ? 4 : 8;
  if (lanes != v || channels % v != 0) return false;
  for (const void* p : ptrs) {
    if (p != nullptr && !aligned16(p)) return false;
  }
  return true;
}

bool plan_ok(int tx, long long chunk_rows, int chunks, long long rows) {
  if (tx <= 0 || tx > 32 || (tx & (tx - 1)) != 0 || chunk_rows <= 0 || chunks <= 0) return false;
  return chunks <= 65535 && (chunks - 1) * chunk_rows < rows && chunks * chunk_rows >= rows;
}

int last_error(cudaError_t fallback) {
  const cudaError_t err = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : fallback);
}

// the combine kernels' block: CX channels (8 x 4 bytes: a 32-byte sector per
// chunk row) by kCombineLanes chunk lanes
dim3 combine_block() { return dim3(kThreads / kCombineLanes, kCombineLanes); }

template <typename T, int V>
int stats(const void* x, float* part, float* mean, float* var, long long rows, int channels,
          int tx, long long chunk_rows, int chunks, cudaStream_t st) {
  const int groups = channels / V;
  const dim3 block(tx, kThreads / tx);
  const dim3 grid((groups + tx - 1) / tx, chunks);
  bnt_stats_part<T, V><<<grid, block, 0, st>>>(static_cast<const T*>(x), part, rows, groups,
                                               chunk_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 cb = combine_block();
  bnt_stats_combine<<<(channels + cb.x - 1) / cb.x, cb, 0, st>>>(part, mean, var, rows, channels,
                                                                 chunks, chunk_rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V, bool RELU, bool HAS_RES>
int grad_part(const void* dy, const void* y, const void* x, void* dres, const float* mean,
              float* part, long long rows, int groups, int tx, long long chunk_rows, int chunks,
              cudaStream_t st) {
  const dim3 block(tx, kThreads / tx);
  const dim3 grid((groups + tx - 1) / tx, chunks);
  bnt_grad_part<T, V, RELU, HAS_RES><<<grid, block, 0, st>>>(
      static_cast<const T*>(dy), static_cast<const T*>(y), static_cast<const T*>(x),
      static_cast<T*>(dres), mean, part, rows, groups, chunk_rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int grad_part_variant(bool relu, const void* dy, const void* y, const void* x, void* dres,
                      const float* mean, float* part, long long rows, int groups, int tx,
                      long long chunk_rows, int chunks, cudaStream_t st) {
  if (dres != nullptr) {
    return relu ? grad_part<T, V, true, true>(dy, y, x, dres, mean, part, rows, groups, tx,
                                              chunk_rows, chunks, st)
                : grad_part<T, V, false, true>(dy, y, x, dres, mean, part, rows, groups, tx,
                                               chunk_rows, chunks, st);
  }
  return relu ? grad_part<T, V, true, false>(dy, y, x, dres, mean, part, rows, groups, tx,
                                             chunk_rows, chunks, st)
              : grad_part<T, V, false, false>(dy, y, x, dres, mean, part, rows, groups, tx,
                                              chunk_rows, chunks, st);
}

template <typename T, int V, bool HAS_RES, bool RELU>
int apply_launch(Elem a, int sms, cudaStream_t st) {
  unsigned blocks = 0;
  plan_1d(a, HAS_RES ? 2 : 4, sms, blocks);
  bnt_apply<T, V, HAS_RES, RELU><<<blocks, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int apply_variant(const Elem& a, bool relu, int sms, cudaStream_t st) {
  if (a.res != nullptr) {
    return relu ? apply_launch<T, V, true, true>(a, sms, st)
                : apply_launch<T, V, true, false>(a, sms, st);
  }
  return relu ? apply_launch<T, V, false, true>(a, sms, st)
              : apply_launch<T, V, false, false>(a, sms, st);
}

template <typename T, int V, bool HAS_DY, bool RELU, bool HAS_MOM>
int grad_input_launch(Elem a, int sms, cudaStream_t st) {
  unsigned blocks = 0;
  plan_1d(a, 2, sms, blocks);
  bnt_grad_input<T, V, HAS_DY, RELU, HAS_MOM><<<blocks, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int grad_input_variant(const Elem& a, bool relu, int sms, cudaStream_t st) {
  const bool dy = a.dy != nullptr, mom = a.dmean != nullptr;
  if (dy && mom) {
    return relu ? grad_input_launch<T, V, true, true, true>(a, sms, st)
                : grad_input_launch<T, V, true, false, true>(a, sms, st);
  }
  if (dy) {
    return relu ? grad_input_launch<T, V, true, true, false>(a, sms, st)
                : grad_input_launch<T, V, true, false, false>(a, sms, st);
  }
  return grad_input_launch<T, V, false, false, true>(a, sms, st);
}

}  // namespace

// Statistics of x (rows x channels, NHWC): part holds 2*chunks*channels
// floats of scratch; mean and var (channels,) float32 out. The plan (tx,
// chunk_rows, chunks) is kernels.py::bn_reduce_plan's. dtype: 0 = float32,
// 1 = bfloat16; lanes: 1 or 16 bytes' worth. Returns the CUDA error (0 = ok).
extern "C" int rdt_bnt_stats(const void* x, void* part, void* mean, void* var, long long rows,
                             int channels, int dtype, int lanes, int tx, long long chunk_rows,
                             int chunks, void* stream) {
  if (channels <= 0 || rows <= 0 || dtype < 0 || dtype > 1) return cudaErrorInvalidValue;
  if (!lanes_ok(lanes, dtype, channels, {x})) return cudaErrorInvalidValue;
  if (!plan_ok(tx, chunk_rows, chunks, rows)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* m = static_cast<float*>(mean);
  float* v = static_cast<float*>(var);
  if (dtype == 0) {
    return lanes == 1 ? stats<float, 1>(x, p, m, v, rows, channels, tx, chunk_rows, chunks, st)
                      : stats<float, 4>(x, p, m, v, rows, channels, tx, chunk_rows, chunks, st);
  }
  return lanes == 1
             ? stats<__nv_bfloat16, 1>(x, p, m, v, rows, channels, tx, chunk_rows, chunks, st)
             : stats<__nv_bfloat16, 8>(x, p, m, v, rows, channels, tx, chunk_rows, chunks, st);
}

// y = relu?(T((x - mean)*(rsqrt(var + eps)*weight) + bias) (+ res)); with
// run_mean != NULL also run = keep*run + fresh*batch for the running mean and
// variance. res may be NULL.
extern "C" int rdt_bnt_apply(const void* x, const void* res, void* out, const void* mean,
                             const void* var, const void* weight, const void* bias,
                             void* run_mean, void* run_var, float eps, float keep, float fresh,
                             long long rows, int channels, int dtype, int lanes, int relu,
                             void* stream) {
  if (channels <= 0 || rows <= 0 || dtype < 0 || dtype > 1) return cudaErrorInvalidValue;
  if ((run_mean == nullptr) != (run_var == nullptr)) return cudaErrorInvalidValue;
  if (!lanes_ok(lanes, dtype, channels, {x, res, out})) return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return last_error(cudaErrorInvalidConfiguration);
  Elem a = {};
  a.x = x;
  a.res = res;
  a.out = out;
  a.mean = static_cast<const float*>(mean);
  a.var = static_cast<const float*>(var);
  a.weight = static_cast<const float*>(weight);
  a.bias = static_cast<const float*>(bias);
  a.run_mean = static_cast<float*>(run_mean);
  a.run_var = static_cast<float*>(run_var);
  a.eps = eps;
  a.keep = keep;
  a.fresh = fresh;
  a.pixels = rows;
  a.channels = channels;
  a.groups = channels / lanes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return lanes == 1 ? apply_variant<float, 1>(a, relu != 0, sms, st)
                      : apply_variant<float, 4>(a, relu != 0, sms, st);
  }
  return lanes == 1 ? apply_variant<__nv_bfloat16, 1>(a, relu != 0, sms, st)
                    : apply_variant<__nv_bfloat16, 8>(a, relu != 0, sms, st);
}

// The apply's gradient sums over (dy, y, x) with mean the apply's: dweight,
// dbias, dmean, dvar (channels,) float32 out; dres (NULL: no residual) gets
// dy' = dy masked by y > 0 (relu) in x's dtype. y may be NULL without relu.
// part: 2*chunks*channels floats of scratch; the plan as rdt_bnt_stats's.
extern "C" int rdt_bnt_grad_stats(const void* dy, const void* y, const void* x, void* dres,
                                  const void* mean, const void* var, const void* weight,
                                  float eps, void* part, void* dweight, void* dbias, void* dmean,
                                  void* dvar, long long rows, int channels, int dtype, int lanes,
                                  int relu, int tx, long long chunk_rows, int chunks,
                                  void* stream) {
  if (channels <= 0 || rows <= 0 || dtype < 0 || dtype > 1) return cudaErrorInvalidValue;
  if (relu && y == nullptr) return cudaErrorInvalidValue;
  if (!lanes_ok(lanes, dtype, channels, {dy, y, x, dres})) return cudaErrorInvalidValue;
  const int groups = channels / lanes;
  if (!plan_ok(tx, chunk_rows, chunks, rows)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* mu = static_cast<const float*>(mean);
  float* p = static_cast<float*>(part);
  int err;
  if (dtype == 0) {
    err = lanes == 1 ? grad_part_variant<float, 1>(relu != 0, dy, y, x, dres, mu, p, rows, groups,
                                                   tx, chunk_rows, chunks, st)
                     : grad_part_variant<float, 4>(relu != 0, dy, y, x, dres, mu, p, rows, groups,
                                                   tx, chunk_rows, chunks, st);
  } else {
    err = lanes == 1 ? grad_part_variant<__nv_bfloat16, 1>(relu != 0, dy, y, x, dres, mu, p, rows,
                                                           groups, tx, chunk_rows, chunks, st)
                     : grad_part_variant<__nv_bfloat16, 8>(relu != 0, dy, y, x, dres, mu, p, rows,
                                                           groups, tx, chunk_rows, chunks, st);
  }
  if (err != 0) return err;
  const dim3 cb = combine_block();
  bnt_grad_combine<<<(channels + cb.x - 1) / cb.x, cb, 0, st>>>(
      p, static_cast<const float*>(var), static_cast<const float*>(weight), eps,
      static_cast<float*>(dweight), static_cast<float*>(dbias), static_cast<float*>(dmean),
      static_cast<float*>(dvar), channels, chunks);
  return static_cast<int>(cudaGetLastError());
}

// dx = dy'*(rsqrt(var + eps)*weight) + (x - mean)*(2*dvar/rows) + dmean/rows,
// in x's dtype: the apply's part when dy != NULL (var and weight the apply's,
// y its output under relu), the moments' part when dmean != NULL (mean the
// moments' own, dmean and dvar their upstream gradients).
extern "C" int rdt_bnt_grad_input(const void* dy, const void* y, const void* x, void* dx,
                                  const void* mean, const void* var, const void* weight,
                                  float eps, const void* dmean, const void* dvar, long long rows,
                                  int channels, int dtype, int lanes, int relu, void* stream) {
  if (channels <= 0 || rows <= 0 || dtype < 0 || dtype > 1) return cudaErrorInvalidValue;
  if (dy == nullptr && dmean == nullptr) return cudaErrorInvalidValue;
  if ((dmean == nullptr) != (dvar == nullptr)) return cudaErrorInvalidValue;
  if (dy != nullptr && relu && y == nullptr) return cudaErrorInvalidValue;
  if (!lanes_ok(lanes, dtype, channels, {dy, y, x, dx})) return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return last_error(cudaErrorInvalidConfiguration);
  Elem a = {};
  a.x = x;
  a.dy = dy;
  a.y = y;
  a.out = dx;
  a.mean = static_cast<const float*>(mean);
  a.var = static_cast<const float*>(var);
  a.weight = static_cast<const float*>(weight);
  a.dmean = static_cast<const float*>(dmean);
  a.dvar = static_cast<const float*>(dvar);
  a.eps = eps;
  a.rows_f = static_cast<float>(rows);
  a.pixels = rows;
  a.channels = channels;
  a.groups = channels / lanes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return lanes == 1 ? grad_input_variant<float, 1>(a, relu != 0, sms, st)
                      : grad_input_variant<float, 4>(a, relu != 0, sms, st);
  }
  return lanes == 1 ? grad_input_variant<__nv_bfloat16, 1>(a, relu != 0, sms, st)
                    : grad_input_variant<__nv_bfloat16, 8>(a, relu != 0, sms, st);
}
