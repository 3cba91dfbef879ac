// Row LayerNorm and RMSNorm forwards for Hopper (sm_90a).
//
// norm_fwd<false, ...> replaces the TPU kernel
// paddle_tpu/ops/pallas/norms.py::_ln_kernel (launched by _pallas_norm
// through layer_norm).  Same arithmetic: the row mean and the two-pass
// variance mean((x - mu)^2) in fp32, y = (x - mu) * rsqrt(var + eps), the
// affine y * g + b in fp32, one cast back to x's type.
//
// norm_fwd<true, ...> replaces _rms_kernel (launched by _pallas_norm
// through rms_norm): the row mean of x^2 in fp32, y = x * rsqrt(ms + eps) *
// g in fp32, one cast back to x's type; g is float32 or bfloat16 whatever x
// is.
//
// Bound: bytes.  Each kernel reads each element of x once and writes each
// element of y once (2 * rows * H * itemsize, plus g and b); it does under
// 10 flops per element, far below the H100's ~20 flops per byte of HBM rate.
// Design for that bound: the row is read from device memory exactly once,
// with 16-byte vector loads, and held in registers for the reduction and
// normalise passes; both norms share one kernel template and one launch
// geometry.  One warp owns a row when the row fits in 32 lanes x 8 vectors
// (H <= 2048 for bf16, <= 1024 for fp32; four such rows per 128-thread
// block); wider rows take several warps of one block, joined by a
// shared-memory sum.  Reductions are warp shuffles.  Both norms take any
// H >= 1: rows that are not 16-byte aligned (H not a multiple of 16 /
// itemsize, or a pointer off 16 bytes) take one-element loads, and rows
// wider than 32 warps x 8 loads are read again from L2 for each pass
// (LayerNorm three times, RMSNorm twice) instead of held in registers.
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/cuda/norms.py);
// dtype codes: 0 = float32, 1 = bfloat16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

// N elements of T at p (aligned to the chunk size) -> N floats, in 16- or
// 8-byte chunks, or one element at a time.
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* __restrict__ p,
                                       float (&out)[N]) {
  constexpr int BYTES = N * (int)sizeof(T);
  if constexpr (BYTES % 16 == 0) {
    constexpr int PER = 16 / (int)sizeof(T);
#pragma unroll
    for (int c = 0; c < N / PER; ++c) {
      uint4 raw = __ldg(reinterpret_cast<const uint4*>(p) + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < PER; ++k) out[c * PER + k] = to_f(e[k]);
    }
  } else if constexpr (BYTES % 8 == 0) {
    constexpr int PER = 8 / (int)sizeof(T);
#pragma unroll
    for (int c = 0; c < N / PER; ++c) {
      uint2 raw = __ldg(reinterpret_cast<const uint2*>(p) + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < PER; ++k) out[c * PER + k] = to_f(e[k]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = to_f(p[k]);
  }
}

// N floats -> N elements of T at p, in 16-byte chunks or one at a time.
template <typename T, int N>
__device__ __forceinline__ void store_f(T* __restrict__ p,
                                        const float (&v)[N]) {
  if constexpr ((N * (int)sizeof(T)) % 16 == 0) {
    constexpr int PER = 16 / (int)sizeof(T);
#pragma unroll
    for (int c = 0; c < N / PER; ++c) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int k = 0; k < PER; ++k) e[k] = from_f<T>(v[c * PER + k]);
      reinterpret_cast<uint4*>(p)[c] = raw;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) p[k] = from_f<T>(v[k]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the threads of one row.  With one warp per row (blockDim.x ==
// 32) it is a shuffle; otherwise the block holds one row and the warps'
// partials meet in shared memory.  Every thread of the row gets the sum.
__device__ __forceinline__ float row_sum(float v, float* sm) {
  v = warp_sum(v);
  if (blockDim.x == 32) return v;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  __syncthreads();  // the previous call's readers are done with sm
  if (lane == 0) sm[wid] = v;
  __syncthreads();
  return warp_sum(lane < nw ? sm[lane] : 0.f);
}

// Store the V outputs of load li of row yr from its V inputs v, the row's
// mean mu (LayerNorm only) and its reciprocal norm r.
template <bool RMS, typename T, typename W, int V>
__device__ __forceinline__ void norm_store(T* __restrict__ yr,
                                           const W* __restrict__ g,
                                           const W* __restrict__ b, int li,
                                           const float (&v)[V], float mu,
                                           float r) {
  float gv[V], o[V];
  load_f<W, V>(g + (long long)li * V, gv);
  if constexpr (RMS) {
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] = (v[k] * r) * gv[k];
  } else {
    float bv[V];
    load_f<W, V>(b + (long long)li * V, bv);
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] = ((v[k] - mu) * r) * gv[k] + bv[k];
  }
  store_f<T, V>(yr + (long long)li * V, o);
}

// One row normalisation: RMS selects RMSNorm (y = x * rsqrt(mean(x^2) +
// eps) * g, b unused), otherwise LayerNorm.  blockDim = (32 *
// warps_per_row, rows_per_block); each load is V elements (16 / sizeof(T),
// or 1 for rows that are not 16-byte aligned).  NV > 0: each thread holds
// NV loads of its row in registers.  NV == 0: the row is too wide for that,
// and is read again for each pass (LayerNorm: the mean, the variance and
// the normalise; RMSNorm: the sum of squares and the normalise), the
// rereads mostly from L2.
template <bool RMS, typename T, typename W, int V, int NV>
__global__ void norm_fwd(const T* __restrict__ x, const W* __restrict__ g,
                         const W* __restrict__ b, T* __restrict__ y,
                         long long rows, int H, float eps) {
  __shared__ float sm[32];
  const long long row = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= rows) return;  // whole warps leave together: a warp is one row
  const int nld = H / V;
  const int tpr = blockDim.x;
  const T* xr = x + row * H;
  T* yr = y + row * H;
  if constexpr (NV > 0) {
    float v[NV][V];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int li = threadIdx.x + i * tpr;
      if (li < nld) {
        load_f<T, V>(xr + (long long)li * V, v[i]);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) v[i][k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < V; ++k) s += RMS ? v[i][k] * v[i][k] : v[i][k];
    }
    float mu = 0.f, r;
    if constexpr (RMS) {
      r = 1.0f / sqrtf(row_sum(s, sm) / (float)H + eps);
    } else {
      mu = row_sum(s, sm) / (float)H;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (threadIdx.x + i * tpr < nld) {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float d = v[i][k] - mu;
            q += d * d;
          }
        }
      }
      r = 1.0f / sqrtf(row_sum(q, sm) / (float)H + eps);
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int li = threadIdx.x + i * tpr;
      if (li < nld) norm_store<RMS>(yr, g, b, li, v[i], mu, r);
    }
  } else {
    float s = 0.f;
    for (int li = threadIdx.x; li < nld; li += tpr) {
      float v[V];
      load_f<T, V>(xr + (long long)li * V, v);
#pragma unroll
      for (int k = 0; k < V; ++k) s += RMS ? v[k] * v[k] : v[k];
    }
    float mu = 0.f, r;
    if constexpr (RMS) {
      r = 1.0f / sqrtf(row_sum(s, sm) / (float)H + eps);
    } else {
      mu = row_sum(s, sm) / (float)H;
      float q = 0.f;
      for (int li = threadIdx.x; li < nld; li += tpr) {
        float v[V];
        load_f<T, V>(xr + (long long)li * V, v);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float d = v[k] - mu;
          q += d * d;
        }
      }
      r = 1.0f / sqrtf(row_sum(q, sm) / (float)H + eps);
    }
    for (int li = threadIdx.x; li < nld; li += tpr) {
      float v[V];
      load_f<T, V>(xr + (long long)li * V, v);
      norm_store<RMS>(yr, g, b, li, v, mu, r);
    }
  }
}

// The launch geometry of both norms: one warp a row up to 32 lanes x 8
// loads (four rows a block), else up to 32 warps a row; wider rows are
// reread (NV = 0).
template <bool RMS, typename T, typename W, int V>
cudaError_t launch_v(const T* x, const W* g, const W* b, T* y,
                     long long rows, int H, float eps, cudaStream_t st) {
  const int nld = H / V;
  int warps = (nld + 32 * 8 - 1) / (32 * 8);
  const bool wide = warps > 32;
  if (wide) warps = 32;
  const int per = (nld + 32 * warps - 1) / (32 * warps);
  const int rpb = warps == 1 ? 4 : 1;
  const dim3 block(32 * warps, rpb);
  const long long nblk = (rows + rpb - 1) / rpb;
  if (nblk > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)nblk);
  if (wide)
    norm_fwd<RMS, T, W, V, 0><<<grid, block, 0, st>>>(x, g, b, y, rows, H,
                                                      eps);
  else if (per <= 1)
    norm_fwd<RMS, T, W, V, 1><<<grid, block, 0, st>>>(x, g, b, y, rows, H,
                                                      eps);
  else if (per <= 2)
    norm_fwd<RMS, T, W, V, 2><<<grid, block, 0, st>>>(x, g, b, y, rows, H,
                                                      eps);
  else if (per <= 4)
    norm_fwd<RMS, T, W, V, 4><<<grid, block, 0, st>>>(x, g, b, y, rows, H,
                                                      eps);
  else
    norm_fwd<RMS, T, W, V, 8><<<grid, block, 0, st>>>(x, g, b, y, rows, H,
                                                      eps);
  return cudaGetLastError();
}

__host__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// 16-byte loads where every row and the weights are 16-byte aligned, else
// one-element loads.  b is null for RMSNorm.
template <bool RMS, typename T, typename W>
cudaError_t launch(const void* x, const void* g, const void* b, void* y,
                   long long rows, int H, float eps, cudaStream_t st) {
  constexpr int VEC = 16 / (int)sizeof(T);
  if (H <= 0 || rows <= 0) return cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  const W* gp = static_cast<const W*>(g);
  const W* bp = static_cast<const W*>(b);
  T* yp = static_cast<T*>(y);
  if (H % VEC == 0 && aligned16(x) && aligned16(g) && aligned16(y) &&
      (RMS || aligned16(b)))
    return launch_v<RMS, T, W, VEC>(xp, gp, bp, yp, rows, H, eps, st);
  return launch_v<RMS, T, W, 1>(xp, gp, bp, yp, rows, H, eps, st);
}

template <bool RMS>
int dispatch(const void* x, const void* g, const void* b, void* y,
             long long rows, int H, float eps, int x_dtype, int w_dtype,
             void* stream) {
  typedef __nv_bfloat16 bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (x_dtype == 0 && w_dtype == 0)
    e = launch<RMS, float, float>(x, g, b, y, rows, H, eps, st);
  else if (x_dtype == 0 && w_dtype == 1)
    e = launch<RMS, float, bf16>(x, g, b, y, rows, H, eps, st);
  else if (x_dtype == 1 && w_dtype == 0)
    e = launch<RMS, bf16, float>(x, g, b, y, rows, H, eps, st);
  else if (x_dtype == 1 && w_dtype == 1)
    e = launch<RMS, bf16, bf16>(x, g, b, y, rows, H, eps, st);
  return (int)e;
}

}  // namespace

extern "C" int pt_layer_norm_fwd(const void* x, const void* g, const void* b,
                                 void* y, long long rows, int H, float eps,
                                 int x_dtype, int w_dtype, void* stream) {
  return dispatch<false>(x, g, b, y, rows, H, eps, x_dtype, w_dtype, stream);
}

extern "C" int pt_rms_norm_fwd(const void* x, const void* g, void* y,
                               long long rows, int H, float eps, int x_dtype,
                               int w_dtype, void* stream) {
  return dispatch<true>(x, g, nullptr, y, rows, H, eps, x_dtype, w_dtype,
                        stream);
}

extern "C" const char* pt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
