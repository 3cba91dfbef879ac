// Row LayerNorm and RMSNorm forwards for Hopper (sm_90a).
//
// ln_fwd replaces the TPU kernel paddle_tpu/ops/pallas/norms.py::_ln_kernel
// (launched by _pallas_norm through layer_norm).  Same arithmetic: the row
// mean and the two-pass variance mean((x - mu)^2) in fp32, y = (x - mu) *
// rsqrt(var + eps), the affine y * g + b in fp32, one cast back to x's type.
//
// rms_fwd replaces _rms_kernel (launched by _pallas_norm through rms_norm):
// the row mean of x^2 in fp32, y = x * rsqrt(ms + eps) * g in fp32, one cast
// back to x's type; g is float32 or bfloat16 whatever x is.
//
// Bound: bytes.  Each kernel reads each element of x once and writes each
// element of y once (2 * rows * H * itemsize, plus g and b); it does under
// 10 flops per element, far below the H100's ~20 flops per byte of HBM rate.
// Design for that bound: the row is read from device memory exactly once,
// with 16-byte vector loads, and held in registers for the reduction and
// normalise passes.  One warp owns a row when the row fits in 32 lanes x 8
// vectors (H <= 2048 for bf16, <= 1024 for fp32; four such rows per
// 128-thread block); wider rows take several warps of one block, joined by
// a shared-memory sum.  Reductions are warp shuffles.  LayerNorm takes H a
// multiple of the vector width only.  RMSNorm takes any H >= 1: rows that
// are not 16-byte aligned (H not a multiple of 16 / itemsize, or a pointer
// off 16 bytes) take one-element loads, and rows wider than 32 warps x 8
// loads are read twice (the second read mostly from L2) instead of held.
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

// blockDim = (32 * warps_per_row, rows_per_block); each thread holds NV
// vectors of VEC = 16 / sizeof(T) elements of its row.
template <typename T, typename W, int NV>
__global__ void ln_fwd(const T* __restrict__ x, const W* __restrict__ g,
                       const W* __restrict__ b, T* __restrict__ y,
                       long long rows, int H, float eps) {
  constexpr int VEC = 16 / (int)sizeof(T);
  __shared__ float sm[32];
  const long long row = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= rows) return;  // whole warps leave together: a warp is one row
  const int nvec = H / VEC;
  const int tpr = blockDim.x;
  const T* xr = x + row * H;
  T* yr = y + row * H;

  float v[NV][VEC];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = threadIdx.x + i * tpr;
    if (vi < nvec) {
      load_f<T, VEC>(xr + (long long)vi * VEC, v[i]);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[i][k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) s += v[i][k];
  }
  const float mu = row_sum(s, sm) / (float)H;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (threadIdx.x + i * tpr < nvec) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float d = v[i][k] - mu;
        q += d * d;
      }
    }
  }
  const float var = row_sum(q, sm) / (float)H;
  const float rstd = 1.0f / sqrtf(var + eps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = threadIdx.x + i * tpr;
    if (vi < nvec) {
      float gv[VEC], bv[VEC], o[VEC];
      load_f<W, VEC>(g + (long long)vi * VEC, gv);
      load_f<W, VEC>(b + (long long)vi * VEC, bv);
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        o[k] = ((v[i][k] - mu) * rstd) * gv[k] + bv[k];
      store_f<T, VEC>(yr + (long long)vi * VEC, o);
    }
  }
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* g, const void* b, void* y,
                   long long rows, int H, float eps, cudaStream_t st) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const int nvec = H / VEC;
  const int warps = (nvec + 32 * 8 - 1) / (32 * 8);
  if (H <= 0 || H % VEC || warps > 32 || rows <= 0) return cudaErrorInvalidValue;
  const int per = (nvec + 32 * warps - 1) / (32 * warps);
  const int rpb = warps == 1 ? 4 : 1;
  const dim3 block(32 * warps, rpb);
  const long long nblk = (rows + rpb - 1) / rpb;
  if (nblk > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)nblk);
  const T* xp = static_cast<const T*>(x);
  const W* gp = static_cast<const W*>(g);
  const W* bp = static_cast<const W*>(b);
  T* yp = static_cast<T*>(y);
  if (per <= 1)
    ln_fwd<T, W, 1><<<grid, block, 0, st>>>(xp, gp, bp, yp, rows, H, eps);
  else if (per <= 2)
    ln_fwd<T, W, 2><<<grid, block, 0, st>>>(xp, gp, bp, yp, rows, H, eps);
  else if (per <= 4)
    ln_fwd<T, W, 4><<<grid, block, 0, st>>>(xp, gp, bp, yp, rows, H, eps);
  else
    ln_fwd<T, W, 8><<<grid, block, 0, st>>>(xp, gp, bp, yp, rows, H, eps);
  return cudaGetLastError();
}

// blockDim = (32 * warps_per_row, rows_per_block); each load is V elements
// (16 / sizeof(T), or 1 for rows that are not 16-byte aligned).  NV > 0:
// each thread holds NV loads of its row in registers.  NV == 0: the row is
// too wide for that, and is read once for the sum and again to normalise.
template <typename T, typename W, int V, int NV>
__global__ void rms_fwd(const T* __restrict__ x, const W* __restrict__ g,
                        T* __restrict__ y, long long rows, int H, float eps) {
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
      for (int k = 0; k < V; ++k) s += v[i][k] * v[i][k];
    }
    const float r = 1.0f / sqrtf(row_sum(s, sm) / (float)H + eps);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int li = threadIdx.x + i * tpr;
      if (li < nld) {
        float gv[V], o[V];
        load_f<W, V>(g + (long long)li * V, gv);
#pragma unroll
        for (int k = 0; k < V; ++k) o[k] = (v[i][k] * r) * gv[k];
        store_f<T, V>(yr + (long long)li * V, o);
      }
    }
  } else {
    float s = 0.f;
    for (int li = threadIdx.x; li < nld; li += tpr) {
      float v[V];
      load_f<T, V>(xr + (long long)li * V, v);
#pragma unroll
      for (int k = 0; k < V; ++k) s += v[k] * v[k];
    }
    const float r = 1.0f / sqrtf(row_sum(s, sm) / (float)H + eps);
    for (int li = threadIdx.x; li < nld; li += tpr) {
      float v[V], gv[V], o[V];
      load_f<T, V>(xr + (long long)li * V, v);
      load_f<W, V>(g + (long long)li * V, gv);
#pragma unroll
      for (int k = 0; k < V; ++k) o[k] = (v[k] * r) * gv[k];
      store_f<T, V>(yr + (long long)li * V, o);
    }
  }
}

template <typename T, typename W, int V>
cudaError_t launch_rms_v(const T* x, const W* g, T* y, long long rows, int H,
                         float eps, cudaStream_t st) {
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
    rms_fwd<T, W, V, 0><<<grid, block, 0, st>>>(x, g, y, rows, H, eps);
  else if (per <= 1)
    rms_fwd<T, W, V, 1><<<grid, block, 0, st>>>(x, g, y, rows, H, eps);
  else if (per <= 2)
    rms_fwd<T, W, V, 2><<<grid, block, 0, st>>>(x, g, y, rows, H, eps);
  else if (per <= 4)
    rms_fwd<T, W, V, 4><<<grid, block, 0, st>>>(x, g, y, rows, H, eps);
  else
    rms_fwd<T, W, V, 8><<<grid, block, 0, st>>>(x, g, y, rows, H, eps);
  return cudaGetLastError();
}

__host__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, typename W>
cudaError_t launch_rms(const void* x, const void* g, void* y, long long rows,
                       int H, float eps, cudaStream_t st) {
  constexpr int VEC = 16 / (int)sizeof(T);
  if (H <= 0 || rows <= 0) return cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  const W* gp = static_cast<const W*>(g);
  T* yp = static_cast<T*>(y);
  if (H % VEC == 0 && aligned16(x) && aligned16(g) && aligned16(y))
    return launch_rms_v<T, W, VEC>(xp, gp, yp, rows, H, eps, st);
  return launch_rms_v<T, W, 1>(xp, gp, yp, rows, H, eps, st);
}

}  // namespace

extern "C" int pt_layer_norm_fwd(const void* x, const void* g, const void* b,
                                 void* y, long long rows, int H, float eps,
                                 int x_dtype, int w_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (x_dtype == 0 && w_dtype == 0)
    e = launch<float, float>(x, g, b, y, rows, H, eps, st);
  else if (x_dtype == 0 && w_dtype == 1)
    e = launch<float, __nv_bfloat16>(x, g, b, y, rows, H, eps, st);
  else if (x_dtype == 1 && w_dtype == 0)
    e = launch<__nv_bfloat16, float>(x, g, b, y, rows, H, eps, st);
  else if (x_dtype == 1 && w_dtype == 1)
    e = launch<__nv_bfloat16, __nv_bfloat16>(x, g, b, y, rows, H, eps, st);
  return (int)e;
}

extern "C" int pt_rms_norm_fwd(const void* x, const void* g, void* y,
                               long long rows, int H, float eps, int x_dtype,
                               int w_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (x_dtype == 0 && w_dtype == 0)
    e = launch_rms<float, float>(x, g, y, rows, H, eps, st);
  else if (x_dtype == 0 && w_dtype == 1)
    e = launch_rms<float, __nv_bfloat16>(x, g, y, rows, H, eps, st);
  else if (x_dtype == 1 && w_dtype == 0)
    e = launch_rms<__nv_bfloat16, float>(x, g, y, rows, H, eps, st);
  else if (x_dtype == 1 && w_dtype == 1)
    e = launch_rms<__nv_bfloat16, __nv_bfloat16>(x, g, y, rows, H, eps, st);
  return (int)e;
}

extern "C" const char* pt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
