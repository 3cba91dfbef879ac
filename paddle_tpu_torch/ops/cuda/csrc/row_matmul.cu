// Row-invariant matrix product y = x W for Hopper (sm_90a), float32 and
// bfloat16.
//
// Replaces no TPU kernel.  It was added for the reference's commit-bytes
// contract (paddle_tpu/models/gpt.py:1103 _paged_verify_block): the lanes a
// speculative verify accepts must commit the bytes a sequential decode
// writes.  The verify runs a block's four weight products at M = S * W rows,
// the decode at M = S.  cuBLAS picks its algorithm, and with it the order of
// each output's sum, from M, so lane 0 of a verify and the decode round
// differently.  This kernel gives every output row the same bits whatever M
// is and wherever the row lies in x:
//
//   * Each output element is one fp32 sum in an order fixed by K and N
//     alone.  K is cut into C * 16 equal ranges (C, the cluster size, is
//     chosen from N; 16 warps a block).  A warp sums its range in k order
//     with fmaf, the 16 warps' sums are added in warp order, and the C
//     blocks' sums in rank order.  Nothing in that order depends on M or on
//     the row's index: blocks over other rows run the same code.
//   * float32 is fp32 FMAs on the CUDA cores (no TF32).  bfloat16 inputs are
//     widened to fp32 and take the same FMAs; the output is rounded once.
//
// Bound: bytes.  At the decode's shapes (M = 8, K x N = 1024 x 3072, 1024 x
// 1024, 1024 x 4096, 4096 x 1024) the product reads 2-8 MB of weights and
// does 2 M flops a weight byte in bf16, far below the ~295 flops a byte at
// which the H100's tensor cores would bound it; at the verify's M = 40 the
// CUDA-core FMAs (67 TFLOP/s fp32) cost about as much as the bytes.  Design
// for that bound, simple first: every weight element is read from device
// memory once per 8-row chunk of x (M <= 8 reads W once; larger M reads it
// again from L2), lanes read neighbouring columns (8 bytes a lane in fp32,
// 4 in bf16), four weight rows in flight, and K is split over a
// thread-block cluster so that even N = 1024 (16 column tiles) keeps 128
// blocks streaming.  (Blocks of 16 or 32 rows with eight weight rows in
// flight and x read four k at a time measured slower on the H100 at both
// the decode's and the verify's M: 128 registers, one block an SM.)  The C ranks' partials meet in the owning rank's
// shared memory (distributed shared memory) behind one cluster barrier:
// no workspace, no second launch, and the kernel is safe to capture in a
// CUDA graph.
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/cuda/row_matmul.py);
// dtype codes: 0 = float32, 1 = bfloat16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 16;            // K ranges a block
constexpr int THREADS = WARPS * 32;
constexpr int COLS = 64;             // a block's columns, two a lane
constexpr int ROWS = 8;              // a block's rows of x
constexpr int OUTS = ROWS * COLS;    // a block's outputs
constexpr int UNROLL = 4;            // weight rows a lane has in flight

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Columns n and n + 1 of one row of W (zero past N).  VEC: N is even and W
// is aligned to two elements, so the pair is one load.
template <typename T, bool VEC>
__device__ __forceinline__ void load_pair(const T* __restrict__ row, int n,
                                          int N, float& a, float& b) {
  if (VEC) {
    if (n < N) {
      if constexpr (sizeof(T) == 4) {
        const float2 v = __ldg(reinterpret_cast<const float2*>(row + n));
        a = v.x;
        b = v.y;
      } else {
        const __nv_bfloat162 v =
            *reinterpret_cast<const __nv_bfloat162*>(row + n);
        a = __low2float(v);
        b = __high2float(v);
      }
    } else {
      a = b = 0.f;
    }
  } else {
    a = n < N ? to_f(row[n]) : 0.f;
    b = n + 1 < N ? to_f(row[n + 1]) : 0.f;
  }
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
// Store v at this block's shared-memory address `a` in block `cta` of the
// cluster (read there after the cluster barrier).
__device__ __forceinline__ void st_cluster_f32(uint32_t a, uint32_t cta,
                                               float v) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(a), "r"(cta));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" :: "r"(r), "f"(v)
               : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Grid (C, column tiles, row chunks), cluster (C, 1, 1), 512 threads.
// Block (rank q, tile t, chunk c): columns [64 t, 64 t + 64), rows
// [8 c, 8 c + 8) of x, and of K the 16 ranges q * 16 .. q * 16 + 15 of
// kchunk rows each.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
row_mm(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
       int M, int K, int N, int kchunk) {
  __shared__ float part[WARPS][OUTS];   // each warp's sums
  __shared__ float recv[OUTS];          // slot q: rank q's block sums
  // every block of the cluster has started before any writes into another
  // one's shared memory (the wait comes after the products)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C = (int)cluster_size(), q = (int)cluster_rank();
  const int n0 = blockIdx.y * COLS;
  const int r0 = blockIdx.z * ROWS;
  const int rows = min(ROWS, M - r0);
  const int n = n0 + 2 * lane;
  const int s = q * WARPS + warp;                   // this warp's K range
  const int k0 = min(K, s * kchunk), k1 = min(K, k0 + kchunk);

  float acc[ROWS][2];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r][0] = acc[r][1] = 0.f;
  const T* xr = x + (long long)r0 * K;
  int k = k0;
  // each output's sum runs over k in increasing order, one fmaf a k, in
  // both loops
  for (; k + UNROLL <= k1; k += UNROLL) {
    float wa[UNROLL], wb[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      load_pair<T, VEC>(w + (long long)(k + u) * N, n, N, wa[u], wb[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < rows) {
          const float xv = to_f(xr[(long long)r * K + k + u]);
          acc[r][0] = fmaf(xv, wa[u], acc[r][0]);
          acc[r][1] = fmaf(xv, wb[u], acc[r][1]);
        }
      }
    }
  }
  for (; k < k1; ++k) {
    float wa, wb;
    load_pair<T, VEC>(w + (long long)k * N, n, N, wa, wb);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r < rows) {
        const float xv = to_f(xr[(long long)r * K + k]);
        acc[r][0] = fmaf(xv, wa, acc[r][0]);
        acc[r][1] = fmaf(xv, wb, acc[r][1]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    part[warp][r * COLS + 2 * lane] = acc[r][0];
    part[warp][r * COLS + 2 * lane + 1] = acc[r][1];
  }
  __syncthreads();

  // the block's sum of each output over its warps, in warp order, to the
  // rank that owns the output: rank o owns outputs [o per, o per + per)
  // and keeps rank q's sum in its slot q
  const int per = OUTS / C;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int i = threadIdx.x; i < OUTS; i += THREADS) {
    float sum = part[0][i];
#pragma unroll
    for (int j = 1; j < WARPS; ++j) sum += part[j][i];
    const int o = i / per;
    st_cluster_f32(
        (uint32_t)__cvta_generic_to_shared(&recv[q * per + i - o * per]),
        (uint32_t)o, sum);
  }
  cluster_sync();
  // this rank's outputs: the ranks' sums in rank order, one rounding
  for (int j = threadIdx.x; j < per; j += THREADS) {
    const int i = q * per + j;
    const int r = i / COLS, c = n0 + i % COLS;
    if (r < rows && c < N) {
      float sum = recv[j];
      for (int t = 1; t < C; ++t) sum += recv[t * per + j];
      y[(long long)(r0 + r) * N + c] = from_f<T>(sum);
    }
  }
}

// The cluster size: K's split over blocks, from N's column tiles alone, so
// that the split (and each output's order of summation) never depends on M.
int cluster_for(int N) {
  const int tiles = (N + COLS - 1) / COLS;
  if (tiles <= 16) return 8;
  if (tiles <= 33) return 4;
  if (tiles <= 66) return 2;
  return 1;
}

template <typename T, bool VEC>
cudaError_t launch(const void* x, const void* w, void* y, int M, int K,
                   int N, cudaStream_t st) {
  const int C = cluster_for(N);
  const int kchunk = (K + C * WARPS - 1) / (C * WARPS);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)C, (unsigned)((N + COLS - 1) / COLS),
                     (unsigned)((M + ROWS - 1) / ROWS));
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, row_mm<T, VEC>, static_cast<const T*>(x),
      static_cast<const T*>(w), static_cast<T*>(y), M, K, N, kchunk);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// y [M, N] = x [M, K] W [K, N], all contiguous rows, one dtype.
extern "C" int pt_row_matmul(const void* x, const void* w, void* y, int M,
                             int K, int N, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t esz = dtype == 0 ? 4 : 2;
  const bool vec = (N % 2 == 0) &&
                   (reinterpret_cast<uintptr_t>(w) % (2 * esz) == 0);
  if (dtype == 0)
    return (int)(vec ? launch<float, true>(x, w, y, M, K, N, st)
                     : launch<float, false>(x, w, y, M, K, N, st));
  return (int)(vec ? launch<__nv_bfloat16, true>(x, w, y, M, K, N, st)
                   : launch<__nv_bfloat16, false>(x, w, y, M, K, N, st));
}

extern "C" const char* pt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
