// Weight-only int8 matmul for Hopper (sm_90a): out = (x @ w_q) * scale.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/dequant_matmul.py::
// _dqmm_kernel (launched by _dqmm_tpu).  Same contract: x [M, K] in the
// compute dtype (float32 or bfloat16, rows lda elements apart), w_q int8
// [K, N] row-major, scale fp32 [N] (one per output channel), out [M, N] in
// x's dtype.  As in the Pallas kernel, each int8 weight tile is converted to
// the compute dtype on chip (int8 -> bf16 is exact for |q| <= 127), the
// product accumulates in fp32, and the scale multiplies the fp32 sum once,
// which is then rounded once to the output dtype.  Device memory only ever
// carries 1-byte weights.
//
// Bound.  Decode (M = slots, a handful of rows) is bound by the weight
// bytes: K*N bytes against 2*M*K*N flops.  Prefill (M up to a few thousand)
// is bound by the tensor cores.  The TPU kernel kept K whole in VMEM and
// gridded over (M, N) tiles; a Hopper block holds a 64 x 64 output tile and
// walks K in steps of BK, with the next step's tiles loaded into registers
// while the current one is multiplied.  A few-row decode GEMM has too few
// output tiles to fill 132 SMs, so the wrapper splits K over grid.z: each
// split writes an fp32 partial tile, and the last split to finish a tile
// (an atomic ticket per tile) sums the partials in split order, so the
// result does not depend on which block ran first, and applies the scale.
//
// bf16 runs on the tensor cores (warp mma.sync m16n8k16, fp32 accumulate):
// 4 warps of 16 rows x 64 columns each, operands fetched from shared memory
// with ldmatrix (the int8 tile is stored converted, k-major, and read with
// ldmatrix.trans).  Warps whose 16 rows lie past M skip the products, so a
// decode GEMM pays for one warp's tensor work per tile.  float32 runs on the
// CUDA cores (256 threads, 4 x 4 outputs each): TF32 would not hold the
// fp32 tolerance.
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/cuda/
// dequant_matmul.py); dtype codes: 0 = float32, 1 = bfloat16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int BM = 64, BN = 64;

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// The end of every block: with one split, scale and round the accumulator
// pair (v0, v1) at (row, col), (row, col + 1) straight into out; with
// several, park it in this split's fp32 partial tile.
template <typename T>
__device__ __forceinline__ void emit2(T* __restrict__ out,
                                      float* __restrict__ ws,
                                      const float* __restrict__ scale, int M,
                                      int N, int row, int col, float v0,
                                      float v1, int ksplit) {
  if (row >= M || col >= N) return;
  if (ksplit == 1) {
    out[(long long)row * N + col] = from_f<T>(v0 * __ldg(scale + col));
    out[(long long)row * N + col + 1] = from_f<T>(v1 * __ldg(scale + col + 1));
  } else {
    float* p = ws + ((long long)blockIdx.z * M + row) * N + col;
    p[0] = v0;
    p[1] = v1;
  }
}

// Split-K: the last split to arrive at output tile (m0, n0) sums the
// partials of every split in order, scales, rounds and stores, then resets
// the tile's ticket to 0 for the next launch.
template <typename T, int NT>
__device__ __forceinline__ void split_k_finish(T* __restrict__ out,
                                               float* __restrict__ ws,
                                               int* __restrict__ tickets,
                                               const float* __restrict__ scale,
                                               int M, int N, int m0, int n0,
                                               int ksplit) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) last = atomicAdd(tickets + tile, 1) == ksplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int rows = min(BM, M - m0);
  const long long zs = (long long)M * N;  // one split's partials
  for (int i = threadIdx.x; i < rows * BN; i += NT) {
    const int row = m0 + i / BN, col = n0 + i % BN;
    if (col >= N) continue;
    const float* p = ws + (long long)row * N + col;
    // eight loads in flight, summed in split order
    float s = 0.f, part[8];
    int z = 0;
    for (; z + 8 <= ksplit; z += 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u) part[u] = __ldcg(p + (z + u) * zs);
#pragma unroll
      for (int u = 0; u < 8; ++u) s += part[u];
    }
    for (; z < ksplit; ++z) s += __ldcg(p + z * zs);
    out[(long long)row * N + col] = from_f<T>(s * __ldg(scale + col));
  }
  if (threadIdx.x == 0) tickets[tile] = 0;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int TB = 128;          // threads of the bf16 kernel (4 warps)
constexpr int BK = 64;           // k depth of one step
constexpr int XCH = BM * BK / 8 / TB;   // 16-byte x chunks per thread
constexpr int WCH = BK * BN / 16 / TB;  // 16-byte weight chunks per thread
constexpr int LDX = BK + 8;      // smem row pitch (elements) of the x tile
constexpr int LDW = BN + 8;      // smem row pitch of the k-major weight tile

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives, of matrix i, row l / 4, columns 2(l % 4) and +1 in r[i].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// The same, transposed: of matrix i, rows 2(l % 4) and +1 of column l / 4.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t i8pair_to_bf16x2(int8_t lo, int8_t hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn((float)lo, (float)hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// grid (N / BN, M / BM, ksplit); split z walks k steps [z*tpb, z*tpb + tpb).
__global__ void __launch_bounds__(TB)
dqmm_bf16(const bf16* __restrict__ x, long long lda,
          const int8_t* __restrict__ w, const float* __restrict__ scale,
          bf16* __restrict__ out, float* __restrict__ ws,
          int* __restrict__ tickets, int M, int N, int K, int tpb,
          int ksplit) {
  __shared__ __align__(16) bf16 Xs[2][BM * LDX];
  __shared__ __align__(16) bf16 Ws[2][BK * LDW];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kt0 = blockIdx.z * tpb;
  const int kt1 = min(kt0 + tpb, cdiv(K, BK));
  const bool active = m0 + 16 * warp < M;

  // this thread's share of one k step: XCH 16-byte chunks of x (row
  // xr[j], 8 columns from xc[j]) and WCH of w (row wr[j], 16 columns from
  // wc[j])
  int xr[XCH], xc[XCH], wr[WCH], wc[WCH];
#pragma unroll
  for (int j = 0; j < XCH; ++j) {
    xr[j] = (tid + TB * j) / (BK / 8);
    xc[j] = 8 * ((tid + TB * j) % (BK / 8));
  }
#pragma unroll
  for (int j = 0; j < WCH; ++j) {
    wr[j] = (tid + TB * j) / (BN / 16);
    wc[j] = 16 * ((tid + TB * j) % (BN / 16));
  }
  uint4 xv[XCH], wv[WCH];

  auto fetch = [&](int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int j = 0; j < XCH; ++j) {
      const int row = m0 + xr[j], col = k0 + xc[j];
      xv[j] = (row < M && col < K)
                  ? ldg16(x + (long long)row * lda + col)
                  : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < WCH; ++j) {
      const int k = k0 + wr[j], n = n0 + wc[j];
      wv[j] = (k < K && n < N) ? ldg16(w + (long long)k * N + n)
                               : make_uint4(0, 0, 0, 0);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int j = 0; j < XCH; ++j)
      *reinterpret_cast<uint4*>(&Xs[buf][xr[j] * LDX + xc[j]]) = xv[j];
#pragma unroll
    for (int j = 0; j < WCH; ++j) {
      const int8_t* b = reinterpret_cast<const int8_t*>(&wv[j]);
      uint32_t o[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        o[i] = i8pair_to_bf16x2(b[2 * i], b[2 * i + 1]);
      uint4* dst = reinterpret_cast<uint4*>(&Ws[buf][wr[j] * LDW + wc[j]]);
      dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
      dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
    }
  };

  float acc[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  if (kt0 < kt1) {
    fetch(kt0);
    stash(0);
  }
  __syncthreads();
  for (int kt = kt0; kt < kt1; ++kt) {
    const int buf = (kt - kt0) & 1;
    if (kt + 1 < kt1) fetch(kt + 1);
    if (active) {
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, &Xs[buf][(16 * warp + (lane & 15)) * LDX + 16 * ks +
                                8 * (lane >> 4)]);
#pragma unroll
        for (int nt = 0; nt < BN / 8; nt += 2) {
          const int mi = lane >> 3;
          uint32_t b[4];
          ldmatrix_x4_trans(b, &Ws[buf][(16 * ks + (lane & 7) + 8 * (mi & 1)) *
                                            LDW +
                                        8 * nt + 8 * (mi >> 1)]);
          mma16816(acc[nt], a, b[0], b[1]);
          mma16816(acc[nt + 1], a, b[2], b[3]);
        }
      }
    }
    if (kt + 1 < kt1) stash(buf ^ 1);
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
    const int row = m0 + 16 * warp + g, col = n0 + 8 * nt + 2 * t;
    emit2<bf16>(out, ws, scale, M, N, row, col, acc[nt][0], acc[nt][1],
                ksplit);
    emit2<bf16>(out, ws, scale, M, N, row + 8, col, acc[nt][2], acc[nt][3],
                ksplit);
  }
  if (ksplit > 1)
    split_k_finish<bf16, TB>(out, ws, tickets, scale, M, N, m0, n0, ksplit);
}

// ---------------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------------
constexpr int TF = 256;          // threads of the fp32 kernel
constexpr int BKF = 16;          // k depth of one step

__global__ void __launch_bounds__(TF)
dqmm_f32(const float* __restrict__ x, long long lda,
         const int8_t* __restrict__ w, const float* __restrict__ scale,
         float* __restrict__ out, float* __restrict__ ws,
         int* __restrict__ tickets, int M, int N, int K, int tpb, int ksplit) {
  __shared__ __align__(16) float Xs[2][BKF][BM + 4];   // k-major x tile
  __shared__ __align__(16) float Ws[2][BKF][BN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kt0 = blockIdx.z * tpb;
  const int kt1 = min(kt0 + tpb, cdiv(K, BKF));

  const int xr = tid / (BKF / 4), xc = 4 * (tid % (BKF / 4));  // 4 floats
  const int wr = tid / (BN / 16), wc = 16 * (tid % (BN / 16));  // 16 int8
  const bool wload = tid < BKF * BN / 16;
  float4 xv;
  uint4 wv;

  auto fetch = [&](int kt) {
    const int k0 = kt * BKF;
    const int row = m0 + xr, col = k0 + xc;
    xv = (row < M && col < K)
             ? __ldg(reinterpret_cast<const float4*>(x + (long long)row * lda +
                                                     col))
             : make_float4(0.f, 0.f, 0.f, 0.f);
    const int k = k0 + wr, n = n0 + wc;
    wv = (wload && k < K && n < N) ? ldg16(w + (long long)k * N + n)
                                   : make_uint4(0, 0, 0, 0);
  };
  auto stash = [&](int buf) {
    Xs[buf][xc + 0][xr] = xv.x;
    Xs[buf][xc + 1][xr] = xv.y;
    Xs[buf][xc + 2][xr] = xv.z;
    Xs[buf][xc + 3][xr] = xv.w;
    if (wload) {
      const int8_t* b = reinterpret_cast<const int8_t*>(&wv);
      float4* dst = reinterpret_cast<float4*>(&Ws[buf][wr][wc]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dst[i] = make_float4((float)b[4 * i], (float)b[4 * i + 1],
                             (float)b[4 * i + 2], (float)b[4 * i + 3]);
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (kt0 < kt1) {
    fetch(kt0);
    stash(0);
  }
  __syncthreads();
  for (int kt = kt0; kt < kt1; ++kt) {
    const int buf = (kt - kt0) & 1;
    if (kt + 1 < kt1) fetch(kt + 1);
#pragma unroll
    for (int k = 0; k < BKF; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&Xs[buf][k][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&Ws[buf][k][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (kt + 1 < kt1) stash(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; j += 2)
      emit2<float>(out, ws, scale, M, N, m0 + 4 * ty + i, n0 + 4 * tx + j,
                   acc[i][j], acc[i][j + 1], ksplit);
  if (ksplit > 1)
    split_k_finish<float, TF>(out, ws, tickets, scale, M, N, m0, n0, ksplit);
}

}  // namespace

// k depth of one step for a dtype code (the wrapper sizes splits with it)
extern "C" int pt_dequant_matmul_bk(int dtype) { return dtype == 1 ? BK : BKF; }

extern "C" int pt_dequant_matmul(const void* x, long long lda, const void* w,
                                 const float* scale, void* out, float* ws,
                                 int* tickets, int M, int N, int K, int tpb,
                                 int ksplit, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 16 || K % 8 || lda < K ||
      tpb <= 0 || ksplit <= 0)
    return (int)cudaErrorInvalidValue;
  const int bk = dtype == 1 ? BK : BKF;
  const int kt = (K + bk - 1) / bk;
  if ((ksplit - 1) * tpb >= kt || ksplit * tpb < kt)
    return (int)cudaErrorInvalidValue;   // a split with no k step, or a gap
  const long long mt = (M + BM - 1) / BM;
  if (mt > 65535 || ksplit > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (unsigned)mt, ksplit);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    dqmm_f32<<<grid, TF, 0, st>>>(
        static_cast<const float*>(x), lda, static_cast<const int8_t*>(w),
        scale, static_cast<float*>(out), ws, tickets, M, N, K, tpb, ksplit);
  else if (dtype == 1)
    dqmm_bf16<<<grid, TB, 0, st>>>(
        static_cast<const bf16*>(x), lda, static_cast<const int8_t*>(w), scale,
        static_cast<bf16*>(out), ws, tickets, M, N, K, tpb, ksplit);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* pt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
