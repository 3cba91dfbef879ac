// Fused transformer FFN for Hopper (sm_90a):
//   out = gelu_tanh(x @ w1 + b1) @ w2 + b2
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_ffn.py::_ffn_kernel
// (launched by _fused_ffn_tpu).  Same arithmetic: the first product
// accumulates in fp32 from the stored values, b1 is added in fp32, gelu
// (tanh form) runs in fp32, and h is rounded once to x's dtype before the
// second product; that product accumulates in an fp32 [rows, H] accumulator,
// which gets b2 in fp32 at the end and is rounded once to x's dtype.  The
// [M, F] intermediate never reaches device memory.
//
// Layout: x [M, H] contiguous rows; b1 [F], b2 [H]; out [M, H]; all
// contiguous and in x's dtype.  float32 takes w1 [H, F] and w2 [F, H];
// bfloat16 takes them transposed, w1t [F, H] and w2t [H, F] (the wrapper
// transposes), so that a thread loads 16 contiguous bytes of a B fragment.
// M is free (ragged row tiles are masked); H and F are multiples of 8, H
// at most 2048.
//
// Bound.  4*M*H*F flops against (M*H*2 + 2*H*F + F + H) elements: at the
// GPT-3 1.3B training shape (M = 12288, H = 2048, F = 8192, bf16) 0.82
// TFLOP against 168 MB, bound by operations on the tensor cores (0.83 ms at
// 989 TFLOP/s).  A decode GEMM (M = 8) is bound by the weight bytes.
//
// Design for that bound (the TPU kept a [128, H] fp32 accumulator in VMEM,
// 1 MB at H = 2048, more than an SM holds).  bf16: a cluster of two blocks
// owns 32 rows and their whole [32, H] fp32 accumulator, each block half of
// the columns in the registers of its 16 warps, and walks F in tiles of
// BF = 128:
//   1. h[32, BF] = x_tile @ w1[:, f-tile] on the tensor cores: each block
//      takes half of the k range (its half of x stays in shared memory for
//      the whole walk), sums its warps' partials in shared memory in a fixed
//      order, and the two blocks swap partials through distributed shared
//      memory; both then add them in the same order, + b1, gelu, and round
//      to bf16 into shared memory;
//   2. acc[32, H/2] += h @ w2[f-tile, this block's columns].
// Every weight byte a cluster reads feeds 32 rows: 32 flops per byte.  The
// weights are read by every cluster, B fragments straight from global
// memory (the clusters that run together walk the same F tiles, so most
// reads hit the 50 MB L2), which bounds the kernel by L2 bandwidth.  Each
// thread loads 16 bytes of a transposed weight row, 8 consecutive k, for two
// k-steps at once: k is relabelled within each 32-wide slice, the same way
// in A and B (thread t's k-slots 2t, 2t+1 hold k = 8t + 4s, +1 and slots
// 2t+8, 2t+9 hold 8t + 4s + 2, +3 in step s), which the contraction does not
// see.  cp.async/TMA staging, wgmma and larger clusters are the next steps.
// bf16 runs warp-level mma.sync m16n8k16 (fp32 accumulate); float32 runs on
// the CUDA cores (TF32 would break its 1e-5 tolerance): a block of 16 rows
// and the whole [16, H] accumulator, a thread per (row, f) for the first
// product and a thread per column group for the second.
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/cuda/fused_ffn.py);
// dtype codes: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after
// the launch.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

constexpr int BM = 16;          // rows of a block (fp32)
constexpr int NW = 16;          // warps of a block
constexpr int NT = 32 * NW;     // threads of a block
constexpr int BF = 128;         // F tile of the bf16 kernel
constexpr int PADS = 32;        // row padding (64 bytes: 16-byte row loads of
                                // rows g and g + 1 fall in other banks)
constexpr int LDH = BF + PADS;  // pitch of the bf16 h tile
constexpr int BFF = 32;         // F tile of the fp32 kernel
constexpr int MAX_H = 2048;

__device__ __forceinline__ float gelu_tanh(float u) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * u * (1.f + tanhf(c * (u + 0.044715f * u * u * u)));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragments of two k-steps over columns [k0, k0 + 32) of rows 0-15 of
// a row-major bf16 tile in shared memory (ld elements a row), under the
// k relabelling above: 16 bytes of rows g and g + 8.
__device__ __forceinline__ void frag_a2(uint32_t (&a)[2][4], const bf16* m,
                                        int ld, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint4 lo = *reinterpret_cast<const uint4*>(m + g * ld + k0 + 8 * t);
  const uint4 hi =
      *reinterpret_cast<const uint4*>(m + (g + 8) * ld + k0 + 8 * t);
  a[0][0] = lo.x; a[0][1] = hi.x; a[0][2] = lo.y; a[0][3] = hi.y;
  a[1][0] = lo.z; a[1][1] = hi.z; a[1][2] = lo.w; a[1][3] = hi.w;
}

// The B fragments of two k-steps over k [k0, k0 + 32), columns [n0, n0 + 8),
// from a transposed weight wt [N, K] in global memory (B[k][n] =
// wt[n0 + n][k0 + k]) under the same relabelling: 16 bytes of row n0 + g.
// A row at or past N, or a k chunk at or past K (K is a multiple of 8, so
// a chunk is in or out whole), reads as zero.
__device__ __forceinline__ uint4 frag_b2(const bf16* __restrict__ wt, int K,
                                         int N, int k0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n = n0 + g, k = k0 + 8 * t;
  if (n >= N || k >= K) return make_uint4(0, 0, 0, 0);
  return __ldg(reinterpret_cast<const uint4*>(wt + (long long)n * K + k));
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: a cluster of two blocks per 32-row tile.
// Block r (its rank in the cluster) owns output columns [r*CH, (r+1)*CH),
// CH = 128 * NTW, in its accumulator, and the first product's k range
// [r*KH, (r+1)*KH) of x and w1.  Per F tile each block sums its 16 warps'
// partial h over its k range in shared memory, the two blocks swap those
// partials through distributed shared memory, and each forms the same
// h = partial(rank 0) + partial(rank 1), then + b1, gelu and one rounding to
// bf16.  NTW: n-tiles (8 columns) a warp owns in each of the tile's two
// 16-row m-tiles.
// ---------------------------------------------------------------------------
constexpr int BM2 = 32;         // rows of a cluster's tile
constexpr int KG = 2;           // k groups of the first product in a block

template <int NTW>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(NT, 1)
ffn_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w1t,
         const bf16* __restrict__ b1, const bf16* __restrict__ w2t,
         const bf16* __restrict__ b2, bf16* __restrict__ out, int M, int H,
         int F, int KH) {
  constexpr int CH = 16 * 8 * NTW;
  extern __shared__ __align__(16) unsigned char smraw[];
  const int LDX = KH + PADS;
  bf16* Xs = reinterpret_cast<bf16*>(smraw);                // [BM2][LDX]
  float* Red = reinterpret_cast<float*>(Xs + BM2 * LDX);    // [KG][BM2][BF]
  float* Part = Red + KG * BM2 * BF;                        // [2][BM2][BF]
  bf16* Hs = reinterpret_cast<bf16*>(Part + 2 * BM2 * BF);  // [BM2][LDH]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const float* peer_part = cluster.map_shared_rank(Part, rank ^ 1);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (blockIdx.x >> 1) * BM2;
  const int kbase = rank * KH;

  // this block's k range of x -> shared, 16-byte chunks; rows past M and
  // columns past H zero
  for (int i = tid; i < BM2 * (KH / 8); i += NT) {
    const int r = i / (KH / 8), c = 8 * (i % (KH / 8));
    uint4 v = make_uint4(0, 0, 0, 0);
    if (m0 + r < M && kbase + c < H)
      v = __ldg(reinterpret_cast<const uint4*>(x + (long long)(m0 + r) * H +
                                               kbase + c));
    *reinterpret_cast<uint4*>(Xs + r * LDX + c) = v;
  }

  float acc[2][NTW][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  const int ng = warp & 7, kg = warp >> 3;   // first product: 2 n-tiles each
  const int kspan = KH / KG;                 // a multiple of 32
  const int c0 = rank * CH + warp * NTW * 8; // second product: first column
  __syncthreads();

  for (int f0 = 0, buf = 0; f0 < F; f0 += BF, buf ^= 1) {
    // 1. this warp's partial h over its share of the block's k range
    float hacc[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[mt][j][e] = 0.f;
    for (int k0 = kg * kspan; k0 < (kg + 1) * kspan; k0 += 32) {
      uint32_t a[2][2][4];
      frag_a2(a[0], Xs, LDX, k0);
      frag_a2(a[1], Xs + 16 * LDX, LDX, k0);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint4 b = frag_b2(w1t, H, F, kbase + k0, f0 + 8 * (2 * ng + j));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma16816(hacc[mt][j], a[mt][0], b.x, b.y);
          mma16816(hacc[mt][j], a[mt][1], b.z, b.w);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 8 * (2 * ng + j) + 2 * t;
        float* p = Red + (kg * BM2 + 16 * mt + g) * BF + col;
        p[0] = hacc[mt][j][0];
        p[1] = hacc[mt][j][1];
        p[8 * BF] = hacc[mt][j][2];
        p[8 * BF + 1] = hacc[mt][j][3];
      }
    __syncthreads();
    // the block's partial, its k groups summed in order
    float* part = Part + buf * BM2 * BF;
    for (int i = tid; i < BM2 * BF; i += NT) {
      float u = Red[i];
#pragma unroll
      for (int q = 1; q < KG; ++q) u += Red[q * BM2 * BF + i];
      part[i] = u;
    }
    // both blocks' partials are written (and the peer is past its reads of
    // this buffer, two tiles back)
    cluster.sync();
    const float* mine = part;
    const float* other = peer_part + buf * BM2 * BF;
    const float* p0 = rank == 0 ? mine : other;
    const float* p1 = rank == 0 ? other : mine;
    // h = partial(rank 0) + partial(rank 1), + b1 in fp32, gelu, one
    // rounding to bf16: the same bits in both blocks
    for (int i = tid; i < BM2 * BF; i += NT) {
      const int r = i / BF, f = i % BF;
      const bool in = f0 + f < F;
      float u = p0[i] + p1[i];
      u += in ? __bfloat162float(b1[f0 + f]) : 0.f;
      Hs[r * LDH + f] = __float2bfloat16(in ? gelu_tanh(u) : 0.f);
    }
    __syncthreads();
    // 2. acc += h @ w2[f-tile, this warp's columns]
#pragma unroll 1
    for (int k0 = 0; k0 < BF; k0 += 32) {
      uint32_t a[2][2][4];
      frag_a2(a[0], Hs, LDH, k0);
      frag_a2(a[1], Hs + 16 * LDH, LDH, k0);
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const uint4 b = frag_b2(w2t, F, H, f0 + k0, c0 + 8 * j);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma16816(acc[mt][j], a[mt][0], b.x, b.y);
          mma16816(acc[mt][j], a[mt][1], b.z, b.w);
        }
      }
    }
  }
  // the peer may still read this block's partials: leave together
  cluster.sync();

  // + b2 in fp32, one rounding to bf16
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int col = c0 + 8 * j + 2 * t;
    if (col >= H) continue;
    const float bx = __bfloat162float(b2[col]);
    const float by = __bfloat162float(b2[col + 1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int row = m0 + 16 * mt + g + 8 * hi;
        if (row >= M) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * H + col) =
            __floats2bfloat162_rn(acc[mt][j][2 * hi] + bx,
                                  acc[mt][j][2 * hi + 1] + by);
      }
  }
}

// ---------------------------------------------------------------------------
// float32 on the CUDA cores.  CPT: accumulator columns a thread owns
// (columns tid, tid + NT, ...), so a block covers NT * CPT >= H columns.
// ---------------------------------------------------------------------------
template <int CPT>
__global__ void __launch_bounds__(NT, 1)
ffn_f32(const float* __restrict__ x, const float* __restrict__ w1,
        const float* __restrict__ b1, const float* __restrict__ w2,
        const float* __restrict__ b2, float* __restrict__ out, int M, int H,
        int F) {
  extern __shared__ __align__(16) unsigned char smraw[];
  float* Xs = reinterpret_cast<float*>(smraw);  // [BM][H]
  float* Hs = Xs + BM * H;                      // [BM][BFF]
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  for (int i = tid; i < BM * H; i += NT) {
    const int r = i / H, c = i % H;
    Xs[i] = m0 + r < M ? x[(long long)(m0 + r) * H + c] : 0.f;
  }
  float acc[BM][CPT];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[r][j] = 0.f;
  // first product: warp r / lane f of the F tile (BM * BFF == NT)
  const int hr = tid / BFF, hf = tid % BFF;
  __syncthreads();

  for (int f0 = 0; f0 < F; f0 += BFF) {
    const int f = f0 + hf;
    float u = 0.f;
    if (f < F) {
      const float* xr = Xs + hr * H;
      const float* wc = w1 + f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) u = fmaf(xr[k], __ldg(wc + (long long)k * F), u);
      u = gelu_tanh(u + b1[f]);
    }
    Hs[hr * BFF + hf] = u;  // past F: zero
    __syncthreads();
    const int fn = min(BFF, F - f0);
    for (int ff = 0; ff < fn; ++ff) {
      const float* wr = w2 + (long long)(f0 + ff) * H;
      float wv[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tid + NT * j;
        wv[j] = c < H ? __ldg(wr + c) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const float hv = Hs[r * BFF + ff];
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[r][j] = fmaf(hv, wv[j], acc[r][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int c = tid + NT * j;
    if (c >= H) continue;
    const float bb = b2[c];
#pragma unroll
    for (int r = 0; r < BM; ++r)
      if (m0 + r < M) out[(long long)(m0 + r) * H + c] = acc[r][j] + bb;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int NTW>
cudaError_t launch_bf16(const void* x, const void* w1, const void* b1,
                        const void* w2, const void* b2, void* out, int M,
                        int H, int F, cudaStream_t st) {
  // each block's k range of the first product: half of H, in whole
  // 64-wide steps (KG groups of 32)
  const int KH = ((H + 1) / 2 + 63) / 64 * 64;
  const int smem = BM2 * (KH + PADS) * 2 + (KG + 2) * BM2 * BF * 4 +
                   BM2 * LDH * 2;
  cudaError_t e = allow_smem(ffn_bf16<NTW>, smem);
  if (e != cudaSuccess) return e;
  const long long tiles = (M + BM2 - 1) / BM2;
  if (2 * tiles > 2147483647LL) return cudaErrorInvalidValue;
  ffn_bf16<NTW><<<(unsigned)(2 * tiles), NT, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(b2), static_cast<bf16*>(out), M, H, F, KH);
  return cudaGetLastError();
}

template <int CPT>
cudaError_t launch_f32(const void* x, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* out, int M, int H,
                       int F, cudaStream_t st) {
  const int smem = (BM * H + BM * BFF) * 4;
  cudaError_t e = allow_smem(ffn_f32<CPT>, smem);
  if (e != cudaSuccess) return e;
  ffn_f32<CPT><<<(M + BM - 1) / BM, NT, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), M, H, F);
  return cudaGetLastError();
}

}  // namespace

// The largest hidden width the kernels take (the wrapper raises above it).
extern "C" int pt_fused_ffn_max_h() { return MAX_H; }

extern "C" int pt_fused_ffn(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* out, int M,
                            int H, int F, int dtype, void* stream) {
  if (M <= 0 || F <= 0 || H <= 0 || H % 8 || F % 8 || H > MAX_H)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    // n-tiles a warp needs for its block's half of the columns
    const int cols = (H + 255) / 256;
    if (cols <= 1) return (int)launch_bf16<1>(x, w1, b1, w2, b2, out, M, H, F, st);
    if (cols <= 2) return (int)launch_bf16<2>(x, w1, b1, w2, b2, out, M, H, F, st);
    if (cols <= 4) return (int)launch_bf16<4>(x, w1, b1, w2, b2, out, M, H, F, st);
    return (int)launch_bf16<8>(x, w1, b1, w2, b2, out, M, H, F, st);
  }
  if (dtype == 0) {
    const int cpt = (H + NT - 1) / NT;
    if (cpt <= 1) return (int)launch_f32<1>(x, w1, b1, w2, b2, out, M, H, F, st);
    if (cpt <= 2) return (int)launch_f32<2>(x, w1, b1, w2, b2, out, M, H, F, st);
    return (int)launch_f32<4>(x, w1, b1, w2, b2, out, M, H, F, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
