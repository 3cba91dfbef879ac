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
// bytes: K*N bytes against 2*M*K*N flops (gpt_345m's fc1, [8, 1024] x
// [1024, 4096]: 4 MB, 1.28 us at 3.35 TB/s).  Prefill (M in the thousands)
// is bound by the tensor cores (M = 4096 there: 34 GFLOP, 0.035 ms at 989
// TFLOP/s).  The TPU kernel kept K whole in VMEM and gridded over (M, N)
// tiles.  The first Hopper port was one kernel for both: four warps of
// mma.sync on 64 x 64 tiles, staged through registers one k step at a time,
// with K split over grid.z through a global fp32 workspace for decode.  It
// lost 2.4x to cuBLAS at prefill and reached 15% of the byte bound at
// decode.  bf16 now takes one of two kernels, chosen by the wrapper from M:
//
// (a) dqmm_stream<MT>: small M (up to 16 rows: MT = 1 or 2 tiles of 8),
//     weight streaming.  A block owns 128 output columns and a k range of
//     up to 16 boxes of 64 k rows x 128 columns (8 KB, 128-byte swizzled);
//     a producer warp issues the TMA loads of all of them at once, so each
//     block has its whole share of the weights (16-128 KB) in flight from
//     its first cycle.  The product is computed transposed, out^T = W^T
//     x^T, on warp mma.sync m16n8k16: the weights are the A operand and the
//     x rows the n8 operand, so no tensor work goes to padding rows.  A
//     thread reads four 16-byte rows of the int8 tile (k rows 2t, 2t+1,
//     2t+8, 2t+9 of a k16 step, the 16 columns of its lane group) and
//     builds the A fragments of eight tiles from them by byte permutes; the
//     conversion takes a permute and an add a value (the float 2^23 + u
//     trick), no int-to-float instruction.  Eight consumer warps take the
//     block's k16 steps in turn; their partials meet in shared memory in
//     warp order.  K is split over a thread-block cluster of up to 8
//     blocks: each block stores its partial of every column straight into
//     the shared memory of the rank that finishes that column, and after
//     one cluster barrier each rank sums its columns' partials in rank
//     order: no global workspace, no atomics, and the result does not
//     depend on block timing.  x (8 or 16 rows of the block's k range) is
//     loaded once with plain 16-byte loads, so no tensor map is built for
//     it; the weight's tensor map is built once per (pointer, K, N) and
//     cached.
// (b) dqmm_wg<BM>: larger M, warp-specialised.  A persistent block walks
//     BM x 128 output tiles (BM = 256 from 768 rows, else 128); a producer
//     thread keeps TMA loads of x tiles [BM, 64] (bf16, 128-byte swizzle)
//     and int8 weight tiles [64, 128] in a 4- or 6-stage mbarrier ring.
//     The two consumer warpgroups convert each int8 tile into a
//     128-byte-swizzled bf16 tile (three of them rotate,
//     so the conversion of one k step overlaps the products of the one
//     before), which is wgmma's B operand read MN-major; each warpgroup
//     issues m64n128k16 products for its BM / 128 blocks of 64 rows (232
//     registers a consumer thread, setmaxnreg).  The conversion is
//     amortised over the tile's rows, so 256-row tiles convert half as
//     often a flop; 128-row tiles keep more SMs busy when M is a few
//     hundred.  Epilogue: times the scale in fp32, one rounding to bf16,
//     a store masked to M and N.
//
// Measured (H100 80GB HBM3, 700 W, tools/serving_kernels.py beside the
// first port's kernel in one process, operands cycled past the L2; that
// kernel in brackets): decode [8, 1024] x [1024, N] 0.0062 ms at N = 3072
// [0.0083], 0.0050 at 1024 [0.0069], 0.0073 at 4096 [0.0087], [8, 4096] x
// [4096, 1024] 0.0077 [0.0101]; prefill M = 4096: 0.096 ms at [1024, 4096]
// [0.227; cuBLAS on dequantized weights 0.096], 0.074 at [1024, 3072],
// 0.069 at [4096, 1024].  What bounds them (the tool's cuts): at decode,
// not the weight bytes (a 4 MB weight takes 7.3 us against 1.28; with no
// weight load at all a call still takes about 6 us, and neither x, the
// products nor the cluster reduction alone accounts for it); at prefill
// the conversion and the stores (0.096 ms as built, 0.080 with the
// conversion cut, 0.073 with the products or the stores cut).
//
// float32 runs on the CUDA cores (dqmm_f32, 256 threads, 4 x 4 outputs
// each, 64 x 64 tiles, K split over grid.z through an fp32 workspace and
// per-tile tickets for a few-row GEMM): TF32 would not hold the fp32
// tolerance.
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/cuda/
// dequant_matmul.py): pt_dqmm_bf16 and pt_dqmm_f32.
#include "hopper.cuh"

#include <mutex>

namespace {

constexpr int BM = 64, BN = 64;   // dqmm_f32's output tile

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
// int8 -> bf16, four values a 32-bit word
// ---------------------------------------------------------------------------
// With u = q + 128 (0..255) in the low byte of the float 2^23 (0x4B000000),
// the float is 2^23 + u; less 2^23 + 128 it is q exactly.  A float holding
// an integer of at most 8 significant bits is a bf16 in its upper half, so
// two of them pack into a bf16 pair by one byte permute.
__device__ __forceinline__ float i8_float(uint32_t u, uint32_t sel) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, sel)) - 8388736.f;
}
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
// the signed bytes b0..b3 of w -> (b0 | b1 << 16, b2 | b3 << 16) in bf16
__device__ __forceinline__ void i8x4_bf16(uint32_t w, uint32_t& lo,
                                          uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  lo = bf16_pair(i8_float(u, 0x7650), i8_float(u, 0x7651));
  hi = bf16_pair(i8_float(u, 0x7652), i8_float(u, 0x7653));
}

__device__ __forceinline__ uint4 lds128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a));
  return v;
}
__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void sts128(uint32_t a, uint32_t x, uint32_t y,
                                       uint32_t z, uint32_t w) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(a), "r"(x), "r"(y), "r"(z), "r"(w) : "memory");
}
__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile of
// 128-byte rows (the layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B).
__device__ __forceinline__ uint32_t sw128_chunk(int r, int c) {
  return r * 128 + (((c ^ r) & 7) << 4);
}

// ---------------------------------------------------------------------------
// (a) small M: dqmm_stream<MT>
// ---------------------------------------------------------------------------
constexpr int ST_N = 128;            // output columns of a block
constexpr int ST_ROWS = 64;          // k rows of a stage (one TMA box)
constexpr int ST_STAGE = ST_ROWS * ST_N;   // 8 KB of int8
constexpr int ST_SLOTS = 16;         // stages a block holds at most (128 KB)
constexpr int ST_WARPS = 8;          // consumer warps
constexpr int ST_THREADS = 32 * (ST_WARPS + 1);   // + the producer warp
constexpr int ST_PITCH = ST_N + 4;   // floats a row of the partial tiles
constexpr int ST_MAX_M = 16;

// Shared memory of dqmm_stream, from offset 0 of a 1024-byte-aligned base:
// the block's weight stages [kb / 64][64][128] int8, which the warps'
// partials [8][MP][ST_PITCH] fp32 overwrite once every stage is consumed;
// x [MP][kb + 8] bf16 (MP = 8 MT rows); the receive buffer [cs][MP][cw]
// fp32, where rank r of the cluster leaves its partial of the cw columns
// this block finishes; one barrier a stage.
struct StreamLayout {
  int stages, mp, kb, cw;
  __host__ __device__ StreamLayout(int MT, int kb_, int cs)
      : stages(kb_ / ST_ROWS), mp(8 * MT), kb(kb_),
        cw((ST_N + cs - 1) / cs) {}
  __host__ __device__ int x_pitch() const { return kb + 8; }
  __host__ __device__ int red_off() const { return 0; }
  __host__ __device__ int x_off() const {
    const int w = stages * ST_STAGE, red = ST_WARPS * mp * ST_PITCH * 4;
    return w > red ? w : red;
  }
  __host__ __device__ int rb_off() const {
    return x_off() + mp * x_pitch() * 2;
  }
  __host__ __device__ int bar_off(int cs) const {
    return rb_off() + cs * mp * cw * 4;
  }
  __host__ __device__ int bytes(int cs) const {
    return bar_off(cs) + 8 * stages;
  }
};

// Grid (cs, column tiles), cluster (cs, 1, 1).  Block (rank r, tile j)
// owns columns [128 j, 128 j + 128) and k rows [r kb, min(K, r kb + kb));
// kb is a multiple of 64, at most 16 stages.  Consumer warp w takes the
// block's k16 steps w, w + 8, ... for all M <= 8 MT rows.
template <int MT>
__global__ void __launch_bounds__(ST_THREADS)
dqmm_stream(const __grid_constant__ CUtensorMap tm_w,
            const bf16* __restrict__ x, long long lda,
            const float* __restrict__ scale, bf16* __restrict__ out, int M,
            int N, int K, int kb) {
  extern __shared__ __align__(1024) unsigned char smraw[];
  const uint32_t raw = smem_u32(smraw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smraw + (base - raw);
  uint32_t ncta;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(ncta));
  const int cs = (int)ncta, rank = (int)cluster_rank();
  const StreamLayout L(MT, kb, cs);
  const int n0 = blockIdx.y * ST_N;
  const int k0 = rank * kb, kend = min(K, k0 + kb);
  const int stages = cdiv(kend - k0, ST_ROWS);
  const uint32_t full = base + L.bar_off(cs);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the scale of the columns this rank finishes (at most one a thread):
  // loaded now, not behind the cluster barrier
  const int c0 = rank * L.cw, w = min(ST_N, c0 + L.cw) - c0;
  const int my_c = threadIdx.x % max(w, 1);
  const float my_scale =
      warp < ST_WARPS && w > 0 && n0 + c0 + my_c < N
          ? __ldg(scale + n0 + c0 + my_c) : 0.f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) mbar_init(full + 8 * i, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const uint32_t rb = base + L.rb_off();
  if (warp == ST_WARPS) {
    // ---------------- producer: every stage of the block at once
    if (lane == 0) {
      for (int i = 0; i < stages; ++i) {
        mbar_expect_tx(full + 8 * i, ST_STAGE);
        tma_load(base + i * ST_STAGE, &tm_w, full + 8 * i, n0,
                 k0 + i * ST_ROWS);
      }
    }
  } else {
    // ---------------- consumers
    const int tid = threadIdx.x;                 // 0..255
    const int g = lane >> 2, t = lane & 3;
    // x rows [0, MP) of this block's k range, zero past M and K
    const uint32_t sx = base + L.x_off();
    const int xp = L.x_pitch(), chunks = kb / 8;
    for (int i = tid; i < L.mp * chunks; i += 32 * ST_WARPS) {
      const int m = i / chunks, c = 8 * (i % chunks);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m < M && k0 + c < kend)
        v = __ldg(reinterpret_cast<const uint4*>(x + m * lda + k0 + c));
      sts128(sx + (m * xp + c) * 2, v.x, v.y, v.z, v.w);
    }
    named_sync(1, 32 * ST_WARPS);

    float acc[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int T = 0; T < 8; ++T)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][T][e] = 0.f;

    for (int st = warp; st < 4 * stages; st += ST_WARPS) {
      const int i = st >> 2;                     // stage
      mbar_wait(full + 8 * i, 0);
      const uint32_t sw = base + i * ST_STAGE;
      const int r = 16 * (st & 3) + 2 * t;       // row of the stage
      const uint4 r0 = lds128(sw + sw128_chunk(r, g));
      const uint4 r1 = lds128(sw + sw128_chunk(r + 1, g));
      const uint4 r2 = lds128(sw + sw128_chunk(r + 8, g));
      const uint4 r3 = lds128(sw + sw128_chunk(r + 9, g));
      const int kl = 16 * st + 2 * t;            // k in the block
      uint32_t b[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint32_t xa = sx + ((8 * mt + g) * xp + kl) * 2;
        b[mt][0] = lds32(xa);
        b[mt][1] = lds32(xa + 16);
      }
      // tile T: rows g, g + 8 are columns 16 g + 2T, 16 g + 2T + 1 (bytes
      // 2T, 2T + 1 of the thread's chunks)
#pragma unroll
      for (int T = 0; T < 8; ++T) {
        const uint32_t sel = (T & 1) ? 0x7362 : 0x5140;
        uint32_t a[4];
        i8x4_bf16(__byte_perm(word(r0, T >> 1), word(r1, T >> 1), sel), a[0],
                  a[1]);
        i8x4_bf16(__byte_perm(word(r2, T >> 1), word(r3, T >> 1), sel), a[2],
                  a[3]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma16816(acc[mt][T], a, b[mt][0], b[mt][1]);
      }
    }

    // the partials overwrite the weight stages: every stage has landed
    // (a warp with no step in a stage has not waited for it) and every
    // warp is done reading
    for (int i = 0; i < stages; ++i) mbar_wait(full + 8 * i, 0);
    named_sync(1, 32 * ST_WARPS);
    // this warp's partial: the thread holds columns 16 g .. 16 g + 15 of
    // rows 2t, 2t + 1 of each n8 tile
    const uint32_t red = base + L.red_off() + warp * L.mp * ST_PITCH * 4;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 8 * mt + 2 * t + h;
        const uint32_t dst = red + (m * ST_PITCH + 16 * g) * 4;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          sts128(dst + 16 * q,
                 __float_as_uint(acc[mt][2 * q][h]),
                 __float_as_uint(acc[mt][2 * q][2 + h]),
                 __float_as_uint(acc[mt][2 * q + 1][h]),
                 __float_as_uint(acc[mt][2 * q + 1][2 + h]));
      }
    named_sync(1, 32 * ST_WARPS);
    // the warps' partials, summed in warp order, go to the rank that
    // finishes their columns: rank o owns [o cw, o cw + cw) and receives
    // rank r's partial in its slot r
    const float* redf =
        reinterpret_cast<const float*>(gbase + L.red_off());
    for (int m = tid / ST_N; m < L.mp; m += 32 * ST_WARPS / ST_N) {
      const int c = tid % ST_N;
      float part[ST_WARPS];
#pragma unroll
      for (int q = 0; q < ST_WARPS; ++q)
        part[q] = redf[(q * L.mp + m) * ST_PITCH + c];
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < ST_WARPS; ++q) sum += part[q];
      const int o = c / L.cw;
      const uint32_t dst =
          rb + ((rank * L.mp + m) * L.cw + (c - o * L.cw)) * 4;
      st_cluster_f32(dst, o, sum);
    }
  }
  // every rank's partials have reached their owners
  __syncwarp();
  cluster_sync();
  if (warp < ST_WARPS) {
    // this rank's columns: the ranks' partials summed in rank order, times
    // the scale, one rounding (256 is a multiple of w, so a thread keeps
    // its column and its scale)
    const float* rbf = reinterpret_cast<const float*>(gbase + L.rb_off());
    for (int i = threadIdx.x; i < M * w; i += 32 * ST_WARPS) {
      const int m = i / w, c = i % w, n = n0 + c0 + c;
      if (n >= N) continue;
      float part[16];
#pragma unroll
      for (int q = 0; q < 16; ++q)
        part[q] = q < cs ? rbf[(q * L.mp + m) * L.cw + c] : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < 16; ++q) sum += part[q];
      const float sc = (256 % w == 0) ? my_scale : __ldg(scale + n);
      out[(long long)m * N + n] = __float2bfloat16(sum * sc);
    }
  }
}

// ---------------------------------------------------------------------------
// (b) large M: dqmm_wg
// ---------------------------------------------------------------------------
constexpr int WG_BK = 64;            // k step (128 bytes of bf16 x)
constexpr int WG_THREADS = 384;      // consumer warpgroups 0, 1; producer 2
constexpr int TN = 128;              // columns of a tile

// BM rows a tile (128 or 256): each consumer warpgroup owns BM / 2 rows,
// MH = BM / 128 blocks of 64
template <int BM>
struct WgLayout {
  static constexpr int MH = BM / 128;
  static constexpr int ST = MH == 2 ? 4 : 6;      // ring stages
  static constexpr int NB = 3;                    // converted bf16 tiles
  static constexpr int X_BYTES = BM * WG_BK * 2;      // 16 or 32 KB
  static constexpr int W_BYTES = WG_BK * TN;          // int8, 128-col boxes
  static constexpr int B_BYTES = WG_BK * TN * 2;      // bf16, 64-col boxes
  static constexpr int X = 0;
  static constexpr int W = X + ST * X_BYTES;
  static constexpr int B = W + ST * W_BYTES;
  static constexpr int BAR = B + NB * B_BYTES;
  static constexpr int BYTES = BAR + 16 * ST;
  static constexpr int ALLOC = BYTES + 1024;
};
static_assert(WgLayout<128>::ALLOC <= 232448 &&
                  WgLayout<256>::ALLOC <= 232448,
              "dqmm_wg fits");

// Convert the int8 tile at `w` ([64 k][TN], 128-column boxes of 128-byte
// swizzled rows) into the bf16 tile at `b` ([64 k][TN], 64-column boxes of
// 128-byte swizzled rows: wgmma's MN-major B layout); consumer thread `ct`
// of 256 takes 16-column chunks ct, ct + 256, ...
__device__ __forceinline__ void convert_tile(uint32_t w, uint32_t b, int ct) {
  constexpr int CPR = TN / 16;                    // chunks a row
#pragma unroll
  for (int i = 0; i < WG_BK * CPR / 256; ++i) {
    const int q = ct + 256 * i, k = q / CPR, c = q % CPR;
    const uint4 v = lds128(w + (c / 8) * (WG_BK * 128) + sw128_chunk(k, c % 8));
    uint32_t o[8];
    i8x4_bf16(v.x, o[0], o[1]);
    i8x4_bf16(v.y, o[2], o[3]);
    i8x4_bf16(v.z, o[4], o[5]);
    i8x4_bf16(v.w, o[6], o[7]);
    // 16 columns from 16 c: bf16 box c / 4, chunks 2 (c % 4) and + 1; the
    // odd-numbered half of a row's threads stores its second chunk first,
    // so the eight threads of a row hit eight distinct bank groups
    // (selects, not an index into o, which would put o in local memory)
    const uint32_t row = b + (c / 4) * (WG_BK * 128);
    const int q0 = 2 * (c % 4);
    const int first = (c & 4) ? 1 : 0;
    const uint4 lo = make_uint4(o[0], o[1], o[2], o[3]);
    const uint4 hi = make_uint4(o[4], o[5], o[6], o[7]);
    const uint4 a = first ? hi : lo, z = first ? lo : hi;
    sts128(row + sw128_chunk(k, q0 + first), a.x, a.y, a.z, a.w);
    sts128(row + sw128_chunk(k, q0 + 1 - first), z.x, z.y, z.z, z.w);
  }
}

template <int BM>
__global__ void __launch_bounds__(WG_THREADS, 1)
dqmm_wg(const __grid_constant__ CUtensorMap tm_x,
        const __grid_constant__ CUtensorMap tm_w,
        const float* __restrict__ scale, bf16* __restrict__ out, int M, int N,
        int K) {
  using L = WgLayout<BM>;
  constexpr int MH = L::MH;
  constexpr int ST = L::ST;
  extern __shared__ __align__(1024) unsigned char smraw[];
  const uint32_t base = (smem_u32(smraw) + 1023) & ~1023u;
  const uint32_t sx = base + L::X, sw = base + L::W, sb = base + L::B;
  const uint32_t full = base + L::BAR, empty = full + 8 * ST;
  const int tn = cdiv(N, TN), tiles = cdiv(M, BM) * tn;
  const int KT = cdiv(K, WG_BK);
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 2);     // both consumer warpgroups
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int s = 0, ph = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tn) * BM, n0 = (tile % tn) * TN;
        for (int kb = 0; kb < KT; ++kb) {
          mbar_wait(empty + 8 * s, ph ^ 1);
          mbar_expect_tx(full + 8 * s, L::X_BYTES + L::W_BYTES);
          tma_load(sx + s * L::X_BYTES, &tm_x, full + 8 * s, kb * WG_BK, m0);
#pragma unroll
          for (int j = 0; j < TN / 128; ++j)
            tma_load(sw + s * L::W_BYTES + j * (WG_BK * 128), &tm_w,
                     full + 8 * s, n0 + 128 * j, kb * WG_BK);
          if (++s == ST) { s = 0; ph ^= 1; }
        }
      }
    }
  } else {
    // ---------------- consumers: warpgroup wg owns rows [wg BM / 2,
    // wg BM / 2 + BM / 2) of the tile, MH blocks of 64
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ct = threadIdx.x;                 // 0..255
    const int w = (ct >> 5) & 3, lane = ct & 31;
    const int g = lane >> 2, t = lane & 3;
    int s = 0, ph = 0, cb = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tn) * BM, n0 = (tile % tn) * TN;
      float acc[MH][TN / 2];
#pragma unroll
      for (int h = 0; h < MH; ++h)
#pragma unroll
        for (int i = 0; i < TN / 2; ++i) acc[h][i] = 0.f;
      int prev = -1;
      for (int kb = 0; kb < KT; ++kb) {
        mbar_wait(full + 8 * s, ph);
        // the bf16 tile cb was last read by the products of three k steps
        // ago, which both warpgroups have waited for before the barrier
        // of the k step before this one
        const uint32_t bt = sb + cb * L::B_BYTES;
        convert_tile(sw + s * L::W_BYTES, bt, ct);
        fence_async_smem();
        named_sync(3, 256);
        const uint32_t xa = sx + s * L::X_BYTES + wg * (BM / 2) * 128;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < WG_BK / 16; ++ks) {
          // A: 128-byte rows of x, K-major; B: 128-byte rows of the bf16
          // tile (k), 64-column boxes 8 KB apart along N
          const uint64_t db = sw128_desc(bt + ks * 2048, WG_BK * 128, 1024);
#pragma unroll
          for (int h = 0; h < MH; ++h)
            wgmma_ss<TN, 0, 1>(
                acc[h], sw128_desc(xa + h * 64 * 128 + ks * 32, 16, 1024),
                db);
        }
        wgmma_commit();
        wgmma_wait<1>();          // the previous k step's products are done
        if (prev >= 0) {
          wg_sync(wg);
          if ((ct & 127) == 0) mbar_arrive(empty + 8 * prev);
        }
        prev = s;
        if (++s == ST) { s = 0; ph ^= 1; }
        if (++cb == L::NB) cb = 0;
      }
      wgmma_wait<0>();
      if (prev >= 0) {
        wg_sync(wg);
        if ((ct & 127) == 0) mbar_arrive(empty + 8 * prev);
      }
      // times the scale in fp32, one rounding, masked to M and N
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;      // N is a multiple of 16
        if (col >= N) continue;
        const float s0 = __ldg(scale + col), s1 = __ldg(scale + col + 1);
#pragma unroll
        for (int h = 0; h < MH; ++h)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int rr = m0 + wg * (BM / 2) + h * 64 + w * 16 + g +
                           8 * hi;
            if (rr < M)
              *reinterpret_cast<__nv_bfloat162*>(out + (long long)rr * N +
                                                 col) =
                  __floats2bfloat162_rn(acc[h][4 * j + 2 * hi] * s0,
                                        acc[h][4 * j + 2 * hi + 1] * s1);
          }
      }
    }
  }
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

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
namespace {

// The int8 weight's tensor map (boxes of 64 k rows x 128 columns, 128-byte
// swizzled; both bf16 kernels read it so), built once per (pointer, K, N):
// a model's weights do not move while it serves.
struct WeightMap {
  const void* p;
  int K, N;
  CUtensorMap map;
};
constexpr int MAP_CACHE = 1024;
WeightMap g_maps[MAP_CACHE];
int g_nmaps = 0, g_next = 0;
std::mutex g_maps_mu;

bool weight_map(CUtensorMap* m, const void* w, int K, int N) {
  std::lock_guard<std::mutex> lock(g_maps_mu);
  for (int i = 0; i < g_nmaps; ++i)
    if (g_maps[i].p == w && g_maps[i].K == K && g_maps[i].N == N) {
      *m = g_maps[i].map;
      return true;
    }
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t strides[1] = {(cuuint64_t)N};
  const cuuint32_t box[2] = {(cuuint32_t)ST_N, (cuuint32_t)ST_ROWS};
  if (!tensor_map(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, dims, strides, box,
                  CU_TENSOR_MAP_SWIZZLE_128B))
    return false;
  WeightMap& e = g_maps[g_nmaps < MAP_CACHE ? g_nmaps++ : g_next++ % MAP_CACHE];
  e.p = w;
  e.K = K;
  e.N = N;
  e.map = *m;
  return true;
}

// The largest dynamic shared memory a kernel may take, set once per
// kernel (a per-call cudaFuncSetAttribute would add host time).
template <typename F>
cudaError_t allow_smem(F* kernel, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (e == cudaSuccess) done = true;
  return e;
}

template <int MT>
cudaError_t launch_stream(const CUtensorMap& tw, const bf16* x,
                          long long lda, const float* scale, bf16* out, int M,
                          int N, int K, int cs, int kb, cudaStream_t st) {
  static bool smem_set = false, wide_set = false;
  const StreamLayout L(MT, kb, cs);
  const int smem = L.bytes(cs) + 1024;
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(dqmm_stream<MT>, smem_set);
  if (e != cudaSuccess) return e;
  if (cs > 8 && !wide_set) {   // clusters of 9-16 blocks: Hopper, opt-in
    e = cudaFuncSetAttribute(dqmm_stream<MT>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return e;
    wide_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cs, (unsigned)((N + ST_N - 1) / ST_N), 1);
  cfg.blockDim = dim3(ST_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, dqmm_stream<MT>, tw, x, lda, scale, out, M, N,
                         K, kb);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_wg(const CUtensorMap& tw, const bf16* x, long long lda,
                      const float* scale, bf16* out, int M, int N, int K,
                      int sms, cudaStream_t st) {
  static bool smem_set = false;
  // x [M, K] with rows lda apart, boxes [128 rows, 64 k], 128-byte swizzle
  CUtensorMap tx;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)lda * 2};
  const cuuint32_t box[2] = {(cuuint32_t)WG_BK, (cuuint32_t)BM};
  if (!tensor_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, dims, strides,
                  box, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(dqmm_wg<BM>, smem_set);
  if (e != cudaSuccess) return e;
  const long long tiles =
      (long long)((M + BM - 1) / BM) * ((N + TN - 1) / TN);
  if (tiles > 2147483647LL) return cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);
  dqmm_wg<BM><<<grid, WG_THREADS, WgLayout<BM>::ALLOC, st>>>(
      tx, tw, scale, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// bf16.  regime 0: dqmm_stream with a cluster of cs blocks over K (up to
// 16), kb k rows a block (a multiple of 64, at most 1024; every block gets
// at least one row); regimes 1 and 2: dqmm_wg with 128- or 256-row tiles
// on at most `sms` persistent blocks.
extern "C" int pt_dqmm_bf16(const void* x, long long lda, const void* w,
                            const float* scale, void* out, int M, int N,
                            int K, int regime, int cs, int kb, int sms,
                            void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 16 || K % 8 || lda < K || lda % 8)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tw;
  if (!weight_map(&tw, w, K, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* ob = static_cast<bf16*>(out);
  if (regime == 0) {
    if (M > ST_MAX_M || cs < 1 || cs > 16 || kb <= 0 || kb % ST_ROWS ||
        kb > ST_SLOTS * ST_ROWS ||
        (long long)(cs - 1) * kb >= K || (long long)cs * kb < K ||
        (N + ST_N - 1) / ST_N > 65535)
      return (int)cudaErrorInvalidValue;
    return (int)(M <= 8 ? launch_stream<1>(tw, xb, lda, scale, ob, M, N, K,
                                           cs, kb, st)
                        : launch_stream<2>(tw, xb, lda, scale, ob, M, N, K,
                                           cs, kb, st));
  }
  if (regime == 1 || regime == 2) {
    if (sms <= 0) return (int)cudaErrorInvalidValue;
    return (int)(regime == 1
                     ? launch_wg<128>(tw, xb, lda, scale, ob, M, N, K, sms, st)
                     : launch_wg<256>(tw, xb, lda, scale, ob, M, N, K, sms,
                                      st));
  }
  return (int)cudaErrorInvalidValue;
}

// k depth of one dqmm_f32 step (the wrapper sizes its splits with it)
extern "C" int pt_dqmm_f32_bk() { return BKF; }

extern "C" int pt_dqmm_f32(const void* x, long long lda, const void* w,
                           const float* scale, void* out, float* ws,
                           int* tickets, int M, int N, int K, int tpb,
                           int ksplit, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 16 || K % 8 || lda < K ||
      tpb <= 0 || ksplit <= 0)
    return (int)cudaErrorInvalidValue;
  const int kt = (K + BKF - 1) / BKF;
  if ((ksplit - 1) * tpb >= kt || ksplit * tpb < kt)
    return (int)cudaErrorInvalidValue;   // a split with no k step, or a gap
  const long long mt = (M + BM - 1) / BM;
  if (mt > 65535 || ksplit > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (unsigned)mt, ksplit);
  dqmm_f32<<<grid, TF, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), lda, static_cast<const int8_t*>(w), scale,
      static_cast<float*>(out), ws, tickets, M, N, K, tpb, ksplit);
  return (int)cudaGetLastError();
}

extern "C" const char* pt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
