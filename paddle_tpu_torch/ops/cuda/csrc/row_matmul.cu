// Row-invariant matrix product y = x W for Hopper (sm_90a), float32 and
// bfloat16.
//
// Replaces no TPU kernel.  It was added for the reference's commit-bytes
// contract (paddle_tpu/models/gpt.py:1103 _paged_verify_block): the lanes a
// speculative verify accepts must commit the bytes a sequential decode
// writes.  The verify runs a block's four weight products at M = S * W rows,
// the decode at M = S.  cuBLAS picks its algorithm, and with it the order of
// each output's sum, from M, so lane 0 of a verify and the decode round
// differently.
//
// Contract: y [M, N] = x [M, K] W [K, N] in x's dtype, summed in fp32 and
// rounded once.  Every output row's bits depend only on that row of x and
// on W, never on M or on where the row lies in x.  Graph-capturable: no
// allocation, no host sync, no workspace.  Each output element is one fp32
// sum in an order fixed by K and N alone: K is split over a thread-block
// cluster of C blocks (C and the split come from K and N, never from M),
// each block sums its k range in a fixed order, and the C blocks' partials
// meet in the owning rank's shared memory (distributed shared memory) behind
// one cluster barrier, added in rank order.  Blocks over other rows run the
// same code on their rows.  The wrapper (row_matmul.py) computes the route
// and the split (_route, _plan; _k_steps lists the order) and passes them.
//
// Bound: bytes.  At the decode's shapes (M = 8; K x N = 1024 x 3072, 1024 x
// 1024, 1024 x 4096, 4096 x 1024) the product reads 2-8 MB of bf16 weights
// (0.6-2.5 us at 3.35 TB/s) and does 2 M flops a weight byte, far below the
// ~295 flops a byte at which the H100's tensor cores would bound it; at the
// verify's M = 40 still below.  Two routes:
//
// (a) row_mm_tc (bfloat16; K and N multiples of 8, x and W 16-byte aligned,
//     as TMA reads them; K <= 8192).  The product is computed transposed,
//     y^T = W^T x^T, on warp mma.sync m16n8k16 with fp32 accumulation: W is
//     the A operand (its 16-row dimension is N) and each 8-row chunk of x
//     the n8 operand.  Every chunk runs the same instruction sequence on the
//     same W fragments, and a ragged last chunk reads zero rows, so a row's
//     bits depend neither on its chunk's other rows nor on how many chunks
//     there are.  A block owns 64 output columns, up to 64 rows of x (8
//     chunks, their accumulators in registers) and kb k rows (whole 64-row
//     boxes, at most 8).  Its producer warp issues every box of the block
//     at once by TMA (128-byte swizzle), each 64-row stage's W box and x box
//     on the stage's own mbarrier, so W leaves device memory once for up to
//     64 rows of x (more rows take more blocks along grid.z, which read W
//     again; no bits change).  Eight consumer warps: four column groups of
//     16, and in each group two warps that take a stage's k16 steps in
//     turn, each chaining its steps in k order into one accumulator a chunk
//     (A by ldmatrix.trans from the swizzled W box, B by ldmatrix from the
//     swizzled x box, the next step's fragments loaded before this step's
//     products).  The block picks its chunk count once, outside the loop,
//     among eight instances of that loop, so no instruction is spent on a
//     chunk past M and no step dispatches.  The two warps' partials add in
//     shared memory in a fixed order, then go to the rank that finishes
//     their columns (16-byte stores into its shared memory).
// (b) row_mm<T, VEC> (float32, and bf16 shapes TMA cannot take): fp32 FMAs
//     on the CUDA cores (no TF32: it would not hold the port's fp32
//     tolerance of 1e-5).  K is cut into C * 16 equal ranges; a warp sums its
//     range in k order with fmaf, the 16 warps' sums are added in warp
//     order, then the ranks' in rank order.  A block owns 64 columns and an
//     8-row chunk of x (grid.z over the chunks); lanes read neighbouring
//     columns, four weight rows in flight.  (Blocks of 16 or 32 rows with
//     eight weight rows in flight measured slower on the H100.)
//
// Measured (H100 80GB HBM3, 700 W): tools/serving_kernels.py --only row
// times both routes, torch.mm, cluster sizes, cuts and a clock64()
// timeline of a block's phases; chip_smoke.py (c) times both routes
// against torch.mm and the bound (PERF.md).  The first tensor-core version
// (one warp a column group through all of a block's k steps, x staged by
// 16-byte copies, all 8 chunk slots unrolled and predicated) was no faster
// than the CUDA-core route at M = 8 (qkv 0.0101 against 0.0097 ms): its
// stage loop issued ~1,000 cycles a stage with or without weight loads
// (the dead chunk slots' instructions; cluster-scope barrier waits, which
// compile to an L1 invalidate), and x's copies queued behind W's; with no
// weight loads at all it still took 0.0091 ms, an empty launch 0.0014.
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/cuda/row_matmul.py):
// pt_row_matmul; dtype codes 0 = float32, 1 = bfloat16; routes 0 = CUDA
// cores (b), 1 = tensor cores (a).
#include "hopper.cuh"

#include <mutex>

namespace {

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// ---------------------------------------------------------------------------
// (a) tensor cores: row_mm_tc
// ---------------------------------------------------------------------------
constexpr int TC_N = 64;             // output columns of a block
constexpr int TC_CG = TC_N / 16;     // column groups: one m16 tile each
constexpr int TC_BOX = 64;           // k rows of a stage (a TMA box row)
constexpr int TC_KQ = 2;             // warps that share a stage's k16 steps
constexpr int TC_WARPS = TC_CG * TC_KQ;           // consumer warps
constexpr int TC_THREADS = 32 * (TC_WARPS + 1);   // + the producer warp
constexpr int TC_BOXB = TC_BOX * 128;             // a W box: 64 columns
constexpr int TC_STAGE = TC_BOXB * (TC_N / 64);   // a stage: TC_N columns
constexpr int TC_CHUNKS = 8;         // 8-row chunks of x a block (64 rows)
constexpr int TC_PP = TC_N + 4;      // floats a row of the warps' partials
constexpr int TC_MAX_KB = 512;       // k rows a block at most
constexpr int TC_MAX_CS = 16;        // cluster size at most
constexpr int TC_STEPS = TC_BOX / 16 / TC_KQ;     // a warp's k16 steps a stage
static_assert(TC_N % 64 == 0, "a block's columns are whole TMA boxes");
static_assert(TC_BOX / 16 % TC_KQ == 0, "a stage's k16 steps split evenly");

// x's rows a TMA box (and a block's x rows in shared memory): 8 a chunk,
// up to TC_CHUNKS chunks.  The host builds x's tensor map with it.
__host__ __device__ __forceinline__ int tc_xrows(int M) {
  return 8 * (M < 8 * TC_CHUNKS ? (M + 7) / 8 : TC_CHUNKS);
}

// Shared memory of row_mm_tc, from a 1024-byte-aligned base: the block's
// W stages [kb / 64][TC_N / 64 boxes][64 k][64 n] bf16, which the warps'
// partials [TC_KQ][mp][TC_PP] fp32 overwrite once every stage is consumed;
// its x boxes [kb / 64][xr rows][64 k] bf16 (both 128-byte swizzled, every
// stage loaded at once); the receive buffer [cs][mp][cw] fp32, where rank
// r leaves its partial of the cw columns (a multiple of 4) this block
// finishes; a barrier a stage.  Every rank of a cluster computes the same
// layout.
struct TcLayout {
  int stages, xr, mp, cs, cw;
  __host__ __device__ TcLayout(int kb, int cs_, int xr_, int mp_)
      : stages(kb / TC_BOX), xr(xr_), mp(mp_), cs(cs_),
        cw(4 * ((TC_N + 4 * cs_ - 1) / (4 * cs_))) {}
  __host__ __device__ int x_off() const {
    const int w = stages * TC_STAGE, part = TC_KQ * mp * TC_PP * 4;
    return ((w > part ? w : part) + 1023) & ~1023;
  }
  __host__ __device__ int xbox() const { return xr * 128; }
  __host__ __device__ int rb_off() const {
    return x_off() + stages * xbox();
  }
  __host__ __device__ int bar_off() const {
    return rb_off() + cs * mp * cw * 4;
  }
  __host__ __device__ int bytes() const { return bar_off() + 8 * stages; }
};

// 8 x 8 b16 matrices whose rows lanes 8i .. 8i + 7 address; .trans hands
// each thread a column pair instead of a row pair.
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// Store v to this block's shared-memory address `a` (16-byte aligned) in
// block `cta` of the cluster.
__device__ __forceinline__ void st_cluster_v4(uint32_t a, uint32_t cta,
                                              float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(mapa(a, cta)), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}
// Wait for phase `parity` of this block's barrier `bar` (CTA scope: the
// TMA loads completing on it are this block's own).
__device__ __forceinline__ void mbar_wait_cta(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// A consumer warp's products over the block's stages for NCH 8-row chunks
// of x: step i is k16 step j = kq + TC_KQ (i % TC_STEPS) of stage
// i / TC_STEPS, each step's fragments loaded while the step before it
// multiplies (two buffers), every chunk the same step into its own
// accumulator.  The kernel picks NCH once from its row count; a chunk's
// instructions are the same in every instance.  a_lane: the lane's A row
// address in stage 0; x_lane: its B row address in x box 0 (row lane % 8
// of chunk 0), xh = (lane / 8) % 2 the half of the k16 step it addresses.
template <int NCH>
__device__ __forceinline__ void tc_products(float (&acc)[TC_CHUNKS][4],
                                            uint32_t a_lane, uint32_t x_lane,
                                            int xh, int lane, uint32_t full,
                                            int stages, int kq, int xbox) {
  const int steps = stages * TC_STEPS;
  uint32_t a0[4], b0[NCH][2], a1[4], b1[NCH][2];
  auto load = [&](uint32_t (&a)[4], uint32_t (&b)[NCH][2], int i) {
    const int s = i / TC_STEPS, j = kq + TC_KQ * (i % TC_STEPS);
    if (i % TC_STEPS == 0) mbar_wait_cta(full + 8 * s, 0);
    ldsm_x4_t(a, a_lane + s * TC_STAGE + 16 * j * 128);
    // x's 16-byte chunk 2 j + xh of the row, in the 128-byte swizzle
    const uint32_t xk =
        x_lane + s * xbox + ((((2 * j + xh) ^ lane) & 7) << 4);
#pragma unroll
    for (int c = 0; c < NCH; ++c) ldsm_x2(b[c], xk + c * 8 * 128);
  };
  auto product = [&](const uint32_t (&a)[4], const uint32_t (&b)[NCH][2]) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) mma16816(acc[c], a, b[c][0], b[c][1]);
  };
  load(a0, b0, 0);
  for (int i = 0; i < steps; i += 2) {
    if (i + 1 < steps) load(a1, b1, i + 1);
    product(a0, b0);
    if (i + 1 < steps) {
      if (i + 2 < steps) load(a0, b0, i + 2);
      product(a1, b1);
    }
  }
}

// Grid (cs, column tiles, row groups), cluster (cs, 1, 1), TC_THREADS
// threads.  Block (rank q, tile j, group z): columns [TC_N j, TC_N j +
// TC_N), rows [64 z, 64 z + 64) of x, k rows [q kb, min(K, q kb + kb)).
// Consumer warp w = kq TC_CG + cg owns the 16 columns of group cg and, of
// every stage, the k16 steps kq, kq + TC_KQ, ...  tm_x: x [M, K] in boxes
// of tc_xrows(M) rows and 64 k.
__global__ void __launch_bounds__(TC_THREADS)
row_mm_tc(const __grid_constant__ CUtensorMap tm_w,
          const __grid_constant__ CUtensorMap tm_x, bf16* __restrict__ y,
          int M, int K, int N, int kb) {
  extern __shared__ __align__(1024) unsigned char smraw[];
  const uint32_t raw = smem_u32(smraw);
  const uint32_t base = (raw + 1023) & ~1023u;
  float* const gbase = reinterpret_cast<float*>(smraw + (base - raw));
  // every block of the cluster has started before any writes into another
  // one's shared memory (the wait comes after the products)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int cs = (int)cluster_size(), q = (int)cluster_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.y * TC_N, r0 = blockIdx.z * (8 * TC_CHUNKS);
  const int nch = min(TC_CHUNKS, (M - r0 + 7) / 8);
  const TcLayout L(kb, cs, tc_xrows(M), 8 * nch);
  const int k0 = q * kb, kend = min(K, k0 + kb);
  const int stages = (kend - k0 + TC_BOX - 1) / TC_BOX;
  const uint32_t full = base + L.bar_off(), sx = base + L.x_off();

  if (warp == TC_WARPS) {
    // ---------------- producer: every stage of the block at once, its x
    // box and its W boxes on its own barrier
    if (lane == 0) {
      for (int s = 0; s < stages; ++s) mbar_init(full + 8 * s, 1);
      mbar_init_fence();
      for (int s = 0; s < stages; ++s) {
        mbar_expect_tx(full + 8 * s, L.xbox() + TC_STAGE);
        tma_load(sx + s * L.xbox(), &tm_x, full + 8 * s, k0 + s * TC_BOX,
                 r0);
        for (int b = 0; b < TC_N / 64; ++b)
          tma_load(base + s * TC_STAGE + b * TC_BOXB, &tm_w, full + 8 * s,
                   n0 + 64 * b, k0 + s * TC_BOX);
      }
    }
    __syncwarp();
  }
  // the barriers are initialised before any consumer waits on them
  __syncthreads();

  float acc[TC_CHUNKS][4];
#pragma unroll
  for (int c = 0; c < TC_CHUNKS; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  const int cg = warp % TC_CG, kq = warp / TC_CG;

  if (warp < TC_WARPS) {
    // ---------------- consumers
    // A (W^T): lanes 0-7 / 8-15 address k rows 0-7 of a k16 step at the
    // group's first / second 16-byte chunk of its box, lanes 16-23 / 24-31
    // k rows 8-15; in the 128-byte swizzle chunk c of row r lies at chunk
    // c ^ (r % 8)
    const int ar = (lane & 7) + 8 * (lane >> 4);
    const int ac = 2 * (cg & 3) + ((lane >> 3) & 1);
    const uint32_t a_lane = base + (cg >> 2) * TC_BOXB + ar * 128 +
                            (((ac ^ lane) & 7) << 4);
    // B (x^T): lanes 0-7 / 8-15 address rows 0-7 of a chunk at k and
    // k + 8 of a k16 step (b0, b1)
    const uint32_t x_lane = sx + (lane & 7) * 128;
    const int xh = (lane >> 3) & 1;
    switch (nch) {
#define TC_CASE(n)                                                        \
  case n:                                                                 \
    tc_products<n>(acc, a_lane, x_lane, xh, lane, full, stages, kq,      \
                   L.xbox());                                             \
    break;
      TC_CASE(1) TC_CASE(2) TC_CASE(3) TC_CASE(4) TC_CASE(5) TC_CASE(6)
      TC_CASE(7) TC_CASE(8)
#undef TC_CASE
    }
  }

  // every warp has waited for every stage and read its last one: the
  // warps' partials go over the W stages.  Thread (g, t) holds columns
  // 16 cg + g and 16 cg + g + 8 of rows 2t and 2t + 1 of each chunk.
  __syncthreads();
  if (warp < TC_WARPS) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int c = 0; c < TC_CHUNKS; ++c) {
      if (c < nch) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            gbase[(kq * L.mp + 8 * c + 2 * t + e) * TC_PP + 16 * cg + g +
                  8 * h] = acc[c][2 * h + e];
      }
    }
  }
  __syncthreads();
  // each output's partials in k16-position order, to the rank that
  // finishes its column: rank o owns columns [o cw, o cw + cw) and keeps
  // rank q's sum in its slot q (four columns a thread)
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  const uint32_t rb = base + L.rb_off();
  for (int i = threadIdx.x; i < L.mp * (TC_N / 4); i += TC_THREADS) {
    const int m = i / (TC_N / 4), col = 4 * (i % (TC_N / 4)), o = col / L.cw;
    float4 sum = *reinterpret_cast<const float4*>(&gbase[m * TC_PP + col]);
#pragma unroll
    for (int p = 1; p < TC_KQ; ++p) {
      const float4 v = *reinterpret_cast<const float4*>(
          &gbase[(p * L.mp + m) * TC_PP + col]);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    st_cluster_v4(rb + ((q * L.mp + m) * L.cw + col - o * L.cw) * 4,
                  (uint32_t)o, sum);
  }
  cluster_sync();
  // this rank's columns: the ranks' partials summed in rank order, one
  // rounding (four columns a thread: N is a multiple of 8, so all four or
  // none lie below N)
  const float* rbf =
      reinterpret_cast<const float*>(smraw + (base - raw) + L.rb_off());
  const int c0 = q * L.cw;
  const int wq = max(0, min(TC_N, c0 + L.cw) - c0) / 4;
  const int rows = min(L.mp, M - r0);
  for (int i = threadIdx.x; i < rows * wq; i += TC_THREADS) {
    const int m = i / wq, cc = 4 * (i - m * wq), n = n0 + c0 + cc;
    if (n >= N) continue;
    float4 sum = *reinterpret_cast<const float4*>(&rbf[m * L.cw + cc]);
    for (int p = 1; p < cs; ++p) {
      const float4 v = *reinterpret_cast<const float4*>(
          &rbf[(p * L.mp + m) * L.cw + cc]);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    uint2 out;
    out.x = pack_bf16(sum.x, sum.y);
    out.y = pack_bf16(sum.z, sum.w);
    *reinterpret_cast<uint2*>(y + (long long)(r0 + m) * N + n) = out;
  }
}

// ---------------------------------------------------------------------------
// (b) CUDA cores: row_mm<T, VEC>
// ---------------------------------------------------------------------------
constexpr int WARPS = 16;            // K ranges a block
constexpr int THREADS = WARPS * 32;
constexpr int COLS = 64;             // a block's columns, two a lane
constexpr int ROWS = 8;              // a block's rows of x
constexpr int OUTS = ROWS * COLS;    // a block's outputs
constexpr int UNROLL = 4;            // weight rows a lane has in flight

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
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
    st_cluster_f32(smem_u32(&recv[q * per + i - o * per]), (uint32_t)o,
                   sum);
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

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// A bf16 [rows, cols] tensor map with boxes of [box_rows, 64], 128-byte
// swizzled (hopper.cuh bf16_map), built once per (pointer, rows, cols,
// box_rows): W's as a model serves from it, x's as a CUDA graph replays a
// launch or as the allocator hands a buffer out again.
struct MapEntry {
  const void* p;
  int rows, cols, box_rows;
  CUtensorMap map;
};
constexpr int MAP_CACHE = 1024;
MapEntry g_maps[MAP_CACHE];
int g_nmaps = 0, g_next = 0;
std::mutex g_maps_mu;

bool cached_map(CUtensorMap* m, const void* p, int rows, int cols,
                int box_rows) {
  std::lock_guard<std::mutex> lock(g_maps_mu);
  for (int i = 0; i < g_nmaps; ++i) {
    const MapEntry& e = g_maps[i];
    if (e.p == p && e.rows == rows && e.cols == cols &&
        e.box_rows == box_rows) {
      *m = e.map;
      return true;
    }
  }
  if (!bf16_map(m, p, rows, cols, box_rows)) return false;
  MapEntry& e = g_maps[g_nmaps < MAP_CACHE ? g_nmaps++ : g_next++ % MAP_CACHE];
  e = {p, rows, cols, box_rows, *m};
  return true;
}

cudaLaunchAttribute cluster_attr(int cs) {
  cudaLaunchAttribute a;
  a.id = cudaLaunchAttributeClusterDimension;
  a.val.clusterDim.x = cs;
  a.val.clusterDim.y = 1;
  a.val.clusterDim.z = 1;
  return a;
}

cudaError_t launch_tc(const void* x, const void* w, void* y, int M, int K,
                      int N, int cs, int kb, cudaStream_t st) {
  static bool smem_set = false, wide_set = false;
  const int groups = (M + 8 * TC_CHUNKS - 1) / (8 * TC_CHUNKS);
  const int tiles = (N + TC_N - 1) / TC_N;
  if (groups > 65535 || tiles > 65535) return cudaErrorInvalidValue;
  const int xr = tc_xrows(M);
  const int smem = TcLayout(kb, cs, xr, xr).bytes() + 1024;
  if (smem > 232448) return cudaErrorInvalidValue;
  CUtensorMap tw, tx;
  if (!cached_map(&tw, w, K, N, TC_BOX) || !cached_map(&tx, x, M, K, xr))
    return cudaErrorInvalidValue;
  cudaError_t e;
  if (!smem_set) {      // once: a per-call attribute would add host time
    e = cudaFuncSetAttribute(row_mm_tc,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             232448);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  if (cs > 8 && !wide_set) {   // clusters of 9-16 blocks: Hopper, opt-in
    e = cudaFuncSetAttribute(row_mm_tc,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return e;
    wide_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cs, (unsigned)tiles, (unsigned)groups);
  cfg.blockDim = dim3(TC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1] = {cluster_attr(cs)};
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, row_mm_tc, tw, tx, static_cast<bf16*>(y), M,
                         K, N, kb);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t launch_cc(const void* x, const void* w, void* y, int M, int K,
                      int N, int cs, int kchunk, cudaStream_t st) {
  const int chunks = (M + ROWS - 1) / ROWS, tiles = (N + COLS - 1) / COLS;
  if (chunks > 65535 || tiles > 65535) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cs, (unsigned)tiles, (unsigned)chunks);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1] = {cluster_attr(cs)};
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, row_mm<T, VEC>, static_cast<const T*>(x),
      static_cast<const T*>(w), static_cast<T*>(y), M, K, N, kchunk);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// y [M, N] = x [M, K] W [K, N], all contiguous rows, one dtype, on the
// route and the split the wrapper's plan gives: route 1 (tensor cores,
// bf16; K and N multiples of 8, x and W 16-byte aligned) with a cluster of
// cs blocks of kb k rows each (a multiple of 64, at most 512; every block
// gets at least one row), route 0 (CUDA cores) with a cluster of cs blocks
// of 16 ranges of kb k rows each.
extern "C" int pt_row_matmul(const void* x, const void* w, void* y, int M,
                             int K, int N, int dtype, int route, int cs,
                             int kb, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || (dtype != 0 && dtype != 1) || cs < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1 || N % 8 || K % 8 || reinterpret_cast<uintptr_t>(w) % 16 ||
        reinterpret_cast<uintptr_t>(x) % 16 || K <= 0 || cs > TC_MAX_CS ||
        kb <= 0 || kb % TC_BOX ||
        kb > TC_MAX_KB || (long long)(cs - 1) * kb >= K ||
        (long long)cs * kb < K)
      return (int)cudaErrorInvalidValue;
    return (int)launch_tc(x, w, y, M, K, N, cs, kb, st);
  }
  if (route != 0 || cs > 8 || kb < 0 || (long long)cs * WARPS * kb < K)
    return (int)cudaErrorInvalidValue;
  const size_t esz = dtype == 0 ? 4 : 2;
  const bool vec = (N % 2 == 0) &&
                   (reinterpret_cast<uintptr_t>(w) % (2 * esz) == 0);
  if (dtype == 0)
    return (int)(vec ? launch_cc<float, true>(x, w, y, M, K, N, cs, kb, st)
                     : launch_cc<float, false>(x, w, y, M, K, N, cs, kb, st));
  return (int)(vec ? launch_cc<bf16, true>(x, w, y, M, K, N, cs, kb, st)
                   : launch_cc<bf16, false>(x, w, y, M, K, N, cs, kb, st));
}

extern "C" const char* pt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
