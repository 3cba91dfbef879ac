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
// LayerNorm prologue: ln_row_mm_tc and ln_row_mm compute y = LN(x; g, b,
// eps) W on the same two routes, one launch where the decode and the verify
// launched the LayerNorm kernel and then the product.  On that path they
// replace the TPU kernel paddle_tpu/ops/pallas/norms.py::_ln_kernel (which
// the reference's layer_norm leaves to XLA at these row counts, fused into
// the einsum that reads it) with its arithmetic: the row mean and the
// two-pass variance mean((x - mu)^2) in fp32, rs = rsqrt(var + eps),
// ((x - mu) rs) g + b in fp32 with g and b float32 or bfloat16, rounded to
// x's type; that is what the product reads.  At 8-40 rows the LayerNorm
// alone was all launch (2.9 us against a 0.01-0.05 us bound).  K is split
// over the cluster, so no block's own k range holds a row, and the moments
// need the whole row: every block computes them for its rows itself, in an
// order fixed by K alone (row_moments; row_matmul.py _ln_order lists it),
// so every rank, every column tile and every row group holds the same bits
// for a row and none depends on M.  ln_row_mm_tc (tc_ln_prologue): TMA
// brings the block's rows of x whole before W's stages, the consumer warps
// sum the moments from shared memory and normalise the block's own k range
// in place, where the product reads it (the block's shared memory holds
// K x 64 rows of x beside its W stages: row_matmul.py _ln_route keeps this
// route where that fits, K up to about 1,150).  ln_row_mm normalises each
// x element as its loop reads it, after one warp a row has summed the
// moments from L2.  The products and merges are the routes' own.
// Measured (tools/serving_kernels.py --only ln): loads a thread issues
// after W's TMA stream wait behind it, and so does traffic between the
// SMs of a cluster; versions that read rows from L2 behind W, or summed
// each rank's k range and exchanged the sums in distributed shared memory
// (behind cluster barriers or per-warp mbarriers), took 1.5-2.2x the
// product alone at M = 8, and normalising the B fragments in registers
// after ldmatrix (four column groups redoing each element) cost more than
// normalising x once in shared memory.
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
// pt_row_matmul, pt_ln_row_matmul; dtype codes 0 = float32, 1 = bfloat16;
// routes 0 = CUDA cores (b), 1 = tensor cores (a).
#include "hopper.cuh"

#include <mutex>

namespace {

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

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

// ---------------------------------------------------------------------------
// the LayerNorm prologue
// ---------------------------------------------------------------------------
constexpr int LN_GROUP = 8;          // a lane's elements before the next lane's

// Elements k0 .. k0 + 7 of a row as floats, those at or past H zero.  vec:
// the row starts 16-byte aligned and H * sizeof(T) is a multiple of 16, so
// a group wholly inside H is one or two 16-byte loads.
template <typename T>
__device__ __forceinline__ void load_group(const T* __restrict__ p, int k0,
                                           int H, bool vec,
                                           float (&v)[LN_GROUP]) {
  if (vec && k0 + LN_GROUP <= H) {
    constexpr int PER = 16 / (int)sizeof(T);
#pragma unroll
    for (int c = 0; c < LN_GROUP / PER; ++c) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p + k0) + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < PER; ++i) v[c * PER + i] = to_f(e[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < LN_GROUP; ++i)
      v[i] = k0 + i < H ? to_f(p[k0 + i]) : 0.f;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sum of 8 values as a pairwise tree, ((0 + 1) + (2 + 3)) + ((4 + 5) +
// (6 + 7)), each add rounded: a short chain for a group of a row.
__device__ __forceinline__ float tree8(const float (&t)[LN_GROUP]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(t[0], t[1]), __fadd_rn(t[2], t[3])),
                   __fadd_rn(__fadd_rn(t[4], t[5]), __fadd_rn(t[6], t[7])));
}

// The mean and rs = rsqrt(var + eps) of row p[0, H), var the mean of
// (x - mu)^2, in fp32, computed by one warp; every lane gets the same bits.
// Lane l adds the groups l, l + 32, l + 64, ... (k in [8 j, 8 j + 8) for
// group j, each a tree8 with zeros past H) in k order; the lanes' sums
// meet over xor distances 16, 8, 4, 2, 1 (each step adds two equal-bit
// pairs, so every lane ends with the same sum).  Both moments take that
// order, which depends on H alone; every step is rounded on its own (no
// contraction), so it is the same in every instance and load path.
template <typename T>
__device__ __forceinline__ void row_moments(const T* __restrict__ p, int H,
                                            bool vec, float eps, int lane,
                                            float& mu, float& rs) {
  float s = 0.f, q = 0.f, v[LN_GROUP], t[LN_GROUP];
#pragma unroll 4
  for (int k0 = LN_GROUP * lane; k0 < H; k0 += 32 * LN_GROUP) {
    load_group(p, k0, H, vec, v);     // zeros past H
    s = __fadd_rn(s, tree8(v));
  }
  mu = __fdiv_rn(warp_sum(s), (float)H);
#pragma unroll 4
  for (int k0 = LN_GROUP * lane; k0 < H; k0 += 32 * LN_GROUP) {
    load_group(p, k0, H, vec, v);     // again, from L1
#pragma unroll
    for (int i = 0; i < LN_GROUP; ++i) {
      const float d = __fsub_rn(v[i], mu);
      t[i] = k0 + i < H ? __fmul_rn(d, d) : 0.f;
    }
    q = __fadd_rn(q, tree8(t));
  }
  rs = __frsqrt_rn(__fadd_rn(__fdiv_rn(warp_sum(q), (float)H), eps));
}

// ((v - mu) rs) g + b, each step rounded in fp32 (as the reference's
// _ln_kernel computes it)
__device__ __forceinline__ float ln_affine(float v, float mu, float rs,
                                           float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mu), rs), g), b);
}

template <typename T>
__device__ __forceinline__ bool rows_vec(const T* p, int H) {
  return !(reinterpret_cast<uintptr_t>(p) % 16) &&
         !((long long)H * (long long)sizeof(T) % 16);
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
// finishes; a barrier a stage, and one for the LayerNorm prologue's x.
// With the prologue the x boxes hold the block's rows whole, xb =
// ceil(K / 64) boxes (box j: k 64 j .. 64 j + 63), not one a stage.
// Every rank of a cluster computes the same layout.
struct TcLayout {
  int stages, xr, mp, cs, cw, xb;
  __host__ __device__ TcLayout(int kb, int cs_, int xr_, int mp_,
                               int xb_ = 0)
      : stages(kb / TC_BOX), xr(xr_), mp(mp_), cs(cs_),
        cw(4 * ((TC_N + 4 * cs_ - 1) / (4 * cs_))),
        xb(xb_ ? xb_ : kb / TC_BOX) {}
  __host__ __device__ int x_off() const {
    const int w = stages * TC_STAGE, part = TC_KQ * mp * TC_PP * 4;
    return ((w > part ? w : part) + 1023) & ~1023;
  }
  __host__ __device__ int xbox() const { return xr * 128; }
  __host__ __device__ int rb_off() const { return x_off() + xb * xbox(); }
  __host__ __device__ int bar_off() const {
    return rb_off() + cs * mp * cw * 4;
  }
  __host__ __device__ int bytes() const {
    return bar_off() + 8 * (stages + 1);
  }
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

// Element e of 8 bf16 values packed in u, as a float.
__device__ __forceinline__ float bf16_at(const uint4& u, int e) {
  const uint32_t w = (&u.x)[e >> 1];
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

// Element e of the 8 values of g's type G packed in r (two uint4 of
// float32, one of bfloat16), as a float.
template <typename G>
__device__ __forceinline__ float group_at(const uint4* r, int e) {
  if constexpr (sizeof(G) == 4)
    return __uint_as_float((&r[e >> 2].x)[e & 3]);
  else
    return bf16_at(r[0], e);
}

// The LayerNorm prologue of ln_row_mm_tc, run by the TC_WARPS consumer
// warps.  The producer loads the block's rows of x whole (ceil(K / 64)
// boxes on barrier xfull) before any stage of W, and issues nothing
// before the consumers have issued their loads of g and b (named barrier
// 2, which also shows them the barriers' inits): loads issued behind W's
// TMA stream wait for it.  Consumer warp w takes rows w, w + TC_WARPS, ...
// of the block, one at a time (two or eight side by side measured slower),
// and sums each row's moments from shared memory in row_moments' order
// (lane l its 8-element groups l, l + 32, ... in k order, each a tree8,
// then the lanes over xor distances 16 .. 1), which depends on K alone:
// every rank of a cluster, every column tile and every row group computes
// the same bits for a row, whatever M is, with nothing exchanged between
// blocks.  Then it normalises this rank's k range of the row in place,
// where the product reads it, rounded to bf16 (rows past M and k past K
// stay the zeros TMA wrote).  g and b are 16-byte aligned (the C entry
// checks).
template <typename G>
__device__ __forceinline__ void tc_ln_prologue(
    const G* __restrict__ g, const G* __restrict__ b, float eps,
    unsigned char* xs, int xbox, uint32_t xfull, int M, int K, int r0,
    int mp, int k0, int stages, int warp, int lane) {
  constexpr int GU = (int)sizeof(G) / 2;   // uint4 a group of g or b
  const int ng = (min(K, k0 + stages * TC_BOX) - k0) / LN_GROUP;
  const int kg = K / LN_GROUP;             // a row's groups (K % 8 == 0)
  const int rows = min(mp, M - r0);
  uint4 gr[2][GU], br[2][GU];
#pragma unroll
  for (int h = 0; h < 2; ++h) {            // groups l, l + 32 of the range
    const int j = lane + 32 * h;
#pragma unroll
    for (int u = 0; u < GU; ++u) {
      gr[h][u] = br[h][u] = make_uint4(0u, 0u, 0u, 0u);
      if (j < ng) {
        gr[h][u] = __ldg(reinterpret_cast<const uint4*>(
                             g + k0 + LN_GROUP * j) + u);
        br[h][u] = __ldg(reinterpret_cast<const uint4*>(
                             b + k0 + LN_GROUP * j) + u);
      }
    }
  }
  named_sync(2, TC_THREADS);
  mbar_wait_cta(xfull, 0);
  // group j (k 8 j .. 8 j + 7) of row m in the swizzled boxes
  auto chunk = [&](int m, int j) {
    return reinterpret_cast<uint4*>(xs + (j >> 3) * xbox + m * 128 +
                                    ((((j & 7) ^ m) & 7) << 4));
  };
  for (int m = warp; m < rows; m += TC_WARPS) {
    float s = 0.f, q = 0.f, t[LN_GROUP];
#pragma unroll 4
    for (int j = lane; j < kg; j += 32) {
      const uint4 u = *chunk(m, j);
#pragma unroll
      for (int e = 0; e < LN_GROUP; ++e) t[e] = bf16_at(u, e);
      s = __fadd_rn(s, tree8(t));
    }
    const float mu = __fdiv_rn(warp_sum(s), (float)K);
#pragma unroll 4
    for (int j = lane; j < kg; j += 32) {
      const uint4 u = *chunk(m, j);
#pragma unroll
      for (int e = 0; e < LN_GROUP; ++e) {
        const float d = __fsub_rn(bf16_at(u, e), mu);
        t[e] = __fmul_rn(d, d);
      }
      q = __fadd_rn(q, tree8(t));
    }
    // (the shuffles also order every lane's reads of the row before any
    // lane's writes)
    const float rs =
        __frsqrt_rn(__fadd_rn(__fdiv_rn(warp_sum(q), (float)K), eps));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
      if (j < ng) {
        uint4* p = chunk(m, k0 / LN_GROUP + j);
        const uint4 u = *p;
        float o[LN_GROUP];
#pragma unroll
        for (int e = 0; e < LN_GROUP; ++e)
          o[e] = ln_affine(bf16_at(u, e), mu, rs, group_at<G>(gr[h], e),
                           group_at<G>(br[h], e));
        *p = make_uint4(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]),
                        pack_bf16(o[4], o[5]), pack_bf16(o[6], o[7]));
      }
    }
  }
}

// Grid (cs, column tiles, row groups), cluster (cs, 1, 1), TC_THREADS
// threads.  Block (rank q, tile j, group z): columns [TC_N j, TC_N j +
// TC_N), rows [64 z, 64 z + 64) of x, k rows [q kb, min(K, q kb + kb)).
// Consumer warp w = kq TC_CG + cg owns the 16 columns of group cg and, of
// every stage, the k16 steps kq, kq + TC_KQ, ...  tm_x: x [M, K] in boxes
// of tc_xrows(M) rows and 64 k.  LN: the block's rows of x come whole, and
// tc_ln_prologue normalises them with g, b and eps.
template <bool LN, typename G>
__device__ __forceinline__ void tc_body(const CUtensorMap& tm_w,
                                        const CUtensorMap& tm_x,
                                        const G* __restrict__ g,
                                        const G* __restrict__ b, float eps,
                                        bf16* __restrict__ y, int M, int K,
                                        int N, int kb) {
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
  const int xb = LN ? (K + TC_BOX - 1) / TC_BOX : 0;   // LN: whole rows
  const TcLayout L(kb, cs, tc_xrows(M), 8 * nch, xb);
  const int k0 = q * kb, kend = min(K, k0 + kb);
  const int stages = (kend - k0 + TC_BOX - 1) / TC_BOX;
  const uint32_t full = base + L.bar_off(), sx = base + L.x_off();
  const uint32_t xfull = full + 8 * stages;     // LN: the rows' barrier

  if (warp == TC_WARPS) {
    // ---------------- producer: every stage of the block at once, its x
    // box and its W boxes on its own barrier
    if (lane == 0) {
      for (int s = 0; s < stages; ++s) mbar_init(full + 8 * s, 1);
      if (LN) mbar_init(xfull, 1);
      mbar_init_fence();
    }
    // with the prologue: after the consumers' loads of g and b, the rows
    // of x whole, then W
    if constexpr (LN) named_sync(2, TC_THREADS);
    if (lane == 0) {
      if (LN) {
        mbar_expect_tx(xfull, xb * L.xbox());
        for (int j = 0; j < xb; ++j)
          tma_load(sx + j * L.xbox(), &tm_x, xfull, TC_BOX * j, r0);
      }
      for (int s = 0; s < stages; ++s) {
        mbar_expect_tx(full + 8 * s, (LN ? 0 : L.xbox()) + TC_STAGE);
        if (!LN)
          tma_load(sx + s * L.xbox(), &tm_x, full + 8 * s, k0 + s * TC_BOX,
                   r0);
        for (int wb = 0; wb < TC_N / 64; ++wb)
          tma_load(base + s * TC_STAGE + wb * TC_BOXB, &tm_w, full + 8 * s,
                   n0 + 64 * wb, k0 + s * TC_BOX);
      }
    }
    __syncwarp();
  }
  if constexpr (LN) {
    if (warp < TC_WARPS)
      tc_ln_prologue(g, b, eps, smraw + (base - raw) + L.x_off(), L.xbox(),
                     xfull, M, K, r0, L.mp, k0, stages, warp, lane);
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
    const uint32_t x_lane =
        sx + (LN ? k0 / TC_BOX * L.xbox() : 0) + (lane & 7) * 128;
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

__global__ void __launch_bounds__(TC_THREADS)
row_mm_tc(const __grid_constant__ CUtensorMap tm_w,
          const __grid_constant__ CUtensorMap tm_x, bf16* __restrict__ y,
          int M, int K, int N, int kb) {
  tc_body<false, float>(tm_w, tm_x, nullptr, nullptr, 0.f, y, M, K, N, kb);
}

// y = LN(x; g, b, eps) W on the tensor cores: tm_w and tm_x as
// row_mm_tc's; g and b [K], 16-byte aligned.
template <typename G>
__global__ void __launch_bounds__(TC_THREADS)
ln_row_mm_tc(const __grid_constant__ CUtensorMap tm_w,
             const __grid_constant__ CUtensorMap tm_x,
             const G* __restrict__ g, const G* __restrict__ b, float eps,
             bf16* __restrict__ y, int M, int K, int N, int kb) {
  tc_body<true, G>(tm_w, tm_x, g, b, eps, y, M, K, N, kb);
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
// kchunk rows each.  LN: x's rows go through the LayerNorm prologue (g, b,
// eps) first; warps 0-7 take the moments of the block's rows, and every
// x element is normalised as the loop reads it.
template <typename T, bool VEC, bool LN, typename G>
__device__ __forceinline__ void cc_body(const T* __restrict__ x,
                                        const T* __restrict__ w,
                                        T* __restrict__ y,
                                        const G* __restrict__ g,
                                        const G* __restrict__ b, float eps,
                                        int M, int K, int N, int kchunk) {
  __shared__ float part[WARPS][OUTS];   // each warp's sums
  __shared__ float recv[OUTS];          // slot q: rank q's block sums
  __shared__ float moments[2][ROWS];    // LN: each row's mean and rs
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
  const T* xr = x + (long long)r0 * K;

  float mu[ROWS], rs[ROWS];
  if constexpr (LN) {
    if (warp < rows) {
      float m_, r_;
      row_moments(xr + (long long)warp * K, K, rows_vec(x, K), eps, lane,
                  m_, r_);
      if (lane == 0) {
        moments[0][warp] = m_;
        moments[1][warp] = r_;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      mu[r] = r < rows ? moments[0][r] : 0.f;
      rs[r] = r < rows ? moments[1][r] : 0.f;
    }
  }
  // x's element (r, kk) as the product reads it
  auto xval = [&](int r, int kk, float gk, float bk) {
    const float v = to_f(xr[(long long)r * K + kk]);
    if constexpr (LN) return to_f(from_f<T>(ln_affine(v, mu[r], rs[r], gk,
                                                      bk)));
    return v;
  };

  float acc[ROWS][2];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r][0] = acc[r][1] = 0.f;
  int k = k0;
  // each output's sum runs over k in increasing order, one fmaf a k, in
  // both loops
  for (; k + UNROLL <= k1; k += UNROLL) {
    float wa[UNROLL], wb[UNROLL], gk[UNROLL], bk[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      load_pair<T, VEC>(w + (long long)(k + u) * N, n, N, wa[u], wb[u]);
      if constexpr (LN) {
        gk[u] = to_f(g[k + u]);
        bk[u] = to_f(b[k + u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < rows) {
          const float xv = xval(r, k + u, gk[u], bk[u]);
          acc[r][0] = fmaf(xv, wa[u], acc[r][0]);
          acc[r][1] = fmaf(xv, wb[u], acc[r][1]);
        }
      }
    }
  }
  for (; k < k1; ++k) {
    float wa, wb, gk = 0.f, bk = 0.f;
    load_pair<T, VEC>(w + (long long)k * N, n, N, wa, wb);
    if constexpr (LN) {
      gk = to_f(g[k]);
      bk = to_f(b[k]);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r < rows) {
        const float xv = xval(r, k, gk, bk);
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

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
row_mm(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
       int M, int K, int N, int kchunk) {
  cc_body<T, VEC, false, float>(x, w, y, nullptr, nullptr, 0.f, M, K, N,
                                kchunk);
}

// y = LN(x; g, b, eps) W on the CUDA cores.
template <typename T, bool VEC, typename G>
__global__ void __launch_bounds__(THREADS)
ln_row_mm(const T* __restrict__ x, const T* __restrict__ w,
          T* __restrict__ y, const G* __restrict__ g,
          const G* __restrict__ b, float eps, int M, int K, int N,
          int kchunk) {
  cc_body<T, VEC, true, G>(x, w, y, g, b, eps, M, K, N, kchunk);
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

// One launch of row_mm_tc, or with LN of ln_row_mm_tc<G> on g, b, eps.
template <bool LN, typename G>
cudaError_t launch_tc(const void* x, const void* g, const void* b, float eps,
                      const void* w, void* y, int M, int K, int N, int cs,
                      int kb, cudaStream_t st) {
  static int max_dyn = 0;
  static bool wide_set = false;
  const int groups = (M + 8 * TC_CHUNKS - 1) / (8 * TC_CHUNKS);
  const int tiles = (N + TC_N - 1) / TC_N;
  if (groups > 65535 || tiles > 65535) return cudaErrorInvalidValue;
  const void* fn = LN ? reinterpret_cast<const void*>(ln_row_mm_tc<G>)
                      : reinterpret_cast<const void*>(row_mm_tc);
  cudaError_t e;
  if (!max_dyn) {       // once: a per-call attribute would add host time
    // all the shared memory a block may have, less any static part
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, fn);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             232448 - (int)fa.sharedSizeBytes);
    if (e != cudaSuccess) return e;
    max_dyn = 232448 - (int)fa.sharedSizeBytes;
  }
  const int xr = tc_xrows(M);
  const int smem =
      TcLayout(kb, cs, xr, xr, LN ? (K + TC_BOX - 1) / TC_BOX : 0).bytes() +
      1024;
  if (smem > max_dyn) return cudaErrorInvalidValue;
  CUtensorMap tw, tx;
  if (!cached_map(&tw, w, K, N, TC_BOX) || !cached_map(&tx, x, M, K, xr))
    return cudaErrorInvalidValue;
  if (cs > 8 && !wide_set) {   // clusters of 9-16 blocks: Hopper, opt-in
    e = cudaFuncSetAttribute(fn,
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
  if constexpr (LN)
    e = cudaLaunchKernelEx(&cfg, ln_row_mm_tc<G>, tw, tx,
                           static_cast<const G*>(g), static_cast<const G*>(b),
                           eps, static_cast<bf16*>(y), M, K, N, kb);
  else
    e = cudaLaunchKernelEx(&cfg, row_mm_tc, tw, tx, static_cast<bf16*>(y), M,
                           K, N, kb);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// One launch of row_mm<T, VEC>, or with LN of ln_row_mm<T, VEC, G>.
template <typename T, bool VEC, bool LN, typename G>
cudaError_t launch_cc(const void* x, const void* g, const void* b, float eps,
                      const void* w, void* y, int M, int K, int N, int cs,
                      int kchunk, cudaStream_t st) {
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
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  cudaError_t e;
  if constexpr (LN)
    e = cudaLaunchKernelEx(&cfg, ln_row_mm<T, VEC, G>, xt, wt,
                           static_cast<T*>(y), static_cast<const G*>(g),
                           static_cast<const G*>(b), eps, M, K, N, kchunk);
  else
    e = cudaLaunchKernelEx(&cfg, row_mm<T, VEC>, xt, wt, static_cast<T*>(y),
                           M, K, N, kchunk);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Both entries: the checks and the instance for (dtype, route, W's
// alignment); LN with g, b of g_dtype.
template <bool LN, typename G>
int row_matmul(const void* x, const void* g, const void* b, float eps,
               const void* w, void* y, int M, int K, int N, int dtype,
               int route, int cs, int kb, cudaStream_t st) {
  if (M <= 0 || N <= 0 || K < 0 || (dtype != 0 && dtype != 1) || cs < 1)
    return (int)cudaErrorInvalidValue;
  if (route == 1) {
    if (dtype != 1 || N % 8 || K % 8 || reinterpret_cast<uintptr_t>(w) % 16 ||
        reinterpret_cast<uintptr_t>(x) % 16 ||
        (LN && (reinterpret_cast<uintptr_t>(g) % 16 ||
                reinterpret_cast<uintptr_t>(b) % 16)) ||
        K <= 0 || cs > TC_MAX_CS ||
        kb <= 0 || kb % TC_BOX ||
        kb > TC_MAX_KB || (long long)(cs - 1) * kb >= K ||
        (long long)cs * kb < K)
      return (int)cudaErrorInvalidValue;
    return (int)launch_tc<LN, G>(x, g, b, eps, w, y, M, K, N, cs, kb, st);
  }
  if (route != 0 || cs > 8 || kb < 0 || (long long)cs * WARPS * kb < K)
    return (int)cudaErrorInvalidValue;
  const size_t esz = dtype == 0 ? 4 : 2;
  const bool vec = (N % 2 == 0) &&
                   (reinterpret_cast<uintptr_t>(w) % (2 * esz) == 0);
  if (dtype == 0)
    return (int)(vec ? launch_cc<float, true, LN, G>(x, g, b, eps, w, y, M, K,
                                                     N, cs, kb, st)
                     : launch_cc<float, false, LN, G>(x, g, b, eps, w, y, M,
                                                      K, N, cs, kb, st));
  return (int)(vec ? launch_cc<bf16, true, LN, G>(x, g, b, eps, w, y, M, K, N,
                                                  cs, kb, st)
                   : launch_cc<bf16, false, LN, G>(x, g, b, eps, w, y, M, K,
                                                   N, cs, kb, st));
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
  return row_matmul<false, float>(x, nullptr, nullptr, 0.f, w, y, M, K, N,
                                  dtype, route, cs, kb,
                                  static_cast<cudaStream_t>(stream));
}

// y [M, N] = LayerNorm(x; g, b, eps) [M, K] W [K, N]: as pt_row_matmul,
// with g and b [K] contiguous, float32 (g_dtype 0) or bfloat16 (1), and on
// route 1 16-byte aligned.
extern "C" int pt_ln_row_matmul(const void* x, const void* g, const void* b,
                                const void* w, void* y, int M, int K, int N,
                                int dtype, int g_dtype, int route, int cs,
                                int kb, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g_dtype == 0)
    return row_matmul<true, float>(x, g, b, eps, w, y, M, K, N, dtype, route,
                                   cs, kb, st);
  if (g_dtype == 1)
    return row_matmul<true, bf16>(x, g, b, eps, w, y, M, K, N, dtype, route,
                                  cs, kb, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
