// Flash attention forward, split backward and fused backward for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attn.py:
//   fa_fwd_wg / fa_fwd              <- _fa_kernel      (_flash_attention_tpu)
//   fa_bwd_dq_wg / fa_bwd_dq        <- _fa_dq_kernel   (split path of
//   fa_bwd_wg<., ., false> /        <- _fa_dkv_kernel   _flash_attention_bwd_tpu)
//     fa_bwd_dkv
//   fa_bwd_wg<., ., true> /         <- _fa_fused_bwd_kernel (its fused path,
//     fa_bwd_dkv (fp32: FUSED)         set_default_blocks(bwd_fused=True))
// (*_wg: bf16, warp-specialised TMA + wgmma; the others: fp32 on the CUDA
// cores.)
// Same arithmetic: s = (q . k) * scale in fp32 from the stored values,
// bottom-right causal mask (query i sees key j <= i + Nk - N), ragged K tail
// masked, online softmax with m/l/acc in fp32, p cast to the stored type
// before p.V, out = acc / l, lse = m + log(max(l, 1e-30)).  The backward
// recomputes p = exp(s - lse) from the saved row logsumexp, takes
// delta = rowsum(dO * O) from the wrapper, forms ds = p * (dp - delta) * scale
// and casts p and ds to the stored type before their products, as the
// Pallas kernels do.  The split backward has no atomics and no reductions:
// dq (q tile stationary) and dk/dv (K/V tile stationary) are separate
// kernels that each write their outputs once, so its results are
// deterministic.  The fused backward keeps a K/V tile stationary and adds
// each q tile's ds @ k into a zeroed fp32 [B, N, nh, hd] dq buffer (the
// wrapper casts it to the stored type): p and ds are recomputed once per
// tile, five products against the split's seven.  The reference writes one
// fp32 dq partial per K block instead and sums them after; those would take
// O(N^2 hd / block) bytes, the buffer here O(N hd).  The order of the adds
// varies from run to run, and with it the last bits of dq.
//
// Head widths.  hd 64, 128 and 256 have their own instances (the wrapper
// zero-pads other widths up to 256 to the next of these).  Wider heads
// (any multiple of 64; the wrapper pads the rest) run the WIDE instances:
// the grid gains a head-width group axis, and group g owns columns
// [64g, 64g + 64) of out, dq, dk and dv.  Each group recomputes the scores
// (and in the backward dp = dO . V^T) over the full width in 64-column
// chunks, its own chunk last, so that the tiles in shared memory hold
// exactly its columns when the products that write them run; it writes
// only its own slice, and group 0 writes the lse.  The bf16 backward
// kernels take the group path from hd 256 (their accumulators at 256
// columns would not fit the registers of a warpgroup).
//
// Bound.  At the flagship shape (B=6, N=Nk=2048, nh=16, hd=128, causal,
// bf16) the forward needs 4*V*hd = 103 GFLOP (V = keys attended, summed
// over rows) against 202 MB: bound by operations on the tensor cores
// (0.104 ms at 989 TFLOP/s).  At the 345M shape (hd 64, N=1024, B=8) it
// needs 17 GFLOP against 67 MB: bound by bytes (20 us at 3.35 TB/s).  A
// backward pass needs 10*V*hd (five products; the split design does seven:
// dq recomputes s and dp, 6*V*hd, dk/dv 8*V*hd) and is bound by
// operations; the fused backward also sends V*hd fp32 adds (per K tile, its
// q rows) to L2.  In fp32 the 67 TFLOP/s of the CUDA cores bound both
// passes by operations.
//
// Design for that bound, bf16 (every *_wg kernel): 384 threads, two
// consumer warpgroups of 64 rows each and a producer warpgroup whose one
// thread issues TMA loads into a ring of stages guarded by full and empty
// mbarriers; setmaxnreg gives the consumers 240 registers and the producers
// 24.  Every product is a wgmma from 128-byte-swizzled TMA tiles: scores
// (and dp) from two K-major operands, p or ds from registers against V, K,
// dO or Q read as stored through MN-major descriptors, so no operand is
// transposed in registers.  The tensor maps are built over the strided
// [B, N, nh, hd] views as they are (the model's q/k/v are slices of one
// fused projection); TMA's out-of-bounds zero fill takes the ragged tails.
// The softmax (or p = exp(s - lse)) runs in fp32 registers with exp2 and
// scale * log2(e) folded into one multiply, and the mask is applied only
// on tiles that cross the diagonal or a tail.
//  * Forward (fa_fwd_wg): a block owns 128 q rows of one (batch, head); Q is
//    loaded once and K/V tiles (128 keys up to hd 128, 64 at hd 256) stream
//    through the ring.  Each warpgroup issues the next tile's scores before
//    this tile's p . V and runs the next softmax while that product is in
//    flight.  Out goes through shared memory (over Q's rows) to a TMA store.
//  * dq (fa_bwd_dq_wg): the forward's structure.  A block owns 128 q rows;
//    Q and dO are loaded once, lse and delta sit in registers, and K/V tiles
//    (128 keys at hd 64, 64 at hd 128) stream through the ring.  Per tile:
//    s = Q K^T and dp = dO V^T, ds in registers, dq += ds K.  The next
//    tile's s and dp are issued before this tile's dq product, and its ds
//    formed while that product runs.  dq is written once, in bf16, through
//    shared memory to a TMA store.
//  * dk/dv and the fused backward (fa_bwd_wg<D, WIDE, FUSED>): a block owns
//    128 keys (64 a warpgroup), keeps its K/V tile in shared memory and dk,
//    dv in fp32 registers, and streams 64-row q tiles with their dO, lse
//    and delta.  Per q tile: s^T = K Q^T and dp^T = V dO^T, then p^T and
//    ds^T in registers, dv += p^T dO and dk += ds^T Q.  dk and dv are
//    written once, in bf16.  FUSED only: ds^T also goes to shared memory
//    (two buffers by tile parity), both warpgroups meet at a named barrier,
//    and each computes half of dq_tile = ds K's columns with one more wgmma,
//    stores it in shared memory and adds it to the fp32 dq buffer with one
//    bulk tensor reduction per 32-column box (cp.reduce.async.bulk.tensor
//    .add): no scalar atomics.
// Causal tiles above the diagonal are skipped (the forward and dq stop at
// the last K tile the diagonal reaches; dk/dv start at the first q tile
// that reaches theirs), and the tiles with the most work launch first.
// fp32 runs on the CUDA cores (TF32 would break its 1e-5 tolerance): 256
// threads each own a 4 x 4 patch of the score tile in fp32 FMAs, tiles held
// in shared memory as fp32.
//
// Layout: q, k, v and dO are [B, N, nh, hd] with any strides on the first
// three axes (the bf16 kernels need 16-byte aligned rows, which the wrapper
// ensures); the last axis must be contiguous.  out, dq, dk, dv are
// contiguous [B, N|Nk, nh, hd]; lse and delta are contiguous fp32
// [B, nh, N].  The grid is (row tiles x groups, nh, B), B in launches of at
// most 65,535 batches, so any B * nh runs (nh up to 65,535).
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/cuda/flash_attn.py);
// dtype codes: 0 = float32, 1 = bfloat16.  Every entry point returns
// cudaGetLastError() after its launch.
#include "hopper.cuh"

#include <type_traits>

namespace {

constexpr int NT = 256;   // fp32 threads: 16 x 16, each an R x R patch
constexpr int GW = 64;    // columns of a head-width group (WIDE instances)
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, n, h;  // element strides of a [B, N, nh, hd] operand
};

// Rows [r0, r0 + R) of one (batch, head) slice -> shared fp32 [R][LD];
// rows at or past n_rows are zero.  Neighbouring threads read neighbouring
// elements of a row.
template <int D, int R, int LD>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const float* __restrict__ base,
                                          long long sn, int r0, int n_rows) {
  for (int i = threadIdx.x; i < R * D; i += NT) {
    const int r = i / D, d = i % D;
    const int row = r0 + r;
    dst[r * LD + d] = row < n_rows ? base[(long long)row * sn + d] : 0.f;
  }
}

// n fp32 values of a row vector (lse or delta) -> shared; past n: zero.
__device__ __forceinline__ void load_rows(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int r0, int n, int count) {
  for (int i = threadIdx.x; i < count; i += NT)
    dst[i] = r0 + i < n ? src[r0 + i] : 0.f;
}

// max / sum over the 16 threads (tx) that share a row of the score tile:
// xor offsets below 16 stay inside a half warp.
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Last K tile (exclusive) of TK rows that rows [q0, q0 + TQ) of a q tile
// can see.
template <int TQ, int TK>
__device__ __forceinline__ int k_tiles_for(int q0, int N, int Nk,
                                           int causal) {
  int end = (Nk + TK - 1) / TK;
  if (causal) {
    const int last_row = min(q0 + TQ - 1, N - 1);
    end = min(end, (last_row + Nk - N) / TK + 1);
  }
  return end;
}

// The block's row tile, head-width group, batch and head.  The grid is
// (row tiles x groups, nh, B) and the launchers split B into launches of
// at most 65,535, so any B * nh runs.  A narrow instance has one group and
// takes the tile from blockIdx.x without a division (a one-dimensional
// grid that divides the block index measured up to 24% slower on the H100
// in some of these kernels, through their registers).
template <bool WIDE>
__device__ __forceinline__ void tile_of(int tiles, int& tile, int& grp,
                                        int& b, int& h) {
  if constexpr (WIDE) {
    grp = blockIdx.x / tiles;
    tile = blockIdx.x - grp * tiles;
  } else {
    grp = 0;
    tile = blockIdx.x;
  }
  h = blockIdx.y;
  b = blockIdx.z;
}

// Chunk i of a WIDE block's score loop: the group's own chunk comes last.
__device__ __forceinline__ int chunk_of(int grp, int i, int nch) {
  return (grp + 1 + i) % nch;
}

__device__ __forceinline__ bool visible(int row, int col, int N, int Nk,
                                        int causal) {
  return col < Nk && (!causal || col <= row + Nk - N);
}

// ---------------------------------------------------------------------------
// fp32 forward: one block per (q tile, group, batch, head); q tiles of 16 R
// rows.  WIDE: D is the group width; the score loop walks hd in D-column
// chunks, reloading the q and K tiles.
// ---------------------------------------------------------------------------
template <int D, int R, bool WIDE>
__global__ void __launch_bounds__(NT)
fa_fwd(const float* __restrict__ q, const float* __restrict__ k,
       const float* __restrict__ v, float* __restrict__ o,
       float* __restrict__ lse, int H, int N, int Nk, int hd, Strides sq,
       Strides sk, Strides sv, int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  constexpr int TQ = 16 * R, TK = 16 * R, LP = TK + 1;
  extern __shared__ float sm[];
  float* Qs = sm;               // [TQ][LD]
  float* Ks = Qs + TQ * LD;     // [TK][LD]
  float* Vs = Ks + TK * LD;     // [TK][D]
  float* Ps = Vs + TK * D;      // [TQ][LP]

  const int nqt = (N + TQ - 1) / TQ;
  int tile, grp, b, h;
  tile_of<WIDE>(nqt, tile, grp, b, h);
  const int q0 = (nqt - 1 - tile) * TQ;  // longest rows first
  const int nch = WIDE ? hd / D : 1;
  const int od = WIDE ? hd : D;          // row length of out
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h + grp * D;

  if constexpr (!WIDE) load_tile<D, TQ, LD>(Qs, qb, sq.n, q0, N);
  const int kt_end = k_tiles_for<TQ, TK>(q0, N, Nk, causal);

  float acc[R][DJ];
  float m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * TK;
    float s[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = 0.f;
    for (int ci = 0; ci < nch; ++ci) {
      const int c = WIDE ? chunk_of(grp, ci, nch) : 0;
      __syncthreads();  // the previous tile's readers are done
      if constexpr (WIDE) load_tile<D, TQ, LD>(Qs, qb + c * D, sq.n, q0, N);
      load_tile<D, TK, LD>(Ks, kb + c * D, sk.n, k0, Nk);
      if (ci == nch - 1) load_tile<D, TK, D>(Vs, vb, sv.n, k0, Nk);
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float a[R], cc[R];
#pragma unroll
        for (int i = 0; i < R; ++i) a[i] = Qs[(ty * R + i) * LD + d];
#pragma unroll
        for (int j = 0; j < R; ++j) cc[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) s[i][j] = fmaf(a[i], cc[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty * R + i;
      float mc = NEG_INF;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float x = s[i][j] * scale;
        s[i][j] = visible(q0 + r, k0 + tx + 16 * j, N, Nk, causal) ? x
                                                                    : NEG_INF;
        mc = fmaxf(mc, s[i][j]);
      }
      const float mn = fmaxf(m[i], row_max16(mc));
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float p = expf(s[i][j] - mn);
        rs += p;
        Ps[r * LP + tx + 16 * j] = p;
      }
      l[i] = alpha * l[i] + row_sum16(rs);
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < TK; ++c) {
      float p[R];
#pragma unroll
      for (int i = 0; i < R; ++i) p[i] = Ps[(ty * R + i) * LP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty * R + i;
    if (row >= N) continue;
    float* orow = o + (((long long)b * N + row) * H + h) * od + grp * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      orow[tx + 16 * j] = acc[i][j] / l[i];
    if (tx == 0 && grp == 0)
      lse[((long long)b * H + h) * N + row] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// fp32 backward dq: one block per (q tile, group, batch, head); K/V streamed
// ---------------------------------------------------------------------------
template <int D, int R, bool WIDE>
__global__ void __launch_bounds__(NT)
fa_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int H, int N, int Nk, int hd, Strides sq,
          Strides sk, Strides sv, Strides sd, int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  constexpr int TQ = 16 * R, TK = 16 * R, LP = TK + 1;
  extern __shared__ float sm[];
  float* Qs = sm;               // [TQ][LD]
  float* Gs = Qs + TQ * LD;     // dO, [TQ][LD]
  float* Ks = Gs + TQ * LD;     // [TK][LD]
  float* Vs = Ks + TK * LD;     // [TK][LD]
  float* DS = Vs + TK * LD;     // [TQ][LP]
  float* Ls = DS + TQ * LP;    // [TQ]
  float* Dl = Ls + TQ;          // [TQ]

  const int nqt = (N + TQ - 1) / TQ;
  int tile, grp, b, h;
  tile_of<WIDE>(nqt, tile, grp, b, h);
  const int q0 = (nqt - 1 - tile) * TQ;
  const int nch = WIDE ? hd / D : 1;
  const int od = WIDE ? hd : D;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long row_base = ((long long)b * H + h) * N;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* gb = dout + b * sd.b + h * sd.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  if constexpr (!WIDE) {
    load_tile<D, TQ, LD>(Qs, qb, sq.n, q0, N);
    load_tile<D, TQ, LD>(Gs, gb, sd.n, q0, N);
  }
  load_rows(Ls, lse + row_base, q0, N, TQ);
  load_rows(Dl, delta + row_base, q0, N, TQ);
  const int kt_end = k_tiles_for<TQ, TK>(q0, N, Nk, causal);

  float acc[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * TK;
    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
    // WIDE: the last chunk is the group's, so Ks holds its K columns below
    for (int ci = 0; ci < nch; ++ci) {
      const int c = WIDE ? chunk_of(grp, ci, nch) : 0;
      __syncthreads();
      if constexpr (WIDE) {
        load_tile<D, TQ, LD>(Qs, qb + c * D, sq.n, q0, N);
        load_tile<D, TQ, LD>(Gs, gb + c * D, sd.n, q0, N);
      }
      load_tile<D, TK, LD>(Ks, kb + c * D, sk.n, k0, Nk);
      load_tile<D, TK, LD>(Vs, vb + c * D, sv.n, k0, Nk);
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float a[R], g[R], cc[R], w[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          a[i] = Qs[(ty * R + i) * LD + d];
          g[i] = Gs[(ty * R + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
          cc[j] = Ks[(tx + 16 * j) * LD + d];
          w[j] = Vs[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) {
            s[i][j] = fmaf(a[i], cc[j], s[i][j]);
            dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty * R + i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int c = tx + 16 * j;
        const float p = visible(q0 + r, k0 + c, N, Nk, causal)
                            ? expf(s[i][j] * scale - Ls[r])
                            : 0.f;
        DS[r * LP + c] = p * (dp[i][j] - Dl[r]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < TK; ++c) {
      float ds[R];
#pragma unroll
      for (int i = 0; i < R; ++i) ds[i] = DS[(ty * R + i) * LP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kk = Ks[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][j] = fmaf(ds[i], kk, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty * R + i;
    if (row >= N) continue;
    float* out = dq + (((long long)b * N + row) * H + h) * od + grp * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) out[tx + 16 * j] = acc[i][j];
  }
}

// ---------------------------------------------------------------------------
// fp32 backward dk/dv: one block per (K tile, group, batch, head); q tiles
// streamed.  The thread owns key rows (ty) and query columns (tx) of the
// transposed score tile.  FUSED: also dq32 += ds @ k per q tile, the thread
// owning 4 query rows (ty) and D / 16 columns (tx) of it.
// ---------------------------------------------------------------------------
template <int D, int R, bool FUSED, bool WIDE>
__global__ void __launch_bounds__(NT)
fa_bwd_dkv(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dk, float* __restrict__ dv,
           float* __restrict__ dq32, int H, int N, int Nk, int hd,
           Strides sq, Strides sk, Strides sv, Strides sd, int causal,
           float scale) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  constexpr int TQ = 16 * R, TK = 16 * R, LP = TK + 1;
  extern __shared__ float sm[];
  float* Ks = sm;               // [TK][LD]
  float* Vs = Ks + TK * LD;     // [TK][LD]
  float* Qs = Vs + TK * LD;     // [TQ][LD]
  float* Gs = Qs + TQ * LD;     // dO, [TQ][LD]
  float* PT = Gs + TQ * LD;     // p^T, [TK][LP]
  float* DT = PT + TK * LP;    // ds^T, [TK][LP]
  float* Ls = DT + TK * LP;    // [TQ]
  float* Dl = Ls + TQ;          // [TQ]

  int tile, grp, b, h;
  tile_of<WIDE>((Nk + TK - 1) / TK, tile, grp, b, h);
  const int k0 = tile * TK;
  const int nch = WIDE ? hd / D : 1;
  const int od = WIDE ? hd : D;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long row_base = ((long long)b * H + h) * N;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* gb = dout + b * sd.b + h * sd.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  if constexpr (!WIDE) {
    load_tile<D, TK, LD>(Ks, kb, sk.n, k0, Nk);
    load_tile<D, TK, LD>(Vs, vb, sv.n, k0, Nk);
  }
  const int nqt = (N + TQ - 1) / TQ;
  // first q tile whose rows reach key k0 under the bottom-right diagonal
  const int qt0 = causal ? max(0, k0 - (Nk - N)) / TQ : 0;

  float adk[R][DJ], adv[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  for (int qt = qt0; qt < nqt; ++qt) {
    const int q0 = qt * TQ;
    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
    // WIDE: the last chunk is the group's, so Ks, Qs and Gs hold its
    // columns for the products below
    for (int ci = 0; ci < nch; ++ci) {
      const int c = WIDE ? chunk_of(grp, ci, nch) : 0;
      __syncthreads();
      if constexpr (WIDE) {
        load_tile<D, TK, LD>(Ks, kb + c * D, sk.n, k0, Nk);
        load_tile<D, TK, LD>(Vs, vb + c * D, sv.n, k0, Nk);
      }
      load_tile<D, TQ, LD>(Qs, qb + c * D, sq.n, q0, N);
      load_tile<D, TQ, LD>(Gs, gb + c * D, sd.n, q0, N);
      if (ci == 0) {
        load_rows(Ls, lse + row_base, q0, N, TQ);
        load_rows(Dl, delta + row_base, q0, N, TQ);
      }
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kk[R], w[R], a[R], g[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          kk[i] = Ks[(ty * R + i) * LD + d];
          w[i] = Vs[(ty * R + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
          a[j] = Qs[(tx + 16 * j) * LD + d];
          g[j] = Gs[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) {
            s[i][j] = fmaf(kk[i], a[j], s[i][j]);
            dp[i][j] = fmaf(w[i], g[j], dp[i][j]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty * R + i;  // key row in the tile
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int c = tx + 16 * j;  // query row in the tile
        const bool ok = q0 + c < N && visible(q0 + c, k0 + r, N, Nk, causal);
        const float p = ok ? expf(s[i][j] * scale - Ls[c]) : 0.f;
        PT[r * LP + c] = p;
        DT[r * LP + c] = p * (dp[i][j] - Dl[c]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < TQ; ++c) {
      float p[R], ds[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        p[i] = PT[(ty * R + i) * LP + c];
        ds[i] = DT[(ty * R + i) * LP + c];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float g = Gs[c * LD + tx + 16 * j];
        const float a = Qs[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          adv[i][j] = fmaf(p[i], g, adv[i][j]);
          adk[i][j] = fmaf(ds[i], a, adk[i][j]);
        }
      }
    }
    if constexpr (FUSED) {
      float aq[R][DJ];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) aq[i][j] = 0.f;
#pragma unroll 4
      for (int r = 0; r < TK; ++r) {
        float ds[R];
#pragma unroll
        for (int i = 0; i < R; ++i) ds[i] = DT[r * LP + ty * R + i];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float kk = Ks[r * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < R; ++i) aq[i][j] = fmaf(ds[i], kk, aq[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int row = q0 + ty * R + i;
        if (row >= N) continue;
        float* dst = dq32 + (((long long)b * N + row) * H + h) * od + grp * D;
#pragma unroll
        for (int j = 0; j < DJ; ++j) atomicAdd(dst + tx + 16 * j, aq[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = k0 + ty * R + i;
    if (row >= Nk) continue;
    const long long off = (((long long)b * Nk + row) * H + h) * od + grp * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[off + tx + 16 * j] = adk[i][j];
      dv[off + tx + 16 * j] = adv[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, warp-specialised: TMA into mbarrier rings, wgmma from 128-byte-
// swizzled tiles.  384 threads: consumer warpgroups 0 and 1, producer
// warpgroup 2 (thread 256 issues every load).  A tile of R rows x 64
// columns (one TMA box, 128-byte rows) takes R * 128 bytes; wider operands
// are boxes of 64 columns side by side.  In a consumer warpgroup, warp w
// and lane (gq = lane / 4, t = lane % 4) hold rows 16w + gq and + 8 of its
// 64 and, in n-tile j of an accumulator, columns 8j + 2t and + 1 (the
// mma.m16n8k16 layout, n-tiles side by side).
// ---------------------------------------------------------------------------
constexpr int WG_THREADS = 384;
constexpr int FQ = 128;     // forward, dq: q rows of a block
constexpr int BKV = 128;    // dk/dv and fused backward: keys of a block
constexpr int BQ2 = 64;     // dk/dv and fused backward: q rows of a tile

// max / sum over the 4 threads (t) that share a row of an accumulator
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The m16n8k16 A fragments (k16 step q: u32 4q..4q+3) of a 64 x (4 NP)
// bf16 operand from an fp32 accumulator of the same shape.
template <int NP>
__device__ __forceinline__ void acc_to_frags(uint32_t (&a)[NP],
                                             const float (&s)[2 * NP]) {
#pragma unroll
  for (int q = 0; q < NP / 4; ++q) {
    a[4 * q + 0] = pack_bf16(s[8 * q + 0], s[8 * q + 1]);
    a[4 * q + 1] = pack_bf16(s[8 * q + 2], s[8 * q + 3]);
    a[4 * q + 2] = pack_bf16(s[8 * q + 4], s[8 * q + 5]);
    a[4 * q + 3] = pack_bf16(s[8 * q + 6], s[8 * q + 7]);
  }
}

// Release a ring stage whose products are done: one arrival a warpgroup.
__device__ __forceinline__ void release(uint32_t bar, int wg) {
  wg_sync(wg);
  if ((threadIdx.x & 127) == 0) mbar_arrive(bar);
}

// Shared-memory layout of fa_fwd_wg<D, WIDE>.  Narrow: Q resident (D / 64
// boxes of 128 rows), a stage holds the K and V tiles of BKR keys.  WIDE
// (D = 64): a stage holds one 64-column chunk of Q and of K, and the
// group's V tile with the last chunk.  Stages (H100,
// tools/flash_variants.py): four at hd 64 (six were no faster), three at
// hd 128 (two waited on the loads, 17% slower), two at hd 256 (what fits).
template <int D, bool WIDE>
struct FwdSmem {
  static constexpr int NB = D / 64;
  static constexpr int BKR = WIDE ? 128 : (D == 256 ? 64 : 128);
  static constexpr int ST = WIDE ? 3 : (D == 256 ? 2 : D == 128 ? 3 : 4);
  static constexpr int QBOX = FQ * 128;
  static constexpr int KBOX = BKR * 128;
  static constexpr int Q_BYTES = WIDE ? 0 : NB * QBOX;
  static constexpr int STAGE = WIDE ? QBOX + 2 * KBOX : 2 * NB * KBOX;
  static constexpr int S_K = WIDE ? QBOX : 0;          // in a stage
  static constexpr int S_V = WIDE ? QBOX + KBOX : NB * KBOX;
  static constexpr int RING = Q_BYTES;
  static constexpr int BAR = RING + ST * STAGE;
  // qbar, full [ST], empty [ST]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * ST);
  static constexpr int ALLOC = BYTES + 1024;   // room to align to 1024
};
static_assert(FwdSmem<64, false>::ALLOC <= 232448 &&
                  FwdSmem<128, false>::ALLOC <= 232448 &&
                  FwdSmem<256, false>::ALLOC <= 232448 &&
                  FwdSmem<64, true>::ALLOC <= 232448,
              "fa_fwd_wg fits in shared memory");

// Issue S = Q K^T for one warpgroup (64 rows) over NB boxes of 64 columns:
// A = Q rows at qa (K-major), B = K rows at ka (K-major); acc = 0 starts S.
template <int BKR, int NB>
__device__ __forceinline__ void scores_qk(float (&s)[BKR / 2], uint32_t qa,
                                          uint32_t qbox, uint32_t ka,
                                          uint32_t kbox, int acc) {
#pragma unroll
  for (int kb = 0; kb < NB; ++kb)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss<BKR, 0, 0>(s, sw128_desc(qa + kb * qbox + ks * 32, 16, 1024),
                          sw128_desc(ka + kb * kbox + ks * 32, 16, 1024),
                          acc | kb | ks);
}

// The online softmax of one score tile (raw scores s, this thread's rows
// row0 and row0 + 8): m, l (this thread's partial row sums) and alpha
// updated, p in bf16 A fragments.  Masked where `mask`.
template <int BKR>
__device__ __forceinline__ void softmax_tile(float (&s)[BKR / 2],
                                             uint32_t (&p)[BKR / 4],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool mask,
                                             int row0, int k0, int t, int N,
                                             int Nk, int causal, float c2) {
  if (mask) {
#pragma unroll
    for (int j = 0; j < BKR / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!visible(row0 + 8 * (e >> 1), k0 + 8 * j + 2 * t + (e & 1), N,
                     Nk, causal))
          s[4 * j + e] = NEG_INF;
  }
  float mc[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < BKR / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mc[e >> 1] = fmaxf(mc[e >> 1], s[4 * j + e]);
  float mb[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const float mn = fmaxf(m[hi], quad_max(mc[hi]));
    alpha[hi] = exp2f((m[hi] - mn) * c2);
    m[hi] = mn;
    mb[hi] = mn * c2;
    l[hi] *= alpha[hi];
  }
#pragma unroll
  for (int j = 0; j < BKR / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = exp2f(fmaf(s[4 * j + e], c2, -mb[e >> 1]));
      s[4 * j + e] = x;
      l[e >> 1] += x;
    }
  acc_to_frags<BKR / 4>(p, s);   // p cast to bf16 before p.V
}

// O += P V for one warpgroup: A = p fragments, B = V tile of BKR keys at va
// (MN-major, D / 64 boxes of kbox bytes).
template <int D, int BKR>
__device__ __forceinline__ void pv(float (&o)[D / 2],
                                   const uint32_t (&p)[BKR / 4], uint32_t va,
                                   uint32_t kbox) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < BKR / 16; ++ks)
    wgmma_rs<D, 1>(o, p + 4 * ks, sw128_desc(va + ks * 2048, kbox, 1024));
  wgmma_commit();
}

// This warpgroup's 64 rows of an fp32 [64, D] accumulator, row half hi
// times mul[hi], cast to bf16 into its rows of a 128-row tile at `stage`
// (D / 64 swizzled boxes, `box` bytes apart), then TMA-stored to columns
// [64 grp, 64 grp + D) of rows [r0, r0 + 64) (rows past N are not written).
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           const float (&mul)[2],
                                           uint32_t stage, uint32_t box,
                                           const CUtensorMap* tm, int grp,
                                           int h, int r0, int b, int N,
                                           int wg) {
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, gq = (tid & 31) >> 2, t = tid & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = 16 * warp + gq + 8 * hi;
      const uint32_t a = stage + (col >> 6) * box + sw128_off(r, col & 63, 2);
      const uint32_t val = pack_bf16(acc[4 * j + 2 * hi] * mul[hi],
                                     acc[4 * j + 2 * hi + 1] * mul[hi]);
      asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(a), "r"(val) : "memory");
    }
  }
  fence_async_smem();
  wg_sync(wg);
  if (tid == 0 && r0 < N) {
#pragma unroll
    for (int kb = 0; kb < D / 64; ++kb)
      tma_store_4d(tm, stage + kb * box, 64 * (kb + grp), h, r0, b);
    bulk_commit();
    bulk_wait();
  }
}

// forward, bf16: one block per (q tile of FQ rows, group, batch, head).
template <int D, bool WIDE>
__global__ void __launch_bounds__(WG_THREADS, 1)
fa_fwd_wg(const __grid_constant__ CUtensorMap tm_q,
          const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v,
          const __grid_constant__ CUtensorMap tm_o, float* __restrict__ lse,
          int b0, int H, int N, int Nk, int hd, int causal, float scale) {
  using L = FwdSmem<D, WIDE>;
  constexpr int NB = L::NB, BKR = L::BKR, ST = L::ST;
  extern __shared__ __align__(1024) unsigned char smraw[];
  const uint32_t base = (smem_u32(smraw) + 1023) & ~1023u;
  const uint32_t sq = base, ring = base + L::RING;
  const uint32_t qbar = base + L::BAR, full = qbar + 8, empty = full + 8 * ST;

  const int nqt = (N + FQ - 1) / FQ;
  int tile, grp, b, h;
  tile_of<WIDE>(nqt, tile, grp, b, h);
  b += b0;
  const int q0 = (nqt - 1 - tile) * FQ;     // longest rows first
  const int nch = WIDE ? hd / GW : 1;
  const int kt_end = k_tiles_for<FQ, BKR>(q0, N, Nk, causal);
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 2);   // both consumer warpgroups
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      if constexpr (!WIDE) {
        mbar_expect_tx(qbar, L::Q_BYTES);
        for (int kb = 0; kb < NB; ++kb)
          tma_load_4d(sq + kb * L::QBOX, &tm_q, qbar, 64 * kb, h, q0, b);
      }
      int s = 0, ph = 0;
      for (int kt = 0; kt < kt_end; ++kt) {
        const int k0 = kt * BKR;
        for (int ci = 0; ci < nch; ++ci) {
          const uint32_t st = ring + s * L::STAGE, bar = full + 8 * s;
          mbar_wait(empty + 8 * s, ph ^ 1);
          if constexpr (WIDE) {
            const int c = chunk_of(grp, ci, nch);
            const bool last = ci == nch - 1;
            mbar_expect_tx(bar, L::QBOX + L::KBOX + (last ? L::KBOX : 0));
            tma_load_4d(st, &tm_q, bar, 64 * c, h, q0, b);
            tma_load_4d(st + L::S_K, &tm_k, bar, 64 * c, h, k0, b);
            if (last) tma_load_4d(st + L::S_V, &tm_v, bar, 64 * grp, h, k0, b);
          } else {
            mbar_expect_tx(bar, L::STAGE);
            for (int kb = 0; kb < NB; ++kb) {
              tma_load_4d(st + L::S_K + kb * L::KBOX, &tm_k, bar, 64 * kb, h,
                          k0, b);
              tma_load_4d(st + L::S_V + kb * L::KBOX, &tm_v, bar, 64 * kb, h,
                          k0, b);
            }
          }
          if (++s == ST) { s = 0; ph ^= 1; }
        }
      }
    }
    return;
  }

  // ---------------- consumers ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, gq = (tid & 31) >> 2, t = tid & 3;
  const int r0 = q0 + 64 * wg;                // this warpgroup's rows
  const int row0 = r0 + 16 * warp + gq;       // this thread's: row0, + 8
  const float c2 = scale * LOG2E;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float s[BKR / 2];
  uint32_t p[BKR / 4];
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
  int si = 0, ph = 0;
  // the mask: tiles that cross this warpgroup's diagonal or the K tail
  auto masked = [&](int k0) {
    return k0 + BKR > Nk || (causal && k0 + BKR - 1 > r0 + Nk - N);
  };

  if constexpr (WIDE) {
    // chunked scores, then p.V from the last chunk's stage, in order
    for (int kt = 0; kt < kt_end; ++kt) {
      const int k0 = kt * BKR;
      uint32_t st = 0;
      for (int ci = 0; ci < nch; ++ci) {
        st = ring + si * L::STAGE;
        mbar_wait(full + 8 * si, ph);
        wgmma_fence();
        scores_qk<BKR, 1>(s, st + wg * 8192, 0, st + L::S_K, 0, ci);
        wgmma_commit();
        wgmma_wait<0>();
        if (ci < nch - 1) {
          release(empty + 8 * si, wg);
          if (++si == ST) { si = 0; ph ^= 1; }
        }
      }
      softmax_tile<BKR>(s, p, m, l, alpha, masked(k0), row0, k0, t, N, Nk,
                        causal, c2);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[i & 2 ? 1 : 0];
      pv<D, BKR>(o, p, st + L::S_V, L::KBOX);
      wgmma_wait<0>();
      if (kt < kt_end - 1) {     // the last stage stages the output
        release(empty + 8 * si, wg);
        if (++si == ST) { si = 0; ph ^= 1; }
      }
    }
  } else {
    mbar_wait(qbar, 0);
    const uint32_t qa = sq + wg * 8192;
    // tile 0's scores and softmax; then, per tile, the next tile's scores
    // and this tile's p.V in flight together, the next softmax under p.V
    mbar_wait(full, 0);
    wgmma_fence();
    scores_qk<BKR, NB>(s, qa, L::QBOX, ring + L::S_K, L::KBOX, 0);
    wgmma_commit();
    wgmma_wait<0>();
    softmax_tile<BKR>(s, p, m, l, alpha, masked(0), row0, 0, t, N, Nk,
                      causal, c2);
    for (int kt = 0; kt < kt_end; ++kt) {
      const int cur = si;
      if (++si == ST) { si = 0; ph ^= 1; }
      const bool next = kt + 1 < kt_end;
      if (next) {
        mbar_wait(full + 8 * si, ph);
        wgmma_fence();
        scores_qk<BKR, NB>(s, qa, L::QBOX, ring + si * L::STAGE + L::S_K,
                           L::KBOX, 0);
        wgmma_commit();
      }
      pv<D, BKR>(o, p, ring + cur * L::STAGE + L::S_V, L::KBOX);
      uint32_t pn[BKR / 4];
      if (next) {
        wgmma_wait<1>();                   // the next tile's scores are done
        const int k1 = (kt + 1) * BKR;
        softmax_tile<BKR>(s, pn, m, l, alpha, masked(k1), row0, k1, t, N,
                          Nk, causal, c2);
      }
      wgmma_wait<0>();                     // this tile's p.V is done
      release(empty + 8 * cur, wg);
      if (next) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[i & 2 ? 1 : 0];
#pragma unroll
        for (int i = 0; i < BKR / 4; ++i) p[i] = pn[i];
      }
    }
  }

  // epilogue: out = o / l through shared memory (this warpgroup's rows of
  // the Q tile, or of the last stage's Q chunk) to a TMA store; lse
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) l[hi] = quad_sum(l[hi]);
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  if (t == 0 && grp == 0) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = row0 + 8 * hi;
      if (row < N)
        lse[((long long)b * H + h) * N + row] =
            m[hi] * scale + logf(fmaxf(l[hi], 1e-30f));
    }
  }
  store_rows<D>(o, inv, (WIDE ? ring + si * L::STAGE : sq) + wg * 8192,
                L::QBOX, &tm_o, grp, h, r0, b, N, wg);
}

// Shared-memory layout of fa_bwd_wg<D, WIDE, FUSED>.  Narrow: K and V
// resident (D / 64 boxes of 128 keys each), a stage holds the q tile's Q and
// dO (D / 64 boxes of 64 rows each), its lse and delta.  WIDE (D = 64): a
// stage holds one 64-column chunk of K, V, Q and dO (lse and delta with the
// last chunk).  FUSED then adds ds^T [128 keys][64 q] bf16 twice (by tile
// parity) and the dq tile [64 q][D] fp32 as D / 32 swizzled boxes of 32
// columns.  Stages: the fused kernel at hd 128 fits two; every other
// instance takes three.
template <int D, bool WIDE, bool FUSED>
struct BwdSmem {
  static constexpr int NB = D / 64;
  static constexpr int ST = FUSED && D == 128 ? 2 : 3;
  static constexpr int KBOX = BKV * 128;
  static constexpr int QBOX = BQ2 * 128;
  static constexpr int K = 0;
  static constexpr int V = K + (WIDE ? 0 : NB * KBOX);
  static constexpr int RING = V + (WIDE ? 0 : NB * KBOX);
  static constexpr int S_K = 0;                         // WIDE, in a stage
  static constexpr int S_V = WIDE ? KBOX : 0;
  static constexpr int S_Q = WIDE ? 2 * KBOX : 0;
  static constexpr int S_G = S_Q + NB * QBOX;
  static constexpr int S_L = S_G + NB * QBOX;
  static constexpr int S_D = S_L + BQ2 * 4;
  static constexpr int STAGE = (S_D + BQ2 * 4 + 1023) & ~1023;
  static constexpr int DS = RING + ST * STAGE;
  static constexpr int DSBUF = BKV * 128;
  static constexpr int DQ = DS + (FUSED ? 2 * DSBUF : 0);
  static constexpr int DQBOX = BQ2 * 128;               // [64 q][32 fp32]
  static constexpr int BAR = DQ + (FUSED ? (D / 32) * DQBOX : 0);
  // kvbar, full [ST], empty [ST]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * ST);
  static constexpr int ALLOC = BYTES + 1024;
};
static_assert(BwdSmem<64, false, true>::ALLOC <= 232448 &&
                  BwdSmem<128, false, true>::ALLOC <= 232448 &&
                  BwdSmem<64, true, true>::ALLOC <= 232448 &&
                  BwdSmem<128, false, false>::ALLOC <= 232448,
              "fa_bwd_wg fits in shared memory");

// dk/dv, bf16: one block per (K tile of BKV keys, group, batch, head); q
// tiles of BQ2 rows streamed.  FUSED: the fused backward, which also adds
// each q tile's ds K into the fp32 dq buffer behind tm_dq; otherwise the
// split backward's dk/dv kernel (tm_dq unused).
template <int D, bool WIDE, bool FUSED>
__global__ void __launch_bounds__(WG_THREADS, 1)
fa_bwd_wg(const __grid_constant__ CUtensorMap tm_q,
          const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v,
          const __grid_constant__ CUtensorMap tm_do,
          const __grid_constant__ CUtensorMap tm_dq,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dk,
          bf16* __restrict__ dv, int b0, int H, int N, int Nk, int hd,
          int causal, float scale) {
  using L = BwdSmem<D, WIDE, FUSED>;
  constexpr int NB = L::NB, ST = L::ST;
  // registers a thread after setmaxnreg (2 x 128 x C + 128 x P = 384 x 168)
  constexpr int CONSUMER_REGS = WIDE ? 232 : 240;
  constexpr int PRODUCER_REGS = WIDE ? 40 : 24;
  extern __shared__ __align__(1024) unsigned char smraw[];
  const uint32_t base = (smem_u32(smraw) + 1023) & ~1023u;
  const uint32_t ring = base + L::RING;
  const uint32_t kvbar = base + L::BAR, full = kvbar + 8,
                 empty = full + 8 * ST;

  int tile, grp, b, h;
  tile_of<WIDE>((Nk + BKV - 1) / BKV, tile, grp, b, h);
  b += b0;
  const int k0 = tile * BKV;
  const int nch = WIDE ? hd / GW : 1;
  const int nqt = (N + BQ2 - 1) / BQ2;
  // first q tile whose rows reach key k0 under the bottom-right diagonal
  const int qt0 = causal ? max(0, k0 - (Nk - N)) / BQ2 : 0;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + 8 * i, 2);    // the TMA thread's two arrivals
      mbar_init(empty + 8 * i, 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------- producer ----------------
    // Thread 256 issues the TMA loads; its warp copies each q tile's lse
    // and delta rows into the stage with plain loads (a TMA box may not
    // start off 16 bytes, and a row of lse starts anywhere), and thread
    // 256 arrives once more when they are in.  The WIDE producer (chunk
    // indices on top) spills at 24 registers; its consumers (64 columns of
    // dk and dv) need fewer than 240.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    const int lane = threadIdx.x - 256;
    if (lane < 32) {
      if (lane == 0 && !WIDE) {
        mbar_expect_tx(kvbar, 2 * NB * L::KBOX);
        for (int kb = 0; kb < NB; ++kb) {
          tma_load_4d(base + L::K + kb * L::KBOX, &tm_k, kvbar, 64 * kb, h,
                      k0, b);
          tma_load_4d(base + L::V + kb * L::KBOX, &tm_v, kvbar, 64 * kb, h,
                      k0, b);
        }
      }
      const long long row1 = ((long long)b * H + h) * N;
      int s = 0, ph = 0;
      for (int qt = qt0; qt < nqt; ++qt) {
        const int q0 = qt * BQ2;
        for (int ci = 0; ci < nch; ++ci) {
          const bool last = ci == nch - 1;
          const uint32_t st = ring + s * L::STAGE, bar = full + 8 * s;
          mbar_wait(empty + 8 * s, ph ^ 1);
          if (lane == 0) {
            if constexpr (WIDE) {
              const int c = chunk_of(grp, ci, nch);
              mbar_expect_tx(bar, 2 * L::KBOX + 2 * L::QBOX);
              tma_load_4d(st + L::S_K, &tm_k, bar, 64 * c, h, k0, b);
              tma_load_4d(st + L::S_V, &tm_v, bar, 64 * c, h, k0, b);
              tma_load_4d(st + L::S_Q, &tm_q, bar, 64 * c, h, q0, b);
              tma_load_4d(st + L::S_G, &tm_do, bar, 64 * c, h, q0, b);
            } else {
              mbar_expect_tx(bar, 2 * NB * L::QBOX);
              for (int kb = 0; kb < NB; ++kb) {
                tma_load_4d(st + L::S_Q + kb * L::QBOX, &tm_q, bar, 64 * kb,
                            h, q0, b);
                tma_load_4d(st + L::S_G + kb * L::QBOX, &tm_do, bar,
                            64 * kb, h, q0, b);
              }
            }
          }
          if (last) {
            float* sp = reinterpret_cast<float*>(smraw + (st - smem_u32(smraw)));
            for (int r = lane; r < BQ2; r += 32) {
              const bool in = q0 + r < N;
              sp[L::S_L / 4 + r] = in ? lse[row1 + q0 + r] : 0.f;
              sp[L::S_D / 4 + r] = in ? delta[row1 + q0 + r] : 0.f;
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(bar);
          if (++s == ST) { s = 0; ph ^= 1; }
        }
      }
    }
    return;
  }

  // ---------------- consumers ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, gq = (tid & 31) >> 2, t = tid & 3;
  const int kw = k0 + 64 * wg;                 // this warpgroup's keys
  const int key0 = kw + 16 * warp + gq;        // this thread's: key0, + 8
  const int rk = 64 * wg + 16 * warp + gq;     // its row of ds^T
  const float c2 = scale * LOG2E;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  if constexpr (!WIDE) mbar_wait(kvbar, 0);
  int si = 0, ph = 0, par = 0;

  for (int qt = qt0; qt < nqt; ++qt) {
    const int q0 = qt * BQ2;
    float sT[32], dpT[32];   // s^T, dp^T: 64 keys x 64 q
    uint32_t st = 0;
    // s^T = K Q^T, dp^T = V dO^T over the full width (WIDE: in chunks, the
    // group's own last; its stage stays for the products below)
    for (int ci = 0; ci < nch; ++ci) {
      st = ring + si * L::STAGE;
      const uint32_t ka = (WIDE ? st + L::S_K : base + L::K) + wg * 8192;
      const uint32_t va = (WIDE ? st + L::S_V : base + L::V) + wg * 8192;
      mbar_wait(full + 8 * si, ph);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < NB; ++kb)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const int acc = ci | kb | ks;
          wgmma_ss<64, 0, 0>(
              sT, sw128_desc(ka + kb * L::KBOX + ks * 32, 16, 1024),
              sw128_desc(st + L::S_Q + kb * L::QBOX + ks * 32, 16, 1024),
              acc);
          wgmma_ss<64, 0, 0>(
              dpT, sw128_desc(va + kb * L::KBOX + ks * 32, 16, 1024),
              sw128_desc(st + L::S_G + kb * L::QBOX + ks * 32, 16, 1024),
              acc);
        }
      wgmma_commit();
      wgmma_wait<0>();
      if (ci < nch - 1) {
        release(empty + 8 * si, wg);
        if (++si == ST) { si = 0; ph ^= 1; }
      }
    }

    // p^T = exp(s^T scale - lse), ds^T = p^T (dp^T - delta) scale
    const bool mask = q0 + BQ2 > N || kw + 64 > Nk ||
                      (causal && kw + 63 > q0 + Nk - N);
    const unsigned char* sp = smraw + (st - smem_u32(smraw));
    const float* Ls = reinterpret_cast<const float*>(sp + L::S_L);
    const float* Dl = reinterpret_cast<const float*>(sp + L::S_D);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t + (e & 1);
        const float lse2 = Ls[qc] * LOG2E, dl = Dl[qc];
        float p = exp2f(fmaf(sT[4 * j + e], c2, -lse2));
        if (mask && !(q0 + qc < N &&
                      visible(q0 + qc, key0 + 8 * (e >> 1), N, Nk, causal)))
          p = 0.f;
        sT[4 * j + e] = p;
        dpT[4 * j + e] = p * (dpT[4 * j + e] - dl) * scale;
      }
    uint32_t pa[16], da[16];
    acc_to_frags<16>(pa, sT);    // p cast to bf16
    acc_to_frags<16>(da, dpT);   // ds cast to bf16
    const uint32_t dsb = base + L::DS + par * L::DSBUF;
    if constexpr (FUSED) {
      // ds^T rows of this warpgroup -> shared (the A operand of dq, read
      // MN-major by both warpgroups)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const uint32_t a = dsb + sw128_off(rk + 8 * hi, 8 * j + 2 * t, 2);
          asm volatile("st.shared.u32 [%0], %1;\n"
                       :: "r"(a), "r"(da[4 * (j >> 1) + 2 * (j & 1) + hi])
                       : "memory");
        }
      fence_async_smem();
    }

    // dv += p^T dO, dk += ds^T Q (B: dO, Q read as stored, MN-major)
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      wgmma_rs<D, 1>(dv_acc, pa + 4 * ks,
                     sw128_desc(st + L::S_G + ks * 2048, L::QBOX, 1024));
      wgmma_rs<D, 1>(dk_acc, da + 4 * ks,
                     sw128_desc(st + L::S_Q + ks * 2048, L::QBOX, 1024));
    }
    wgmma_commit();
    if constexpr (!FUSED) {
      wgmma_wait<0>();
      release(empty + 8 * si, wg);
      if (++si == ST) { si = 0; ph ^= 1; }
      continue;
    }

    // dq_tile[:, this warpgroup's D / 2 columns] = ds K, once both
    // warpgroups' ds^T rows are in shared memory and the last tile's dq
    // reduction has read its staging
    if (tid == 0) bulk_wait_read();
    named_sync(3, 256);
    constexpr int DH = D / 2;
    float dq[DH / 2];
    const uint32_t kq = (WIDE ? st + L::S_K : base + L::K) +
                        (D == 128 ? wg * L::KBOX : wg * 64);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BKV / 16; ++ks)
      wgmma_ss<DH, 1, 1>(dq, sw128_desc(dsb + ks * 2048, L::DSBUF, 1024),
                         sw128_desc(kq + ks * 2048, L::KBOX, 1024), ks);
    wgmma_commit();
    wgmma_wait<0>();
    release(empty + 8 * si, wg);
    if (++si == ST) { si = 0; ph ^= 1; }
    par ^= 1;

    // dq tile -> swizzled fp32 staging -> one bulk reduction per box
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int col = wg * DH + 8 * j + 2 * t;
        const uint32_t a = base + L::DQ + (col >> 5) * L::DQBOX +
                           sw128_off(16 * warp + gq + 8 * hi, col & 31, 4);
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n"
                     :: "r"(a), "f"(dq[4 * j + 2 * hi]),
                        "f"(dq[4 * j + 2 * hi + 1])
                     : "memory");
      }
    fence_async_smem();
    wg_sync(wg);
    if (tid == 0) {
#pragma unroll
      for (int bx = wg * DH / 32; bx < (wg + 1) * DH / 32; ++bx)
        tma_reduce_add_4d(&tm_dq, base + L::DQ + bx * L::DQBOX,
                          GW * grp + 32 * bx, h, q0, b);
      bulk_commit();
    }
  }
  if (FUSED && tid == 0) bulk_wait();

  // dk, dv: bf16 rows of this thread's keys
  const int od = WIDE ? hd : D;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = key0 + 8 * hi;
    if (row >= Nk) continue;
    const long long off =
        (((long long)b * Nk + row) * H + h) * od + GW * grp;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * j + 2 * t) =
          pack_bf16(dk_acc[4 * j + 2 * hi], dk_acc[4 * j + 2 * hi + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * j + 2 * t) =
          pack_bf16(dv_acc[4 * j + 2 * hi], dv_acc[4 * j + 2 * hi + 1]);
    }
  }
}

// Shared-memory layout of fa_bwd_dq_wg<D, WIDE>.  Narrow: Q and dO
// resident (D / 64 boxes of 128 rows each); a stage holds the K and V tiles
// of BKR keys (128 at hd 64; 64 at hd 128, so that the next tile's s and dp
// fit the registers beside dq and this tile's ds).  WIDE (D = 64): a stage
// holds one 64-column chunk of Q, dO, K and V; the last chunk is the
// group's own, whose K tile the dq product reads.
template <int D, bool WIDE>
struct DqSmem {
  static constexpr int NB = D / 64;
  static constexpr int BKR = D == 128 ? 64 : 128;
  static constexpr int ST = WIDE ? 3 : 4;
  static constexpr int QBOX = FQ * 128;
  static constexpr int KBOX = BKR * 128;
  static constexpr int Q = 0;
  static constexpr int G = NB * QBOX;
  static constexpr int RING = WIDE ? 0 : 2 * NB * QBOX;
  static constexpr int S_Q = 0;                         // WIDE, in a stage
  static constexpr int S_G = QBOX;
  static constexpr int S_K = WIDE ? 2 * QBOX : 0;
  static constexpr int S_V = S_K + NB * KBOX;
  static constexpr int STAGE = S_V + NB * KBOX;
  static constexpr int BAR = RING + ST * STAGE;
  // qbar, full [ST], empty [ST]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * ST);
  static constexpr int ALLOC = BYTES + 1024;
};
static_assert(DqSmem<64, false>::ALLOC <= 232448 &&
                  DqSmem<128, false>::ALLOC <= 232448 &&
                  DqSmem<64, true>::ALLOC <= 232448,
              "fa_bwd_dq_wg fits in shared memory");

// p = exp(s scale - lse) and ds = p (dp - delta) scale of one tile of
// BKR keys (raw scores s, dp; this thread's rows row0 and row0 + 8, their
// lse in log2 units and delta), into bf16 A fragments of the dq product.
// Masked where `mask`.  s is overwritten.
template <int BKR>
__device__ __forceinline__ void ds_tile(float (&s)[BKR / 2],
                                        const float (&dp)[BKR / 2],
                                        uint32_t (&ds)[BKR / 4],
                                        const float (&lse2)[2],
                                        const float (&dl)[2], bool mask,
                                        int row0, int k0, int t, int N,
                                        int Nk, int causal, float c2,
                                        float scale) {
#pragma unroll
  for (int j = 0; j < BKR / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hi = e >> 1;
      float p = exp2f(fmaf(s[4 * j + e], c2, -lse2[hi]));
      if (mask && !visible(row0 + 8 * hi, k0 + 8 * j + 2 * t + (e & 1), N,
                           Nk, causal))
        p = 0.f;
      s[4 * j + e] = p * (dp[4 * j + e] - dl[hi]) * scale;
    }
  acc_to_frags<BKR / 4>(ds, s);   // ds cast to bf16 before ds K
}

// The split backward's dq, bf16: one block per (q tile of FQ rows, group,
// batch, head); K/V tiles streamed.  Per tile: s = Q K^T and dp = dO V^T
// from K-major tiles, ds in registers, dq += ds K with K read MN-major.
template <int D, bool WIDE>
__global__ void __launch_bounds__(WG_THREADS, 1)
fa_bwd_dq_wg(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const __grid_constant__ CUtensorMap tm_do,
             const __grid_constant__ CUtensorMap tm_dq,
             const float* __restrict__ lse, const float* __restrict__ delta,
             int b0, int H, int N, int Nk, int hd, int causal, float scale) {
  using L = DqSmem<D, WIDE>;
  constexpr int NB = L::NB, BKR = L::BKR, ST = L::ST;
  extern __shared__ __align__(1024) unsigned char smraw[];
  const uint32_t base = (smem_u32(smraw) + 1023) & ~1023u;
  const uint32_t ring = base + L::RING;
  const uint32_t qbar = base + L::BAR, full = qbar + 8, empty = full + 8 * ST;

  const int nqt = (N + FQ - 1) / FQ;
  int tile, grp, b, h;
  tile_of<WIDE>(nqt, tile, grp, b, h);
  b += b0;
  const int q0 = (nqt - 1 - tile) * FQ;     // longest rows first
  const int nch = WIDE ? hd / GW : 1;
  const int kt_end = k_tiles_for<FQ, BKR>(q0, N, Nk, causal);
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 2);   // both consumer warpgroups
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      if constexpr (!WIDE) {
        mbar_expect_tx(qbar, 2 * NB * L::QBOX);
        for (int kb = 0; kb < NB; ++kb) {
          tma_load_4d(base + L::Q + kb * L::QBOX, &tm_q, qbar, 64 * kb, h,
                      q0, b);
          tma_load_4d(base + L::G + kb * L::QBOX, &tm_do, qbar, 64 * kb, h,
                      q0, b);
        }
      }
      int s = 0, ph = 0;
      for (int kt = 0; kt < kt_end; ++kt) {
        const int k0 = kt * BKR;
        for (int ci = 0; ci < nch; ++ci) {
          const uint32_t st = ring + s * L::STAGE, bar = full + 8 * s;
          mbar_wait(empty + 8 * s, ph ^ 1);
          mbar_expect_tx(bar, L::STAGE);
          if constexpr (WIDE) {
            const int c = chunk_of(grp, ci, nch);
            tma_load_4d(st + L::S_Q, &tm_q, bar, 64 * c, h, q0, b);
            tma_load_4d(st + L::S_G, &tm_do, bar, 64 * c, h, q0, b);
            tma_load_4d(st + L::S_K, &tm_k, bar, 64 * c, h, k0, b);
            tma_load_4d(st + L::S_V, &tm_v, bar, 64 * c, h, k0, b);
          } else {
            for (int kb = 0; kb < NB; ++kb) {
              tma_load_4d(st + L::S_K + kb * L::KBOX, &tm_k, bar, 64 * kb, h,
                          k0, b);
              tma_load_4d(st + L::S_V + kb * L::KBOX, &tm_v, bar, 64 * kb, h,
                          k0, b);
            }
          }
          if (++s == ST) { s = 0; ph ^= 1; }
        }
      }
    }
    return;
  }

  // ---------------- consumers ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, gq = (tid & 31) >> 2, t = tid & 3;
  const int r0 = q0 + 64 * wg;                // this warpgroup's rows
  const int row0 = r0 + 16 * warp + gq;       // this thread's: row0, + 8
  const float c2 = scale * LOG2E;
  float lse2[2], dl[2];                       // lse in log2 units, delta
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = row0 + 8 * hi;
    const long long i = ((long long)b * H + h) * N + row;
    lse2[hi] = row < N ? lse[i] * LOG2E : 0.f;
    dl[hi] = row < N ? delta[i] : 0.f;
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  float s[BKR / 2], dp[BKR / 2];
  uint32_t ds[BKR / 4];
  int si = 0, ph = 0;
  // the mask: tiles that cross this warpgroup's diagonal or the K tail
  auto masked = [&](int k0) {
    return k0 + BKR > Nk || (causal && k0 + BKR - 1 > r0 + Nk - N);
  };

  if constexpr (WIDE) {
    // chunked s and dp, then dq += ds K from the last chunk's stage
    for (int kt = 0; kt < kt_end; ++kt) {
      const int k0 = kt * BKR;
      uint32_t st = 0;
      for (int ci = 0; ci < nch; ++ci) {
        st = ring + si * L::STAGE;
        mbar_wait(full + 8 * si, ph);
        wgmma_fence();
        scores_qk<BKR, 1>(s, st + L::S_Q + wg * 8192, 0, st + L::S_K, 0, ci);
        scores_qk<BKR, 1>(dp, st + L::S_G + wg * 8192, 0, st + L::S_V, 0, ci);
        wgmma_commit();
        wgmma_wait<0>();
        if (ci < nch - 1) {
          release(empty + 8 * si, wg);
          if (++si == ST) { si = 0; ph ^= 1; }
        }
      }
      ds_tile<BKR>(s, dp, ds, lse2, dl, masked(k0), row0, k0, t, N, Nk,
                   causal, c2, scale);
      pv<D, BKR>(dq, ds, st + L::S_K, L::KBOX);
      wgmma_wait<0>();
      if (kt < kt_end - 1) {     // the last stage stages the output
        release(empty + 8 * si, wg);
        if (++si == ST) { si = 0; ph ^= 1; }
      }
    }
  } else {
    mbar_wait(qbar, 0);
    const uint32_t qa = base + L::Q + wg * 8192, ga = base + L::G + wg * 8192;
    // tile 0's s, dp and ds; then, per tile, the next tile's s and dp and
    // this tile's dq product in flight together, the next ds under it
    mbar_wait(full, 0);
    wgmma_fence();
    scores_qk<BKR, NB>(s, qa, L::QBOX, ring + L::S_K, L::KBOX, 0);
    scores_qk<BKR, NB>(dp, ga, L::QBOX, ring + L::S_V, L::KBOX, 0);
    wgmma_commit();
    wgmma_wait<0>();
    ds_tile<BKR>(s, dp, ds, lse2, dl, masked(0), row0, 0, t, N, Nk, causal,
                 c2, scale);
    for (int kt = 0; kt < kt_end; ++kt) {
      const int cur = si;
      if (++si == ST) { si = 0; ph ^= 1; }
      const bool next = kt + 1 < kt_end;
      if (next) {
        const uint32_t st = ring + si * L::STAGE;
        mbar_wait(full + 8 * si, ph);
        wgmma_fence();
        scores_qk<BKR, NB>(s, qa, L::QBOX, st + L::S_K, L::KBOX, 0);
        scores_qk<BKR, NB>(dp, ga, L::QBOX, st + L::S_V, L::KBOX, 0);
        wgmma_commit();
      }
      pv<D, BKR>(dq, ds, ring + cur * L::STAGE + L::S_K, L::KBOX);
      uint32_t dsn[BKR / 4];
      if (next) {
        wgmma_wait<1>();                   // the next tile's s, dp are done
        const int k1 = (kt + 1) * BKR;
        ds_tile<BKR>(s, dp, dsn, lse2, dl, masked(k1), row0, k1, t, N, Nk,
                     causal, c2, scale);
      }
      wgmma_wait<0>();                     // this tile's dq product is done
      release(empty + 8 * cur, wg);
      if (next) {
#pragma unroll
        for (int i = 0; i < BKR / 4; ++i) ds[i] = dsn[i];
      }
    }
  }

  // epilogue: dq in bf16 through shared memory (this warpgroup's rows of
  // the Q tile, or of the last stage's Q chunk) to a TMA store
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dq, one,
                (WIDE ? ring + si * L::STAGE + L::S_Q : base + L::Q) + wg * 8192,
                L::QBOX, &tm_dq, grp, h, r0, b, N, wg);
}

// fp32 tiles: 64 rows (a 4 x 4 patch a thread) up to hd 128; at hd 256
// 32 rows (2 x 2), so that the q, K, V and dO tiles fit in shared memory.
template <int D> constexpr int f32_r() { return D == 256 ? 2 : 4; }
template <int D> constexpr int fwd_smem() {
  constexpr int T = 16 * f32_r<D>();
  return (T * (D + 1) + T * (D + 1) + T * D + T * (T + 1)) * 4;
}
template <int D> constexpr int dq_smem() {
  constexpr int T = 16 * f32_r<D>();
  return (2 * T * (D + 1) + 2 * T * (D + 1) + T * (T + 1) + 2 * T) * 4;
}
template <int D> constexpr int dkv_smem() {
  constexpr int T = 16 * f32_r<D>();
  return (2 * T * (D + 1) + 2 * T * (D + 1) + 2 * T * (T + 1) + 2 * T) * 4;
}
static_assert(fwd_smem<256>() <= 232448 && dq_smem<256>() <= 232448 &&
                  dkv_smem<256>() <= 232448,
              "hd 256 tiles fit in shared memory");

// The grid of one launch: `tiles` row tiles for each group, head and batch.
inline dim3 grid_of(int tiles, int B, int H, int groups = 1) {
  return dim3((unsigned)(tiles * groups), (unsigned)H, (unsigned)B);
}
constexpr int MAX_GRID_YZ = 65535;   // gridDim.y and .z; B goes in launches

// Raise the block's dynamic shared-memory limit once per kernel instance.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done = true;
  return e;
}

bool shapes_ok(int B, int H, int N, int Nk, int causal) {
  return B > 0 && H > 0 && H <= MAX_GRID_YZ && N > 0 && Nk > 0 &&
         !(causal && N > Nk);
}

// p advanced by n elements of `size` bytes (null stays null).
inline const void* adv(const void* p, long long n, int size) {
  return p ? static_cast<const char*>(p) + n * size : p;
}
inline void* adv(void* p, long long n, int size) {
  return p ? static_cast<char*>(p) + n * size : p;
}
inline float* adv(float* p, long long n) { return p ? p + n : p; }
inline const float* adv(const float* p, long long n) { return p ? p + n : p; }

// Runs launch(b0, nb) for batches [b0, b0 + nb) in slices of at most
// MAX_GRID_YZ batches; the first error stops it.
template <typename F>
cudaError_t by_batch(int B, F&& launch) {
  for (int b0 = 0; b0 < B; b0 += MAX_GRID_YZ) {
    const int nb = B - b0 < MAX_GRID_YZ ? B - b0 : MAX_GRID_YZ;
    const cudaError_t e = launch(b0, nb);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// groups of a launch: 1, or hd / GW for the WIDE instances
template <bool WIDE> int groups_of(int hd) { return WIDE ? hd / GW : 1; }

// A [B, rows, nh, hd] operand with element strides s (bf16, or fp32 for
// dq32) as a 4-D tensor map (hd, nh, rows, B), boxes of [box_rows rows x
// box_cols columns] of one (batch, head), 128-byte swizzled.
bool operand_map(CUtensorMap* m, CUtensorMapDataType type, int esz,
                 const void* p, int B, int rows, int H, int hd, Strides s,
                 int box_rows, int box_cols) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)rows,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(s.h * esz),
                                 (cuuint64_t)(s.n * esz),
                                 (cuuint64_t)(s.b * esz)};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, 1, (cuuint32_t)box_rows,
                             1};
  return tensor_map(m, type, 4, p, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}
bool bf16_operand(CUtensorMap* m, const void* p, int B, int rows, int H,
                  int hd, Strides s, int box_rows) {
  return operand_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p, B, rows, H,
                     hd, s, box_rows, 64);
}
Strides contiguous(int rows, int H, int hd) {
  return Strides{(long long)rows * H * hd, (long long)H * hd, (long long)hd};
}
// Launch `kernel` with WG_THREADS threads over the (tiles x groups, H, B)
// grid, B in slices of at most MAX_GRID_YZ; args(b0) gives the arguments.
template <typename K, typename A>
cudaError_t launch_wg_grid(K kernel, int smem, bool& done, int tiles,
                           int groups, int B, int H, cudaStream_t st,
                           A&& args) {
  cudaError_t e = allow_smem(kernel, smem, done);
  if (e != cudaSuccess) return e;
  return by_batch(B, [&](int b0, int nb) {
    args(kernel, grid_of(tiles, nb, H, groups), smem, st, b0);
    return cudaGetLastError();
  });
}

// bf16 forward (fa_fwd_wg): maps over the whole operands; by_batch only
// moves the batch origin.
template <int D, bool WIDE>
cudaError_t launch_fwd_wg(const void* q, const void* k, const void* v,
                          void* o, float* lse, int B, int H, int N, int Nk,
                          int hd, Strides sq, Strides sk, Strides sv,
                          int causal, float scale, cudaStream_t st) {
  using L = FwdSmem<D, WIDE>;
  static bool done = false;
  CUtensorMap tq, tk, tv, to;
  if (!bf16_operand(&tq, q, B, N, H, hd, sq, FQ) ||
      !bf16_operand(&tk, k, B, Nk, H, hd, sk, L::BKR) ||
      !bf16_operand(&tv, v, B, Nk, H, hd, sv, L::BKR) ||
      !bf16_operand(&to, o, B, N, H, hd, contiguous(N, H, hd), 64))
    return cudaErrorInvalidValue;
  return launch_wg_grid(
      fa_fwd_wg<D, WIDE>, L::ALLOC, done, (N + FQ - 1) / FQ,
      groups_of<WIDE>(hd), B, H, st,
      [&](auto kern, dim3 grid, int smem, cudaStream_t s, int b0) {
        kern<<<grid, WG_THREADS, smem, s>>>(tq, tk, tv, to, lse, b0, H, N, Nk,
                                            hd, causal, scale);
      });
}

// bf16 dk/dv (fa_bwd_wg): dk, dv, and with FUSED dq32 (fp32, zeroed by the
// caller) += ds @ k by bulk tensor reductions (the split kernel takes no
// dq32 and passes q's map in tm_dq's place, unread).
template <int D, bool WIDE, bool FUSED>
cudaError_t launch_bwd_wg(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, float* dq32, void* dk,
                          void* dv, int B, int H, int N, int Nk, int hd,
                          Strides sq, Strides sk, Strides sv, Strides sd,
                          int causal, float scale, cudaStream_t st) {
  using L = BwdSmem<D, WIDE, FUSED>;
  static bool done = false;
  CUtensorMap tq, tk, tv, tdo, tdq;
  if (!bf16_operand(&tq, q, B, N, H, hd, sq, BQ2) ||
      !bf16_operand(&tk, k, B, Nk, H, hd, sk, BKV) ||
      !bf16_operand(&tv, v, B, Nk, H, hd, sv, BKV) ||
      !bf16_operand(&tdo, dout, B, N, H, hd, sd, BQ2))
    return cudaErrorInvalidValue;
  if (!FUSED)
    tdq = tq;
  else if (!operand_map(&tdq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, dq32, B, N,
                        H, hd, contiguous(N, H, hd), BQ2, 32))
    return cudaErrorInvalidValue;
  return launch_wg_grid(
      fa_bwd_wg<D, WIDE, FUSED>, L::ALLOC, done, (Nk + BKV - 1) / BKV,
      groups_of<WIDE>(hd), B, H, st,
      [&](auto kern, dim3 grid, int smem, cudaStream_t s, int b0) {
        kern<<<grid, WG_THREADS, smem, s>>>(
            tq, tk, tv, tdo, tdq, lse, delta, static_cast<bf16*>(dk),
            static_cast<bf16*>(dv), b0, H, N, Nk, hd, causal, scale);
      });
}

// bf16 split dq (fa_bwd_dq_wg): dq written once, by TMA stores.
template <int D, bool WIDE>
cudaError_t launch_dq_wg(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dq, int B, int H, int N,
                         int Nk, int hd, Strides sq, Strides sk, Strides sv,
                         Strides sd, int causal, float scale,
                         cudaStream_t st) {
  using L = DqSmem<D, WIDE>;
  static bool done = false;
  CUtensorMap tq, tk, tv, tdo, tdq;
  if (!bf16_operand(&tq, q, B, N, H, hd, sq, FQ) ||
      !bf16_operand(&tk, k, B, Nk, H, hd, sk, L::BKR) ||
      !bf16_operand(&tv, v, B, Nk, H, hd, sv, L::BKR) ||
      !bf16_operand(&tdo, dout, B, N, H, hd, sd, FQ) ||
      !bf16_operand(&tdq, dq, B, N, H, hd, contiguous(N, H, hd), 64))
    return cudaErrorInvalidValue;
  return launch_wg_grid(
      fa_bwd_dq_wg<D, WIDE>, L::ALLOC, done, (N + FQ - 1) / FQ,
      groups_of<WIDE>(hd), B, H, st,
      [&](auto kern, dim3 grid, int smem, cudaStream_t s, int b0) {
        kern<<<grid, WG_THREADS, smem, s>>>(tq, tk, tv, tdo, tdq, lse, delta,
                                            b0, H, N, Nk, hd, causal, scale);
      });
}

// fp32 forward on the FMA kernel; pointers already at the launch's batch.
template <int D, bool WIDE>
cudaError_t launch_fwd_f32(const void* q, const void* k, const void* v,
                           void* o, float* lse, int B, int H, int N, int Nk,
                           int hd, Strides sq, Strides sk, Strides sv,
                           int causal, float scale, cudaStream_t st) {
  static bool done = false;
  constexpr int smem = fwd_smem<D>();
  constexpr int R = f32_r<D>();
  cudaError_t e = allow_smem(fa_fwd<D, R, WIDE>, smem, done);
  if (e != cudaSuccess) return e;
  fa_fwd<D, R, WIDE><<<grid_of((N + 16 * R - 1) / (16 * R), B, H,
                               groups_of<WIDE>(hd)),
                       NT, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, N, Nk,
      hd, sq, sk, sv, causal, scale);
  return cudaGetLastError();
}

// fp32 dq on the FMA kernel; pointers already at the launch's batch.
template <int D, bool WIDE>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, void* dq, int B, int H, int N,
                          int Nk, int hd, Strides sq, Strides sk, Strides sv,
                          Strides sd, int causal, float scale,
                          cudaStream_t st) {
  static bool done = false;
  constexpr int smem = dq_smem<D>();
  constexpr int R = f32_r<D>();
  cudaError_t e = allow_smem(fa_bwd_dq<D, R, WIDE>, smem, done);
  if (e != cudaSuccess) return e;
  fa_bwd_dq<D, R, WIDE><<<grid_of((N + 16 * R - 1) / (16 * R), B, H,
                                  groups_of<WIDE>(hd)),
                          NT, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dq), H, N, Nk, hd, sq, sk, sv, sd, causal,
      scale);
  return cudaGetLastError();
}

// fp32 dk/dv on the FMA kernel, or with FUSED the fused backward, which
// also adds dq into the zeroed fp32 dq32; pointers at the launch's batch.
template <int D, bool WIDE, bool FUSED>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, void* dk, void* dv,
                           float* dq32, int B, int H, int N, int Nk, int hd,
                           Strides sq, Strides sk, Strides sv, Strides sd,
                           int causal, float scale, cudaStream_t st) {
  static bool done = false;
  constexpr int smem = dkv_smem<D>();
  constexpr int R = f32_r<D>();
  cudaError_t e = allow_smem(fa_bwd_dkv<D, R, FUSED, WIDE>, smem, done);
  if (e != cudaSuccess) return e;
  fa_bwd_dkv<D, R, FUSED, WIDE>
      <<<grid_of((Nk + 16 * R - 1) / (16 * R), B, H, groups_of<WIDE>(hd)),
         NT, smem, st>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(dout), lse,
          delta, static_cast<float*>(dk), static_cast<float*>(dv), dq32, H,
          N, Nk, hd, sq, sk, sv, sd, causal, scale);
  return cudaGetLastError();
}

// Calls f(T(), integral_constant<int, D>(), bool_constant<WIDE>()) for
// the (dtype code, head width) pair: hd 64, 128 and 256 take their own
// instances, wider multiples of 64 the WIDE instance of the 64-column
// group; anything else is an invalid value.
template <typename F>
cudaError_t dispatch(int dtype, int hd, F&& f) {
  using W64 = std::integral_constant<int, 64>;
  using W128 = std::integral_constant<int, 128>;
  using W256 = std::integral_constant<int, 256>;
  using Narrow = std::false_type;
  using Wide = std::true_type;
  if (dtype == 0 && hd == 64) return f(float(), W64(), Narrow());
  if (dtype == 0 && hd == 128) return f(float(), W128(), Narrow());
  if (dtype == 0 && hd == 256) return f(float(), W256(), Narrow());
  if (dtype == 1 && hd == 64) return f(bf16(), W64(), Narrow());
  if (dtype == 1 && hd == 128) return f(bf16(), W128(), Narrow());
  if (dtype == 1 && hd == 256) return f(bf16(), W256(), Narrow());
  if (hd > 256 && hd % GW == 0) {
    if (dtype == 0) return f(float(), W64(), Wide());
    if (dtype == 1) return f(bf16(), W64(), Wide());
  }
  return cudaErrorInvalidValue;
}

// The bf16 backward kernels run hd 64 and 128 narrow, hd 256 and wider on
// the 64-column group path (at 256 columns a warpgroup's accumulators
// would not fit its registers).
template <int W, bool WIDE>
constexpr int bwd_width() { return W == 256 || WIDE ? 64 : W; }
template <int W, bool WIDE>
constexpr bool bwd_wide() { return W == 256 || WIDE; }

// The split backward's dk/dv (FUSED = 0) or the fused backward (FUSED = 1),
// which also adds dq into dq32 (fp32 [B, N, nh, hd], zeroed by the caller).
template <bool FUSED>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const float* lse, const float* delta, float* dq32, void* dk,
            void* dv, int B, int H, int N, int Nk, int D, const Strides& sq,
            const Strides& sk, const Strides& sv, const Strides& sd,
            int causal, float scale, int dtype, void* stream) {
  if (!shapes_ok(B, H, N, Nk, causal)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long qrow = (long long)N * H * D, krow = (long long)Nk * H * D,
                  lrow = (long long)H * N;
  return (int)dispatch(dtype, D, [&](auto t, auto w, auto wide) {
    constexpr int W = decltype(w)::value;
    constexpr bool WIDE = decltype(wide)::value;
    if constexpr (std::is_same<decltype(t), bf16>::value) {
      return launch_bwd_wg<bwd_width<W, WIDE>(), bwd_wide<W, WIDE>(), FUSED>(
          q, k, v, dout, lse, delta, dq32, dk, dv, B, H, N, Nk, D, sq, sk,
          sv, sd, causal, scale, st);
    } else {
      return by_batch(B, [&](int b0, int nb) {
        return launch_dkv_f32<W, WIDE, FUSED>(
            adv(q, b0 * sq.b, 4), adv(k, b0 * sk.b, 4), adv(v, b0 * sv.b, 4),
            adv(dout, b0 * sd.b, 4), adv(lse, b0 * lrow),
            adv(delta, b0 * lrow), adv(dk, b0 * krow, 4),
            adv(dv, b0 * krow, 4), adv(dq32, b0 * qrow), nb, H, N, Nk, D,
            sq, sk, sv, sd, causal, scale, st);
      });
    }
  });
}

}  // namespace

extern "C" int pt_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, float* lse, int B, int H, int N, int Nk,
                            int D, long long qsb, long long qsn,
                            long long qsh, long long ksb, long long ksn,
                            long long ksh, long long vsb, long long vsn,
                            long long vsh, int causal, float scale,
                            int dtype, void* stream) {
  if (!shapes_ok(B, H, N, Nk, causal)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides sq{qsb, qsn, qsh}, sk{ksb, ksn, ksh}, sv{vsb, vsn, vsh};
  const long long orow = (long long)N * H * D, lrow = (long long)H * N;
  return (int)dispatch(dtype, D, [&](auto t, auto w, auto wide) {
    constexpr int W = decltype(w)::value;
    constexpr bool WIDE = decltype(wide)::value;
    if constexpr (std::is_same<decltype(t), bf16>::value) {
      return launch_fwd_wg<W, WIDE>(q, k, v, o, lse, B, H, N, Nk, D, sq, sk,
                                    sv, causal, scale, st);
    } else {
      return by_batch(B, [&](int b0, int nb) {
        return launch_fwd_f32<W, WIDE>(
            adv(q, b0 * qsb, 4), adv(k, b0 * ksb, 4), adv(v, b0 * vsb, 4),
            adv(o, b0 * orow, 4), adv(lse, b0 * lrow), nb, H, N, Nk, D, sq,
            sk, sv, causal, scale, st);
      });
    }
  });
}

extern "C" int pt_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int B, int H, int N,
    int Nk, int D, long long qsb, long long qsn, long long qsh, long long ksb,
    long long ksn, long long ksh, long long vsb, long long vsn, long long vsh,
    long long dsb, long long dsn, long long dsh, int causal, float scale,
    int dtype, void* stream) {
  if (!shapes_ok(B, H, N, Nk, causal)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides sq{qsb, qsn, qsh}, sk{ksb, ksn, ksh}, sv{vsb, vsn, vsh},
      sd{dsb, dsn, dsh};
  const long long qrow = (long long)N * H * D, lrow = (long long)H * N;
  return (int)dispatch(dtype, D, [&](auto t, auto w, auto wide) {
    constexpr int W = decltype(w)::value;
    constexpr bool WIDE = decltype(wide)::value;
    if constexpr (std::is_same<decltype(t), bf16>::value) {
      return launch_dq_wg<bwd_width<W, WIDE>(), bwd_wide<W, WIDE>()>(
          q, k, v, dout, lse, delta, dq, B, H, N, Nk, D, sq, sk, sv, sd,
          causal, scale, st);
    } else {
      return by_batch(B, [&](int b0, int nb) {
        return launch_dq_f32<W, WIDE>(
            adv(q, b0 * qsb, 4), adv(k, b0 * ksb, 4), adv(v, b0 * vsb, 4),
            adv(dout, b0 * dsb, 4), adv(lse, b0 * lrow),
            adv(delta, b0 * lrow), adv(dq, b0 * qrow, 4), nb, H, N, Nk, D,
            sq, sk, sv, sd, causal, scale, st);
      });
    }
  });
}

extern "C" int pt_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int B, int H,
    int N, int Nk, int D, long long qsb, long long qsn, long long qsh,
    long long ksb, long long ksn, long long ksh, long long vsb, long long vsn,
    long long vsh, long long dsb, long long dsn, long long dsh, int causal,
    float scale, int dtype, void* stream) {
  return bwd_dkv<false>(q, k, v, dout, lse, delta, nullptr, dk, dv, B, H, N,
                        Nk, D, Strides{qsb, qsn, qsh}, Strides{ksb, ksn, ksh},
                        Strides{vsb, vsn, vsh}, Strides{dsb, dsn, dsh},
                        causal, scale, dtype, stream);
}

// The fused backward: dk, dv, and dq32 (fp32 [B, N, nh, hd], zeroed by the
// caller) += ds @ k.  bf16 runs fa_bwd_wg<..., true>, fp32 the FMA kernel
// with FUSED.
extern "C" int pt_flash_bwd_fused(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, float* dq32, void* dk, void* dv,
    int B, int H, int N, int Nk, int D, long long qsb, long long qsn,
    long long qsh, long long ksb, long long ksn, long long ksh, long long vsb,
    long long vsn, long long vsh, long long dsb, long long dsn, long long dsh,
    int causal, float scale, int dtype, void* stream) {
  return bwd_dkv<true>(q, k, v, dout, lse, delta, dq32, dk, dv, B, H, N, Nk,
                       D, Strides{qsb, qsn, qsh}, Strides{ksb, ksn, ksh},
                       Strides{vsb, vsn, vsh}, Strides{dsb, dsn, dsh},
                       causal, scale, dtype, stream);
}

extern "C" const char* pt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
