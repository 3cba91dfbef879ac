// Flash attention forward, split backward and fused backward for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attn.py:
//   fa_fwd_mma / fa_fwd          <- _fa_kernel      (_flash_attention_tpu)
//   fa_bwd_dq_mma / fa_bwd_dq    <- _fa_dq_kernel   (split path of
//   fa_bwd_dkv_mma / fa_bwd_dkv  <- _fa_dkv_kernel   _flash_attention_bwd_tpu)
//   fa_bwd_dkv_mma / fa_bwd_dkv  <- _fa_fused_bwd_kernel (its fused path,
//     with FUSED = true            set_default_blocks(bwd_fused=True))
// (*_mma: bf16 on the tensor cores; the others: fp32 on the CUDA cores.)
// Same arithmetic: s = (q . k) * scale in fp32 from the stored values,
// bottom-right causal mask (query i sees key j <= i + Nk - N), ragged K tail
// masked, online softmax with m/l/acc in fp32, p cast to the stored type
// before p.V, out = acc / l, lse = m + log(max(l, 1e-30)).  The backward
// recomputes p = exp(s - lse) from the saved row logsumexp, takes
// delta = rowsum(dO * O) from the wrapper, forms ds = p * (dp - delta) * scale
// and casts p and ds to the stored type before their products, as the
// Pallas kernels do.  The split backward has no atomics: dq (q tile
// stationary) and dk/dv (K/V tile stationary) are separate kernels, so its
// results are deterministic.  The fused backward is the dk/dv kernel that
// also adds each tile's ds @ k into a zeroed fp32 [B, N, nh, hd] dq buffer
// with atomic adds (the wrapper casts it to the stored type): p and ds are
// recomputed once per tile, five products against the split's seven.  The
// reference writes one fp32 dq partial per K block instead and sums them
// after; at 64-row K tiles those would take O(N^2 hd / 64) bytes, the
// buffer here O(N hd).  The order of the atomic adds varies from run to
// run, and with it the last bits of dq.
//
// Bound.  At the training shape (B=8, N=Nk=1024, nh=16, hd=64, causal, bf16)
// the forward needs 4*V*hd = 17 GFLOP (V = keys attended, summed over rows)
// against 67 MB of q/k/v/out/lse: bound by bytes on the card (20 us at
// 3.35 TB/s, 17 us at 989 TFLOP/s).  The backward needs 10*V*hd = 43 GFLOP
// (five products; the split design does seven, 60 GFLOP) against 134 MB:
// bound by operations on the tensor cores.  The fused backward does the
// five, and adds V*hd fp32 atomic adds into L2 (per K tile, its q rows).  In fp32 the 67 TFLOP/s of the
// CUDA cores bound both passes by operations.
//
// Design for that bound.  Each block owns a 64-row tile of one (batch,
// head) and streams 64-row tiles of the other operand through shared
// memory, so no [N, Nk] matrix reaches device memory.  Causal tiles above
// the diagonal are skipped (the forward and dq stop at the last K tile the
// diagonal reaches; dk/dv start at the first q tile that reaches theirs),
// and the q tiles with the most work launch first.  bf16, the training
// path's type, runs every product on the tensor cores with warp-level
// mma.sync (m16n8k16, fp32 accumulate): four warps of 16 rows each, and the
// score accumulators become the next product's operands in registers.
// fp32 runs on the CUDA cores (TF32 would break its 1e-5 tolerance): 256
// threads each own a 4 x 4 patch of the score tile in fp32 FMAs, tiles held
// in shared memory as fp32.  Neither pipelines its loads (cp.async / TMA)
// or uses wgmma yet: that is the next step toward the bound.
//
// Layout: q, k, v and dO are [B, N, nh, hd] with any strides on the first
// three axes (the model passes q/k/v as strided views of its fused qkv
// projection, so no copy is made); the last axis must be contiguous.  out,
// dq, dk, dv are contiguous [B, N|Nk, nh, hd]; lse and delta are contiguous
// fp32 [B, nh, N].  hd is 64, 128 or 256 (the wrapper zero-pads other widths
// up to the next of these; the Pallas kernel's own widths are 64 and the
// multiples of 128).  The grid is (row tiles, nh, B), B in launches of at
// most 65,535 batches, so any B * nh runs (nh up to 65,535).
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/cuda/flash_attn.py);
// dtype codes: 0 = float32, 1 = bfloat16.  Every entry point returns
// cudaGetLastError() after its launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;    // rows of the q tile
constexpr int BK = 64;    // rows of the K/V tile
constexpr int NT = 256;   // fp32 threads: 16 x 16, each an R x R patch
constexpr float NEG_INF = -1e30f;

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
template <int TQ = BQ, int TK = BK>
__device__ __forceinline__ int k_tiles_for(int q0, int N, int Nk,
                                           int causal) {
  int end = (Nk + TK - 1) / TK;
  if (causal) {
    const int last_row = min(q0 + TQ - 1, N - 1);
    end = min(end, (last_row + Nk - N) / TK + 1);
  }
  return end;
}

// The block's row tile, batch and head.  The grid is (row tiles, nh, B)
// and the launchers split B into launches of at most 65,535, so any B * nh
// runs.  (A one-dimensional grid that divides the block index measured up
// to 24% slower on the H100 in some kernels, tools/flash_variants.py.)
__device__ __forceinline__ void tile_of(int& tile, int& b, int& h) {
  tile = blockIdx.x;
  h = blockIdx.y;
  b = blockIdx.z;
}

__device__ __forceinline__ bool visible(int row, int col, int N, int Nk,
                                        int causal) {
  return col < Nk && (!causal || col <= row + Nk - N);
}

// ---------------------------------------------------------------------------
// fp32 forward: one block per (q tile, batch, head); q tiles of 16 R rows
// ---------------------------------------------------------------------------
template <int D, int R>
__global__ void __launch_bounds__(NT)
fa_fwd(const float* __restrict__ q, const float* __restrict__ k,
       const float* __restrict__ v, float* __restrict__ o,
       float* __restrict__ lse, int H, int N, int Nk, Strides sq, Strides sk,
       Strides sv, int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;
  constexpr int TQ = 16 * R, TK = 16 * R, LP = TK + 1;
  extern __shared__ float sm[];
  float* Qs = sm;               // [TQ][LD]
  float* Ks = Qs + TQ * LD;     // [TK][LD]
  float* Vs = Ks + TK * LD;     // [TK][D]
  float* Ps = Vs + TK * D;      // [TQ][LP]

  const int nqt = (N + TQ - 1) / TQ;
  int tile, b, h;
  tile_of(tile, b, h);
  const int q0 = (nqt - 1 - tile) * TQ;  // longest rows first
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  load_tile<D, TQ, LD>(Qs, q + b * sq.b + h * sq.h, sq.n, q0, N);
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
    __syncthreads();  // the previous tile's readers are done
    load_tile<D, TK, LD>(Ks, kb, sk.n, k0, Nk);
    load_tile<D, TK, D>(Vs, vb, sv.n, k0, Nk);
    __syncthreads();

    float s[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[R], c[R];
#pragma unroll
      for (int i = 0; i < R; ++i) a[i] = Qs[(ty * R + i) * LD + d];
#pragma unroll
      for (int j = 0; j < R; ++j) c[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
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
    float* orow = o + (((long long)b * N + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      orow[tx + 16 * j] = acc[i][j] / l[i];
    if (tx == 0)
      lse[((long long)b * H + h) * N + row] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// fp32 backward dq: one block per (q tile, batch, head); K/V streamed
// ---------------------------------------------------------------------------
template <int D, int R>
__global__ void __launch_bounds__(NT)
fa_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int H, int N, int Nk, Strides sq, Strides sk,
          Strides sv, Strides sd, int causal, float scale) {
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
  int tile, b, h;
  tile_of(tile, b, h);
  const int q0 = (nqt - 1 - tile) * TQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long row_base = ((long long)b * H + h) * N;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;

  load_tile<D, TQ, LD>(Qs, q + b * sq.b + h * sq.h, sq.n, q0, N);
  load_tile<D, TQ, LD>(Gs, dout + b * sd.b + h * sd.h, sd.n, q0, N);
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
    __syncthreads();
    load_tile<D, TK, LD>(Ks, kb, sk.n, k0, Nk);
    load_tile<D, TK, LD>(Vs, vb, sv.n, k0, Nk);
    __syncthreads();

    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[R], g[R], c[R], w[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        a[i] = Qs[(ty * R + i) * LD + d];
        g[i] = Gs[(ty * R + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        c[j] = Ks[(tx + 16 * j) * LD + d];
        w[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] = fmaf(a[i], c[j], s[i][j]);
          dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
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
    float* out = dq + (((long long)b * N + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) out[tx + 16 * j] = acc[i][j];
  }
}

// ---------------------------------------------------------------------------
// fp32 backward dk/dv: one block per (K tile, batch, head); q tiles
// streamed.  The thread owns key rows (ty) and query columns (tx) of the
// transposed score tile.  FUSED: also dq32 += ds @ k per q tile, the thread
// owning 4 query rows (ty) and D / 16 columns (tx) of it.
// ---------------------------------------------------------------------------
template <int D, int R, bool FUSED>
__global__ void __launch_bounds__(NT)
fa_bwd_dkv(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dk, float* __restrict__ dv,
           float* __restrict__ dq32, int H, int N, int Nk, Strides sq,
           Strides sk, Strides sv, Strides sd, int causal, float scale) {
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

  int tile, b, h;
  tile_of(tile, b, h);
  const int k0 = tile * TK;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long row_base = ((long long)b * H + h) * N;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* gb = dout + b * sd.b + h * sd.h;

  load_tile<D, TK, LD>(Ks, k + b * sk.b + h * sk.h, sk.n, k0, Nk);
  load_tile<D, TK, LD>(Vs, v + b * sv.b + h * sv.h, sv.n, k0, Nk);
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
    __syncthreads();
    load_tile<D, TQ, LD>(Qs, qb, sq.n, q0, N);
    load_tile<D, TQ, LD>(Gs, gb, sd.n, q0, N);
    load_rows(Ls, lse + row_base, q0, N, TQ);
    load_rows(Dl, delta + row_base, q0, N, TQ);
    __syncthreads();

    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
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
        float* dst = dq32 + (((long long)b * N + row) * H + h) * D;
#pragma unroll
        for (int j = 0; j < DJ; ++j) atomicAdd(dst + tx + 16 * j, aq[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = k0 + ty * R + i;
    if (row >= Nk) continue;
    const long long off = (((long long)b * Nk + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[off + tx + 16 * j] = adk[i][j];
      dv[off + tx + 16 * j] = adv[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: warp-level mma.sync m16n8k16, fp32 accumulate.
// 4 warps; each warp owns 16 rows of the stationary tile.  Tiles sit in
// shared memory as bf16 rows padded by 8 elements (16 bytes), so the
// fragment loads of a warp hit 32 distinct banks.  Fragment layout (PTX ISA,
// mma.m16n8k16): g = lane / 4, t = lane % 4; A rows g and g + 8, columns
// 2t, 2t + 1 (+ 8); B columns g, rows 2t, 2t + 1 (+ 8); the accumulator
// holds rows g (c0, c1) and g + 8 (c2, c3), columns 2t, 2t + 1.  A score
// accumulator over 16 keys is, once cast to bf16, the A fragment of the
// next product: p and ds never leave registers.
// ---------------------------------------------------------------------------
constexpr int MW = 4;             // warps per block
constexpr int MT = 32 * MW;       // threads per block
constexpr int MR = 16 * MW;       // rows of the stationary tile
static_assert(MR == BQ, "k_tiles_for assumes the q tile has BQ rows");
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of rows [r0, r0 + 16), columns [k0, k0 + 16) of row-major M.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* M, int ld,
                                       int r0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const bf16* p = M + (r0 + g) * ld + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}
// B fragment with B[k][n] = M[n0 + n][k0 + k] (M's rows are B's columns).
__device__ __forceinline__ void frag_b_rows(uint32_t (&b)[2], const bf16* M,
                                            int ld, int n0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const bf16* p = M + (n0 + g) * ld + k0 + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}
// B fragment with B[k][n] = M[k0 + k][n0 + n] (M's rows are B's rows).
__device__ __forceinline__ void frag_b_cols(uint32_t (&b)[2], const bf16* M,
                                            int ld, int k0, int n0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const bf16* p = M + (k0 + 2 * t) * ld + n0 + g;
  b[0] = pack2(p[0], p[ld]);
  b[1] = pack2(p[8 * ld], p[9 * ld]);
}
// The A fragment for k-step j of a product whose k axis is the n axis of
// the accumulators acc[2j], acc[2j + 1], cast to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack2(lo[0], lo[1]);
  a[1] = pack2(lo[2], lo[3]);
  a[2] = pack2(hi[0], hi[1]);
  a[3] = pack2(hi[2], hi[3]);
}

// Rows [r0, r0 + R) of one (batch, head) slice -> shared bf16 [R][LD] in
// 16-byte chunks (row starts and strides are multiples of 8 elements, which
// the wrapper ensures); rows at or past n_rows are zero.
template <int D, int R, int LD>
__device__ __forceinline__ void load_tile16(bf16* __restrict__ dst,
                                            const bf16* __restrict__ base,
                                            long long sn, int r0, int n_rows) {
  constexpr int C = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < R * C; i += MT) {
    const int r = i / C, c = i % C;
    const int row = r0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row < n_rows)
      v = __ldg(reinterpret_cast<const uint4*>(base + (long long)row * sn) + c);
    *reinterpret_cast<uint4*>(dst + r * LD + 8 * c) = v;
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// forward, bf16: one block per (q tile of MR rows, batch, head).  Up to hd
// 128 four blocks share an SM, so ptxas holds the kernel to 128 registers
// (left to itself it took 134 at hd 128, three blocks an SM, and ran 15%
// slower on the H100; tools/flash_variants.py).
template <int D>
__global__ void __launch_bounds__(MT, D == 256 ? 1 : 4)
fa_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ o,
           float* __restrict__ lse, int H, int N, int Nk, Strides sq,
           Strides sk, Strides sv, int causal, float scale) {
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;   // k-steps over the head width
  constexpr int ND = D / 8;    // n-tiles of the output
  constexpr int NK = BK / 8;   // n-tiles of the score tile
  extern __shared__ __align__(16) unsigned char smraw[];
  bf16* Qs = reinterpret_cast<bf16*>(smraw);  // [MR][LD]
  bf16* Ks = Qs + MR * LD;                     // [BK][LD]
  bf16* Vs = Ks + BK * LD;                     // [BK][LD]

  const int nqt = (N + MR - 1) / MR;
  int tile, b, h;
  tile_of(tile, b, h);
  const int q0 = (nqt - 1 - tile) * MR;
  const int w = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  load_tile16<D, MR, LD>(Qs, q + b * sq.b + h * sq.h, sq.n, q0, N);
  const int kt_end = k_tiles_for(q0, N, Nk, causal);
  const int row0 = q0 + 16 * w + g;  // this thread's rows: row0, row0 + 8

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile16<D, BK, LD>(Ks, kb, sk.n, k0, Nk);
    load_tile16<D, BK, LD>(Vs, vb, sv.n, k0, Nk);
    __syncthreads();

    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      frag_a(a, Qs, LD, 16 * w, 16 * ks);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        uint32_t bb[2];
        frag_b_rows(bb, Ks, LD, 8 * n, 16 * ks);
        mma16816(s[n], a, bb);
      }
    }
    float mc[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * n + 2 * t + (e & 1);
        const int hi = e >> 1;
        const float x = s[n][e] * scale;
        s[n][e] = visible(row0 + 8 * hi, col, N, Nk, causal) ? x : NEG_INF;
        mc[hi] = fmaxf(mc[hi], s[n][e]);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const float mn = fmaxf(m[hi], quad_max(mc[hi]));
      alpha[hi] = expf(m[hi] - mn);
      m[hi] = mn;
    }
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) l[hi] = alpha[hi] * l[hi] + quad_sum(rs[hi]);
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[4];
      acc_to_a(a, s[2 * ks], s[2 * ks + 1]);  // p cast to bf16 before p.V
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        uint32_t bb[2];
        frag_b_cols(bb, Vs, LD, 16 * ks, 8 * j);
        mma16816(acc[j], a, bb);
      }
    }
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = row0 + 8 * hi;
    if (row >= N) continue;
    bf16* orow = o + (((long long)b * N + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
          pack2(acc[j][2 * hi] / l[hi], acc[j][2 * hi + 1] / l[hi]);
    if (t == 0)
      lse[((long long)b * H + h) * N + row] =
          m[hi] + logf(fmaxf(l[hi], 1e-30f));
  }
}

// backward dq, bf16: one block per (q tile of MR rows, batch, head)
template <int D>
__global__ void __launch_bounds__(MT)
fa_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int H, int N, int Nk, Strides sq,
              Strides sk, Strides sv, Strides sd, int causal, float scale) {
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;
  constexpr int ND = D / 8;
  constexpr int NK = BK / 8;
  extern __shared__ __align__(16) unsigned char smraw[];
  bf16* Qs = reinterpret_cast<bf16*>(smraw);  // [MR][LD]
  bf16* Gs = Qs + MR * LD;                     // dO, [MR][LD]
  bf16* Ks = Gs + MR * LD;                     // [BK][LD]
  bf16* Vs = Ks + BK * LD;                     // [BK][LD]

  const int nqt = (N + MR - 1) / MR;
  int tile, b, h;
  tile_of(tile, b, h);
  const int q0 = (nqt - 1 - tile) * MR;
  const int w = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  const long long row_base = ((long long)b * H + h) * N;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  load_tile16<D, MR, LD>(Qs, q + b * sq.b + h * sq.h, sq.n, q0, N);
  load_tile16<D, MR, LD>(Gs, dout + b * sd.b + h * sd.h, sd.n, q0, N);
  const int kt_end = k_tiles_for(q0, N, Nk, causal);
  const int row0 = q0 + 16 * w + g;
  float Lr[2], Dr[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = row0 + 8 * hi;
    Lr[hi] = row < N ? lse[row_base + row] : 0.f;
    Dr[hi] = row < N ? delta[row_base + row] : 0.f;
  }

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile16<D, BK, LD>(Ks, kb, sk.n, k0, Nk);
    load_tile16<D, BK, LD>(Vs, vb, sv.n, k0, Nk);
    __syncthreads();

    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4], ga[4];
      frag_a(a, Qs, LD, 16 * w, 16 * ks);
      frag_a(ga, Gs, LD, 16 * w, 16 * ks);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        uint32_t bb[2];
        frag_b_rows(bb, Ks, LD, 8 * n, 16 * ks);
        mma16816(s[n], a, bb);
        frag_b_rows(bb, Vs, LD, 8 * n, 16 * ks);
        mma16816(dp[n], ga, bb);
      }
    }
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1;
        const int col = k0 + 8 * n + 2 * t + (e & 1);
        const float p = visible(row0 + 8 * hi, col, N, Nk, causal)
                            ? expf(s[n][e] * scale - Lr[hi])
                            : 0.f;
        s[n][e] = p * (dp[n][e] - Dr[hi]) * scale;  // ds
      }
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[4];
      acc_to_a(a, s[2 * ks], s[2 * ks + 1]);  // ds cast to bf16
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        uint32_t bb[2];
        frag_b_cols(bb, Ks, LD, 16 * ks, 8 * j);
        mma16816(acc[j], a, bb);
      }
    }
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = row0 + 8 * hi;
    if (row >= N) continue;
    bf16* out = dq + (((long long)b * N + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j + 2 * t) =
          pack2(acc[j][2 * hi], acc[j][2 * hi + 1]);
  }
}

// backward dk/dv, bf16: one block per (K tile of MR rows, batch, head); QB
// rows streamed.  Each warp owns 16 key rows of the transposed scores.
// FUSED: ds (cast to bf16) also goes to shared memory as [QB][MR], and
// dq32[q tile] += ds @ k on the tensor cores, each warp 16 query rows x
// D / (4 / (QB / 16)) columns, added with atomics.  At hd 64 three blocks
// share an SM, so ptxas holds the kernel to 168 registers (the fused
// instance otherwise takes 173, two blocks an SM).
template <int D, int QB, bool FUSED>
__global__ void __launch_bounds__(MT, D == 64 ? 3 : 1)
fa_bwd_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv,
               float* __restrict__ dq32, int H, int N, int Nk, Strides sq,
               Strides sk, Strides sv, Strides sd, int causal, float scale) {
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;
  constexpr int ND = D / 8;
  constexpr int NQ = QB / 8;   // n-tiles of the transposed score tile
  extern __shared__ __align__(16) unsigned char smraw[];
  bf16* Ks = reinterpret_cast<bf16*>(smraw);  // [MR][LD]
  bf16* Vs = Ks + MR * LD;                     // [MR][LD]
  bf16* Qs = Vs + MR * LD;                     // [QB][LD]
  bf16* Gs = Qs + QB * LD;                     // dO, [QB][LD]
  float* Ls = reinterpret_cast<float*>(Gs + QB * LD);  // [QB]
  float* Dl = Ls + QB;                                  // [QB]
  bf16* DSs = reinterpret_cast<bf16*>(Dl + QB);         // FUSED: [QB][MR + 8]
  constexpr int LDS = MR + 8;

  int tile, b, h;
  tile_of(tile, b, h);
  const int k0 = tile * MR;
  const int w = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  const long long row_base = ((long long)b * H + h) * N;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* gb = dout + b * sd.b + h * sd.h;
  load_tile16<D, MR, LD>(Ks, k + b * sk.b + h * sk.h, sk.n, k0, Nk);
  load_tile16<D, MR, LD>(Vs, v + b * sv.b + h * sv.h, sv.n, k0, Nk);
  const int nqt = (N + QB - 1) / QB;
  const int qt0 = causal ? max(0, k0 - (Nk - N)) / QB : 0;
  const int key0 = k0 + 16 * w + g;  // this thread's keys: key0, key0 + 8

  float adk[ND][4], adv[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[j][e] = adv[j][e] = 0.f;

  for (int qt = qt0; qt < nqt; ++qt) {
    const int q0 = qt * QB;
    __syncthreads();
    load_tile16<D, QB, LD>(Qs, qb, sq.n, q0, N);
    load_tile16<D, QB, LD>(Gs, gb, sd.n, q0, N);
    for (int i = threadIdx.x; i < QB; i += MT) {
      Ls[i] = q0 + i < N ? lse[row_base + q0 + i] : 0.f;
      Dl[i] = q0 + i < N ? delta[row_base + q0 + i] : 0.f;
    }
    __syncthreads();

    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4], va[4];
      frag_a(a, Ks, LD, 16 * w, 16 * ks);
      frag_a(va, Vs, LD, 16 * w, 16 * ks);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        uint32_t bb[2];
        frag_b_rows(bb, Qs, LD, 8 * n, 16 * ks);
        mma16816(s[n], a, bb);
        frag_b_rows(bb, Gs, LD, 8 * n, 16 * ks);
        mma16816(dp[n], va, bb);
      }
    }
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1);  // query row in the tile
        const int key = key0 + 8 * (e >> 1);
        const bool ok = q0 + c < N && visible(q0 + c, key, N, Nk, causal);
        const float p = ok ? expf(s[n][e] * scale - Ls[c]) : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - Dl[c]) * scale;  // ds
        if constexpr (FUSED)
          DSs[c * LDS + key - k0] = __float2bfloat16(dp[n][e]);
      }
#pragma unroll
    for (int ks = 0; ks < QB / 16; ++ks) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, s[2 * ks], s[2 * ks + 1]);    // p cast to bf16
      acc_to_a(da, dp[2 * ks], dp[2 * ks + 1]);  // ds cast to bf16
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        uint32_t bb[2];
        frag_b_cols(bb, Gs, LD, 16 * ks, 8 * j);
        mma16816(adv[j], pa, bb);
        frag_b_cols(bb, Qs, LD, 16 * ks, 8 * j);
        mma16816(adk[j], da, bb);
      }
    }
    if constexpr (FUSED) {
      constexpr int MTQ = QB / 16;   // m-tiles of the q tile
      constexpr int WPM = MW / MTQ;  // warps per m-tile
      constexpr int NPW = ND / WPM;  // n-tiles of dq per warp
      static_assert(MW % MTQ == 0 && ND % WPM == 0, "dq tiling");
      const int mt = w % MTQ, nb = (w / MTQ) * NPW;
      __syncthreads();  // every warp's ds is in DSs
      float aq[NPW][4];
#pragma unroll
      for (int j = 0; j < NPW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) aq[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < MR / 16; ++ks) {
        uint32_t a[4];
        frag_a(a, DSs, LDS, 16 * mt, 16 * ks);
#pragma unroll
        for (int j = 0; j < NPW; ++j) {
          uint32_t bb[2];
          frag_b_cols(bb, Ks, LD, 16 * ks, 8 * (nb + j));
          mma16816(aq[j], a, bb);
        }
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int row = q0 + 16 * mt + g + 8 * hi;
        if (row >= N) continue;
        float* dst = dq32 + (((long long)b * N + row) * H + h) * D;
#pragma unroll
        for (int j = 0; j < NPW; ++j) {
          const int col = 8 * (nb + j) + 2 * t;
          atomicAdd(dst + col, aq[j][2 * hi]);
          atomicAdd(dst + col + 1, aq[j][2 * hi + 1]);
        }
      }
    }
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = key0 + 8 * hi;
    if (row >= Nk) continue;
    const long long off = (((long long)b * Nk + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * j + 2 * t) =
          pack2(adk[j][2 * hi], adk[j][2 * hi + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * j + 2 * t) =
          pack2(adv[j][2 * hi], adv[j][2 * hi + 1]);
    }
  }
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
template <int D> constexpr int fwd_mma_smem() {
  return (MR + 2 * BK) * (D + 8) * 2;
}
template <int D> constexpr int dq_mma_smem() {
  return (2 * MR + 2 * BK) * (D + 8) * 2;
}
// q rows streamed by the bf16 dk/dv kernel: 64 keep its accumulators in
// registers at hd 64; at hd 128 the dk/dv accumulators double, so 32; at hd
// 256 they double again (256 floats a thread, past the register file, so
// they spill), and 16 rows keep the rest small.
template <int D> constexpr int dkv_qb() {
  return D == 64 ? 64 : D == 128 ? 32 : 16;
}
template <int D, bool FUSED> constexpr int dkv_mma_smem() {
  return (2 * MR + 2 * dkv_qb<D>()) * (D + 8) * 2 + 2 * dkv_qb<D>() * 4 +
         (FUSED ? dkv_qb<D>() * (MR + 8) * 2 : 0);
}
static_assert(fwd_smem<256>() <= 232448 && dq_smem<256>() <= 232448 &&
                  dkv_smem<256>() <= 232448 && dq_mma_smem<256>() <= 232448,
              "hd 256 tiles fit in shared memory");

// The grid of one launch: `tiles` row tiles for each head and batch.
inline dim3 grid_of(int tiles, int B, int H) {
  return dim3((unsigned)tiles, (unsigned)H, (unsigned)B);
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

// bf16 runs on the tensor cores (the *_mma kernels), fp32 on the FMA
// kernels; each launcher raises the dynamic shared-memory limit once.
template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int H, int N, int Nk, Strides sq,
                       Strides sk, Strides sv, int causal, float scale,
                       cudaStream_t st) {
  static bool done = false;
  cudaError_t e;
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int smem = fwd_mma_smem<D>();
    if ((e = allow_smem(fa_fwd_mma<D>, smem, done)) != cudaSuccess) return e;
    fa_fwd_mma<D><<<grid_of((N + MR - 1) / MR, B, H), MT, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, H, N, Nk,
        sq, sk, sv, causal, scale);
  } else {
    constexpr int smem = fwd_smem<D>();
    constexpr int R = f32_r<D>();
    if ((e = allow_smem(fa_fwd<D, R>, smem, done)) != cudaSuccess) return e;
    fa_fwd<D, R><<<grid_of((N + 16 * R - 1) / (16 * R), B, H), NT, smem,
                   st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, H, N, Nk,
        sq, sk, sv, causal, scale);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int B, int H, int N, int Nk, Strides sq,
                      Strides sk, Strides sv, Strides sd, int causal,
                      float scale, cudaStream_t st) {
  static bool done = false;
  cudaError_t e;
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int smem = dq_mma_smem<D>();
    if ((e = allow_smem(fa_bwd_dq_mma<D>, smem, done)) != cudaSuccess)
      return e;
    fa_bwd_dq_mma<D><<<grid_of((N + MR - 1) / MR, B, H), MT, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, static_cast<bf16*>(dq), H, N, Nk, sq, sk, sv, sd, causal,
        scale);
  } else {
    constexpr int smem = dq_smem<D>();
    constexpr int R = f32_r<D>();
    if ((e = allow_smem(fa_bwd_dq<D, R>, smem, done)) != cudaSuccess)
      return e;
    fa_bwd_dq<D, R><<<grid_of((N + 16 * R - 1) / (16 * R), B, H), NT,
                      smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dq), H, N, Nk, sq, sk, sv, sd, causal,
        scale);
  }
  return cudaGetLastError();
}

// FUSED: the fused backward, which also adds dq into the zeroed fp32 dq32.
template <typename T, int D, bool FUSED>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, float* dq32, int B, int H, int N,
                       int Nk, Strides sq, Strides sk, Strides sv, Strides sd,
                       int causal, float scale, cudaStream_t st) {
  static bool done = false;
  cudaError_t e;
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int smem = dkv_mma_smem<D, FUSED>();
    constexpr int QB = dkv_qb<D>();
    if ((e = allow_smem(fa_bwd_dkv_mma<D, QB, FUSED>, smem, done)) !=
        cudaSuccess)
      return e;
    fa_bwd_dkv_mma<D, QB, FUSED>
        <<<grid_of((Nk + MR - 1) / MR, B, H), MT, smem, st>>>(
            static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
            delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), dq32, H, N,
            Nk, sq, sk, sv, sd, causal, scale);
  } else {
    constexpr int smem = dkv_smem<D>();
    constexpr int R = f32_r<D>();
    if ((e = allow_smem(fa_bwd_dkv<D, R, FUSED>, smem, done)) != cudaSuccess)
      return e;
    fa_bwd_dkv<D, R, FUSED>
        <<<grid_of((Nk + 16 * R - 1) / (16 * R), B, H), NT, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), dq32, H, N,
        Nk, sq, sk, sv, sd, causal, scale);
  }
  return cudaGetLastError();
}

// Calls f(T(), std::integral_constant<int, hd>()) for the (dtype code,
// head width) pair; anything else is an invalid value.
template <typename F>
cudaError_t dispatch(int dtype, int D, F&& f) {
  using W64 = std::integral_constant<int, 64>;
  using W128 = std::integral_constant<int, 128>;
  using W256 = std::integral_constant<int, 256>;
  if (dtype == 0 && D == 64) return f(float(), W64());
  if (dtype == 0 && D == 128) return f(float(), W128());
  if (dtype == 0 && D == 256) return f(float(), W256());
  if (dtype == 1 && D == 64) return f(bf16(), W64());
  if (dtype == 1 && D == 128) return f(bf16(), W128());
  if (dtype == 1 && D == 256) return f(bf16(), W256());
  return cudaErrorInvalidValue;
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
  const int es = dtype == 1 ? 2 : 4;
  const long long orow = (long long)N * H * D, lrow = (long long)H * N;
  return (int)by_batch(B, [&](int b0, int nb) {
    return dispatch(dtype, D, [&](auto t, auto hd) {
      return launch_fwd<decltype(t), decltype(hd)::value>(
          adv(q, b0 * qsb, es), adv(k, b0 * ksb, es), adv(v, b0 * vsb, es),
          adv(o, b0 * orow, es), adv(lse, b0 * lrow), nb, H, N, Nk, sq, sk,
          sv, causal, scale, st);
    });
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
  const int es = dtype == 1 ? 2 : 4;
  const long long qrow = (long long)N * H * D, lrow = (long long)H * N;
  return (int)by_batch(B, [&](int b0, int nb) {
    return dispatch(dtype, D, [&](auto t, auto hd) {
      return launch_dq<decltype(t), decltype(hd)::value>(
          adv(q, b0 * qsb, es), adv(k, b0 * ksb, es), adv(v, b0 * vsb, es),
          adv(dout, b0 * dsb, es), adv(lse, b0 * lrow), adv(delta, b0 * lrow),
          adv(dq, b0 * qrow, es), nb, H, N, Nk, sq, sk, sv, sd, causal,
          scale, st);
    });
  });
}

extern "C" int pt_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int B, int H,
    int N, int Nk, int D, long long qsb, long long qsn, long long qsh,
    long long ksb, long long ksn, long long ksh, long long vsb, long long vsn,
    long long vsh, long long dsb, long long dsn, long long dsh, int causal,
    float scale, int dtype, void* stream) {
  if (!shapes_ok(B, H, N, Nk, causal)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides sq{qsb, qsn, qsh}, sk{ksb, ksn, ksh}, sv{vsb, vsn, vsh},
      sd{dsb, dsn, dsh};
  const int es = dtype == 1 ? 2 : 4;
  const long long krow = (long long)Nk * H * D, lrow = (long long)H * N;
  return (int)by_batch(B, [&](int b0, int nb) {
    return dispatch(dtype, D, [&](auto t, auto hd) {
      return launch_dkv<decltype(t), decltype(hd)::value, false>(
          adv(q, b0 * qsb, es), adv(k, b0 * ksb, es), adv(v, b0 * vsb, es),
          adv(dout, b0 * dsb, es), adv(lse, b0 * lrow), adv(delta, b0 * lrow),
          adv(dk, b0 * krow, es), adv(dv, b0 * krow, es), nullptr, nb, H, N,
          Nk, sq, sk, sv, sd, causal, scale, st);
    });
  });
}

// The fused backward: dk, dv, and dq32 (fp32 [B, N, nh, hd], zeroed by the
// caller) += ds @ k.
extern "C" int pt_flash_bwd_fused(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, float* dq32, void* dk, void* dv,
    int B, int H, int N, int Nk, int D, long long qsb, long long qsn,
    long long qsh, long long ksb, long long ksn, long long ksh, long long vsb,
    long long vsn, long long vsh, long long dsb, long long dsn, long long dsh,
    int causal, float scale, int dtype, void* stream) {
  if (!shapes_ok(B, H, N, Nk, causal)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides sq{qsb, qsn, qsh}, sk{ksb, ksn, ksh}, sv{vsb, vsn, vsh},
      sd{dsb, dsn, dsh};
  const int es = dtype == 1 ? 2 : 4;
  const long long qrow = (long long)N * H * D, krow = (long long)Nk * H * D,
                  lrow = (long long)H * N;
  return (int)by_batch(B, [&](int b0, int nb) {
    return dispatch(dtype, D, [&](auto t, auto hd) {
      return launch_dkv<decltype(t), decltype(hd)::value, true>(
          adv(q, b0 * qsb, es), adv(k, b0 * ksb, es), adv(v, b0 * vsb, es),
          adv(dout, b0 * dsb, es), adv(lse, b0 * lrow), adv(delta, b0 * lrow),
          adv(dk, b0 * krow, es), adv(dv, b0 * krow, es),
          adv(dq32, b0 * qrow), nb, H, N, Nk, sq, sk, sv, sd, causal, scale,
          st);
    });
  });
}

extern "C" const char* pt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
