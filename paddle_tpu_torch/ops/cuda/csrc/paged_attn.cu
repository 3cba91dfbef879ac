// Single-token paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attn.py::
// _paged_decode_kernel (launched by _paged_attention_tpu).  Same contract:
// q [S,1,nh,hd], K/V pools [P,ps,nh,hd], page_table int32 [S,maxP], lens
// int32 [S]; slot s attends positions 0..lens[s] inclusive (the new token
// is already in its page at position lens[s]) at scale 1/sqrt(hd).  Scores
// and the online softmax are fp32; p is cast to the V type before p.V,
// which accumulates in fp32; the sum is divided by max(l, 1e-30) at the
// end, exactly as the Pallas kernel does.  Pages past the fill (j*ps >
// lens[s]) are never read.  A table entry outside [0, P) reads the page
// the reference's gather reads (page_of): a negative entry wraps once
// (e + P), then the index is clamped to [0, P - 1].
//
// Bound: bytes.  The kernel must read the K and V rows of every attended
// position once: sum_s (lens[s]+1) * nh * hd * 2 * itemsize bytes (about
// 5 MB, 1.53 us at 3.35 TB/s, for the serving decode step of gpt_345m: 8
// slots, 16 heads of 64, bf16); it does 4 flops per element read, far below
// the card's flops-per-byte balance.  The TPU kernel streamed one page per
// sequential grid step with the page id scalar-prefetched into its
// BlockSpec; Hopper has no scalar prefetch and no sequential grid.  The
// first Hopper port gave each (head, slot) one block that walked all of
// the slot's positions, so the longest slot set the time (10.5 us at that
// shape, 14.5% of the bound) and 128 blocks left SMs idle.
//
// Design (flash decoding):
//  * Splits.  The positions of each slot are cut into splits of whole
//    pages (pps pages, at least 64 positions, at most 32 splits, chosen by
//    the wrapper from maxP), and a block takes one (head, slot, split):
//    grid (nh, S, splits), 128 threads.  Splits past a slot's fill exit at
//    once, so every filled page is read by exactly one block, no slot's
//    length serialises the step, and at the serving shape a block has its
//    whole split in flight at once.
//  * Loads.  G threads share one position (each a 16-byte slice of the
//    head's K and V row; G the power of two that covers hd, the lanes past
//    hd masked, so any hd up to 32 slices: 256 in bf16, 128 in fp32; rows
//    off 16 bytes take one-element loads); a warp reads 32/G positions per
//    load, and each group issues the loads of U = 4 positions before using
//    any.  A block first loads lens[s], its split's table entries (into
//    shared memory) and its q row, all at once, so its K/V loads wait on
//    one memory round trip rather than a chain of three.
//  * Merges.  Each group keeps its online-softmax state (m, l and its
//    slice of the accumulator) in registers; the block merges its groups
//    with one weight exp(m_g - m) a group.  A slot of one split writes its
//    output directly.  Otherwise each block writes its partial (m, l,
//    unnormalised accumulator) to a workspace and takes a ticket; the last
//    block of the (slot, head) loads every split's partial in one round
//    trip, merges them in split order with one weight a split, writes the
//    output and resets the ticket, so the result does not depend on block
//    timing.  One launch a call; the wrapper allocates the workspace and
//    tickets once per device and reuses them.
//
// Measured (H100 80GB HBM3, 700 W, chip_smoke.py (c), 8 pool copies cycled
// past the L2; the first port's kernel in brackets): 0.0104 ms at the
// serving decode shape [0.0105], 0.0279 at 16 slots of up to 1,023
// positions [0.0313], 0.0232 at one slot of 8,191 positions [0.220 in
// tools/serving_kernels.py], and slower at hd 24 (0.0080 [0.0062]), whose
// few positions a split leave the merge's round trips exposed.  What
// bounds it (tools/serving_kernels.py cuts): the launch (1.7 us), the
// loads and compute of the splits (7.9 us with the merge cut) and the
// merge's fence, ticket and loads (3.7 us), against a 1.53 us byte bound.
// A variant that read 4 heads a block and merged a slot's splits, at most
// 8, through a thread-block cluster's distributed shared memory took 20.0
// us at the serving shape: its blocks walked 2-32 times the positions,
// with fewer in flight.
//
// The int8-pool kernel (paged_decode_q8, replacing _paged_decode_kernel_
// quant) follows below: the same splits and merge on a plan sized from the
// grid, a cp.async ring and a shuffle-tree merge of its groups.
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/cuda/
// paged_attn.py); dtype codes: 0 = float32, 1 = bfloat16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int U = 4;            // positions per group between state updates
constexpr float NEG_INF = -1e30f;

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

// 16 bytes of T at p -> floats
template <typename T>
__device__ __forceinline__ void load16(const T* __restrict__ p,
                                       float (&out)[16 / sizeof(T)]) {
  uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < (int)(16 / sizeof(T)); ++k) out[k] = to_f(e[k]);
}

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The E = 16 / sizeof(T) elements [i0, i0 + E) of a head row at p -> floats,
// zero past hd.  VECL: one 16-byte load (hd is a multiple of E and the row
// 16-byte aligned, so a chunk is in or out whole); else one element at a
// time.
template <typename T, bool VECL>
__device__ __forceinline__ void load_row(const T* __restrict__ p, int i0,
                                         int hd,
                                         float (&out)[16 / sizeof(T)]) {
  constexpr int E = 16 / (int)sizeof(T);
  if constexpr (VECL) {
    if (i0 < hd) {
      load16<T>(p + i0, out);
    } else {
#pragma unroll
      for (int k = 0; k < E; ++k) out[k] = 0.f;
    }
  } else {
#pragma unroll
    for (int k = 0; k < E; ++k)
      out[k] = i0 + k < hd ? to_f(__ldg(p + i0 + k)) : 0.f;
  }
}

constexpr int PT = 128;         // threads of paged_decode
constexpr int PMAX_SPLITS = 32; // splits of a slot at most
constexpr int PID_CACHE = 256;  // page ids of a split kept in shared memory

// The page a table entry e names, as the reference's gather reads it
// (jnp indexing of k_pages[page_table]): a negative entry wraps once, then
// the index is clamped to [0, P - 1].  At P = 5, entries -1, -7, 5 and 9
// read pages 4, 0, 4 and 4.
__device__ __forceinline__ int page_of(int e, int P) {
  return min(max(e < 0 ? e + P : e, 0), P - 1);
}


// The merge weights of `n` partial states (m, l) at sm_m / sm_l, computed
// by warp 0: sm_w[i] = exp(m_i - max m), and the merged l into *L, summed
// in index order.  The caller syncs before and after.
__device__ __forceinline__ void merge_weights(const float* sm_m,
                                              const float* sm_l, float* sm_w,
                                              int n, float* L) {
  float M = NEG_INF;
  for (int i = threadIdx.x; i < n; i += 32) M = fmaxf(M, sm_m[i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
  for (int i = threadIdx.x; i < n; i += 32) sm_w[i] = expf(sm_m[i] - M);
  __syncwarp();
  if (threadIdx.x == 0) {
    float l = 0.f;
    for (int i = 0; i < n; ++i) l += sm_l[i] * sm_w[i];
    *L = l;
  }
}

// The end of a block of a split plan with ns > 1 splits at work, after it
// wrote its partial (unnormalised accumulator, then (m, l) at ml): the last
// split of (slot, head) to arrive, by ticket, loads every split's partial
// in one round trip, merges them in split order with one weight a split,
// writes the output o and resets the ticket, so the result does not depend
// on block timing.  parts: the (slot, head)'s [splits][hd] accumulators;
// ml: its [splits][2] (m, l).  NT threads, each merging the output
// elements threadIdx.x + e NT.  A split's accumulator holds hd elements,
// ld apart from the next split's.
template <typename T, int NT, int HD>
__device__ __forceinline__ void merge_splits(const float* parts,
                                             const float* ml, int* ticket,
                                             T* __restrict__ o, int hd,
                                             int ld, int ns) {
  constexpr int HDT = (HD + NT - 1) / NT;
  __shared__ float sm_m[PMAX_SPLITS], sm_l[PMAX_SPLITS], sm_w[PMAX_SPLITS];
  __shared__ float sm_L;
  __shared__ int sm_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) sm_last = atomicAdd(ticket, 1) == ns - 1;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  // one round trip: the partials' (m, l) and this thread's accumulator
  // elements of every split are loaded together, then weighted
  float v[HDT][PMAX_SPLITS];
#pragma unroll
  for (int e = 0; e < HDT; ++e) {
    const int d = threadIdx.x + e * NT;
#pragma unroll
    for (int i = 0; i < PMAX_SPLITS; ++i)
      v[e][i] = i < ns && d < hd ? __ldcg(parts + i * ld + d) : 0.f;
  }
  if (threadIdx.x < ns) {
    sm_m[threadIdx.x] = __ldcg(ml + 2 * threadIdx.x);
    sm_l[threadIdx.x] = __ldcg(ml + 2 * threadIdx.x + 1);
  }
  __syncthreads();
  if (threadIdx.x < 32) merge_weights(sm_m, sm_l, sm_w, ns, &sm_L);
  __syncthreads();
  const float LL = sm_L;
#pragma unroll
  for (int e = 0; e < HDT; ++e) {
    const int d = threadIdx.x + e * NT;
    if (d >= hd) continue;
    float A = 0.f;
#pragma unroll
    for (int i = 0; i < PMAX_SPLITS; ++i)
      if (i < ns) A += v[e][i] * sm_w[i];       // in split order
    o[d] = from_f<T>(A / fmaxf(LL, 1e-30f));
  }
  if (threadIdx.x == 0) *ticket = 0;
}

// grid (nh * kc, S, splits); split j of slot s takes positions [j span,
// min(n, j span + span)), span = pps * ps.  G threads per position, each
// VEC = 16 / sizeof(T) elements of the head row: hd <= G * VEC, the lanes
// past hd masked.  WIDE (heads wider than 32 slices): G = 32, and the head
// is cut into kc = ceil(hd / HD) head-width groups of HD = 32 VEC columns;
// block x = h kc + g owns columns [g HD, g HD + HD) of the output and
// reads those of V, but sums its scores over every group of K (as the
// flash kernels' head-width groups recompute the scores over the full
// width).  ws: [S * nh * kc][splits][ld] unnormalised accumulators (ld =
// hd, or HD where WIDE), then [S * nh * kc][splits][2] (m, l); tickets:
// [S * nh * kc], kept at 0.
template <typename T, int G, bool VECL, bool WIDE>
__global__ void __launch_bounds__(PT)
paged_decode(const T* __restrict__ q, const T* __restrict__ kp,
             const T* __restrict__ vp, const int* __restrict__ table,
             const int* __restrict__ lens, T* __restrict__ out,
             float* __restrict__ ws, int* __restrict__ tickets, int nh,
             int hd, int P, int ps, int maxP, int pps, int splits, int kc,
             float scale_div) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int HD = VEC * G;
  constexpr int NG = PT / G;       // position groups per block
  __shared__ float sm_m[NG], sm_l[NG], sm_w[NG], sm_L;
  __shared__ float sm_acc[NG][HD];
  __shared__ int sm_pid[PID_CACHE];

  const int s = blockIdx.y, j = blockIdx.z;
  const int h = WIDE ? blockIdx.x / kc : blockIdx.x;
  const int hg = WIDE ? blockIdx.x - h * kc : 0;   // head-width group
  const int c0 = hg * HD;                          // its first column
  const int cols = WIDE ? min(HD, hd - c0) : hd;   // its columns
  const int ld = WIDE ? HD : hd;                   // a partial's stride
  const int gi = threadIdx.x / G, li = threadIdx.x % G;
  const int* trow = table + (long long)s * maxP;
  const long long sh = (long long)s * nh + h;
  const long long sv = sh * kc + hg;               // its partials, ticket
  const int i0 = li * VEC;
  // lens, the split's table entries and q are independent loads: all in
  // flight at once
  const int ln = __ldg(lens + s);
  for (int e = threadIdx.x; e < min(pps, PID_CACHE); e += PT) {
    const int te = j * pps + e;
    sm_pid[e] = te < maxP ? page_of(__ldg(trow + te), P) : 0;
  }
  float qf[VEC];
  load_row<T, VECL>(q + sh * hd, i0, hd, qf);
  const int view = maxP * ps;
  const int n = max(0, min(ln + 1, view));
  const int span = pps * ps;
  const int ns = max(1, (n + span - 1) / span);   // splits with work
  if (j >= ns) return;
  __syncthreads();
  const int p0 = j * span, p1 = min(n, p0 + span);
  const long long pos_stride = (long long)nh * hd;
  const long long page_stride = (long long)ps * pos_stride;
  const long long head_off = (long long)h * hd;

  float m = NEG_INF, l = 0.f;
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;

  // the trip count is uniform over the block, so every lane reaches the
  // shuffles in group_sum
  for (int base = p0; base < p1; base += NG * U) {
    float vf[U][VEC], sc[U];
    bool ok[U];
    if constexpr (!WIDE) {
      float kf[U][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = base + u * NG + gi;
        ok[u] = p < p1;
        if (ok[u]) {
          const int e = p / ps - j * pps;          // page of the split
          const int pid = e < PID_CACHE ? sm_pid[e]
                                        : page_of(__ldg(trow + p / ps), P);
          const long long off = pid * page_stride +
                                (long long)(p % ps) * pos_stride + head_off;
          load_row<T, VECL>(kp + off, i0, hd, kf[u]);
          load_row<T, VECL>(vp + off, i0, hd, vf[u]);
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) kf[u][k] = vf[u][k] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float d = 0.f;
#pragma unroll
        for (int k = 0; k < VEC; ++k) d += qf[k] * kf[u][k];
        d = group_sum<G>(d);
        sc[u] = ok[u] ? d / scale_div : NEG_INF;
      }
    } else {
      // the score over every head-width group of K, one group at a time
      // for the U positions (each group of q read again from L1; the
      // loop kept rolled, which holds the one-element-load instances to
      // no spill), then V in this block's group
      long long off[U];
      float d[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = base + u * NG + gi;
        ok[u] = p < p1;
        off[u] = 0;
        d[u] = 0.f;
        if (ok[u]) {
          const int e = p / ps - j * pps;
          const int pid = e < PID_CACHE ? sm_pid[e]
                                        : page_of(__ldg(trow + p / ps), P);
          off[u] = pid * page_stride + (long long)(p % ps) * pos_stride +
                   head_off;
        }
      }
#pragma unroll 1
      for (int c = 0; c < kc; ++c) {
        float qc[VEC];
        load_row<T, VECL>(q + sh * hd, c * HD + i0, hd, qc);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (!ok[u]) continue;
          float kf[VEC];
          load_row<T, VECL>(kp + off[u], c * HD + i0, hd, kf);
#pragma unroll
          for (int k = 0; k < VEC; ++k) d[u] += qc[k] * kf[k];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (ok[u]) {
          load_row<T, VECL>(vp + off[u], c0 + i0, hd, vf[u]);
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) vf[u][k] = 0.f;
        }
        const float dd = group_sum<G>(d[u]);
        sc[u] = ok[u] ? dd / scale_div : NEG_INF;
      }
    }
    float mx = m;
#pragma unroll
    for (int u = 0; u < U; ++u) mx = fmaxf(mx, sc[u]);
    const float alpha = expf(m - mx);
    l *= alpha;
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float pu = ok[u] ? expf(sc[u] - mx) : 0.f;
      l += pu;
      const float pc = to_f(from_f<T>(pu));  // p cast to the V type
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += pc * vf[u][k];
    }
    m = mx;
  }

  // the block's groups merged: one weight a group
  if (li == 0) {
    sm_m[gi] = m;
    sm_l[gi] = l;
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) sm_acc[gi][i0 + k] = acc[k];
  __syncthreads();
  if (threadIdx.x < 32) merge_weights(sm_m, sm_l, sm_w, NG, &sm_L);
  __syncthreads();
  const float L = sm_L;
  T* o = out + sh * hd + c0;
  float* part = ws + (sv * splits + j) * ld;
  float* ml = ws + (long long)gridDim.y * nh * kc * splits * ld;
  for (int d = threadIdx.x; d < cols; d += PT) {
    float A = 0.f;
    for (int g = 0; g < NG; ++g) A += sm_acc[g][d] * sm_w[g];
    if (ns == 1)
      o[d] = from_f<T>(A / fmaxf(L, 1e-30f));
    else
      part[d] = A;
  }
  if (ns == 1) return;
  if (threadIdx.x == 0) {
    float M = NEG_INF;
    for (int g = 0; g < NG; ++g) M = fmaxf(M, sm_m[g]);
    ml[2 * (sv * splits + j)] = M;
    ml[2 * (sv * splits + j) + 1] = L;
  }
  merge_splits<T, PT, HD>(ws + sv * splits * ld, ml + 2 * sv * splits,
                          tickets + sv, o, cols, ld, ns);
}

// ---------------------------------------------------------------------------
// int8 pool (paged_decode_q8): replaces paddle_tpu/ops/pallas/
// paged_attn.py::_paged_decode_kernel_quant (launched by
// _paged_attention_quant_tpu).  K/V pages are int8 [P, ps, nh, hd] with
// fp32 scales [P, ps, nh], one per position per head.  The casts follow
// the Pallas kernel: q . (int8 K x k_scale) in fp32 over sqrt(hd), the
// softmax in fp32, V dequantized to fp32 and rounded to the compute dtype
// T, as is p, and p . V accumulated in fp32.
//
// Bound: bytes, 1 byte per K/V element plus 8 bytes of scales per position
// and head (136 bytes a position at 16 heads of 64): 0.75 us for the
// serving decode step (8 slots of 17-331 positions), 5.3 us for one slot
// of 8,191 positions.  The first Hopper port gave each (head, slot) one
// block that walked the whole slot, loading a table entry and only then
// the rows it named on each step of 256 positions (two dependent round
// trips a step), and ended in a 64-step serial merge of its groups: 8.3 us
// at the decode shape, and 16 blocks for one slot.
//
// Design:
//  * A split plan sized from the grid (the wrapper's _grid_plan, from S,
//    nh, maxP and ps; no device value): one split a slot while the S * nh
//    blocks reach the SMs, so the decode shape pays no merge, else
//    whole-page splits of at least 512 positions up to one block an SM (at
//    most 32).  Grid (nh, S,
//    splits) of QT threads; splits past a slot's fill exit at once, and
//    the splits of a slot merge as paged_decode's do (merge_splits, the
//    same workspace and tickets).
//  * One round trip before the loads: lens, the split's table entries
//    (into shared memory) and q are loaded together.  Then each thread
//    puts the 16-byte K and V slices of its positions into its own slots
//    of a shared-memory ring by cp.async, QSTAGES stages of QU positions a
//    group ahead, and lane 0 of each group the positions' two scales:
//    every row of a split of up to 512 positions (at hd 64) is in flight
//    before the first is used, and a longer split streams through the
//    ring.  A thread reads back only its own slots (the scales after a
//    warp barrier), so the ring needs no block barrier.  Rows off 16 bytes
//    take one-byte loads into the ring.
//  * Few instructions an element, which bound it (below): int8 -> fp32 by
//    the float 2^23 + u trick (a permute and an add a value, exact) and
//    fp32 FMAs; the K scale multiplies the dot product once; V rounds to
//    bf16 two values a conversion (in fp32 its scale folds into p); each
//    position's table column and page offset advance by additions.
//  * The block's groups merge by a shuffle tree inside each warp, then one
//    shared-memory pass over the warps.
//
// Measured (H100 80GB HBM3, 700 W, tools/serving_kernels.py; the first
// port's kernel in brackets): 0.0057 ms at the serving decode lengths
// [0.0089], 0.0175 at 16 ragged slots over 64 pages [0.0233], 0.0155 at
// one slot of 8,191 positions in 8 splits [0.1204].  What bounds it is
// its instructions more than its bytes: with no K/V loads at all it takes
// 0.0046 ms at the decode shape (an empty launch 0.0014) and 0.0113 at
// 8,191 positions, where the merge of the splits costs 0.0033.  Other
// rings (1 or 4 positions a group a stage, 512 threads) measured slower
// at the decode shape (4 positions: within 2% at the other two), other
// split counts (2 at the decode shape; 4, 16 or 32 at 8,191 positions)
// slower everywhere.
// ---------------------------------------------------------------------------
constexpr int QT = 256;          // threads of paged_decode_q8
constexpr int QNW = QT / 32;     // its warps
constexpr int QU = 2;            // positions of a group in a ring stage
constexpr int QSTAGES = 4;       // ring stages in flight
constexpr int QPID_MAX = 2048;   // page ids of a split kept in shared memory

// paged_decode_q8's dynamic shared memory with G threads a position: the
// ring's K/V slices [QSTAGES][QU][K, V][QT], its scales
// [QSTAGES][QU][K, V][QT / G], then the split's page ids
__host__ __device__ constexpr int q8_kv_bytes() {
  return QSTAGES * QU * 2 * QT * 16;
}
__host__ __device__ constexpr int q8_ring_bytes(int G) {
  return q8_kv_bytes() + QSTAGES * QU * 2 * (QT / G) * 4;
}
// two blocks an SM (128 registers a thread) up to hd 256; wider heads keep
// the merge's 2 x 32 partial elements a thread in registers instead
__host__ __device__ constexpr int q8_min_blocks(int G) {
  return G <= 16 && QT <= 256 ? 2 : 1;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// n of `bytes` bytes at src -> dst in shared memory, asynchronously; the
// rest of the `bytes` are zeros (none read where n = 0)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool on) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(on ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool on) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(on ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// until at most N of this thread's newest commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The 16 signed bytes of r -> floats, exactly: with u = b + 128 in the low
// byte of the float 2^23 (0x4B000000) the float is 2^23 + u, and less
// 2^23 + 128 it is b.
__device__ __forceinline__ void i8x16_float(const uint4& r, float (&f)[16]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t u = w[c] ^ 0x80808080u;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[4 * c + b] =
          __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + b)) -
          8388736.f;
  }
}

// a and b rounded to T and back (for bf16 one packed conversion of both)
template <typename T>
__device__ __forceinline__ void round_pair(float& a, float& b) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const uint32_t u = *reinterpret_cast<const uint32_t*>(&h);
    a = __uint_as_float(u << 16);
    b = __uint_as_float(u & 0xFFFF0000u);
  }
}

template <typename T, bool VECL>
__device__ __forceinline__ void load_q16(const T* __restrict__ p, int i0,
                                         int hd, float (&out)[16]) {
  constexpr int V = 16 / (int)sizeof(T);
#pragma unroll
  for (int c = 0; c < 16 / V; ++c) {
    float part[V];
    load_row<T, VECL>(p, i0 + c * V, hd, part);
#pragma unroll
    for (int k = 0; k < V; ++k) out[c * V + k] = part[k];
  }
}

// The 16 int8 at p[i0..] into dst in shared memory (zeros past hd and
// where !ok), one byte at a time, each stored as it arrives.
__device__ __forceinline__ void copy_i8_bytes(int8_t* dst,
                                              const int8_t* __restrict__ p,
                                              int i0, int hd, bool ok) {
#pragma unroll
  for (int k = 0; k < 16; ++k)
    dst[k] = ok && i0 + k < hd ? __ldg(p + i0 + k) : 0;
}

// The 16 int8 at p[i0..] as floats, zeros past hd: one 16-byte load where
// VECL (hd a multiple of 16 and the row aligned), else one byte at a time.
template <bool VECL>
__device__ __forceinline__ void load_i8x16(const int8_t* __restrict__ p,
                                           int i0, int hd, float (&f)[16]) {
  if constexpr (VECL) {
    const uint4 r = i0 < hd ? __ldg(reinterpret_cast<const uint4*>(p + i0))
                            : make_uint4(0u, 0u, 0u, 0u);
    i8x16_float(r, f);
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k)
      f[k] = i0 + k < hd ? (float)__ldg(p + i0 + k) : 0.f;
  }
}

// grid (nh * kc, S, splits); split j of slot s takes positions [j span,
// min(n, j span + span)), span = pps * ps, as paged_decode's.  G threads
// per position, each 16 int8 elements of the head row: hd <= 16 * G, the
// lanes past hd masked.  WIDE (heads wider than 512): G = 32 and kc
// head-width groups of HD = 512 columns, as paged_decode's: the ring
// carries K's first group and V's columns of this block's group, and the
// score's other groups of K are loaded where they are used.  ws and
// tickets as paged_decode takes them.
template <typename T, int G, bool VECL, bool WIDE>
__global__ void __launch_bounds__(QT, q8_min_blocks(G))
paged_decode_q8(const T* __restrict__ q, const int8_t* __restrict__ kp,
                const float* __restrict__ ksc, const int8_t* __restrict__ vp,
                const float* __restrict__ vsc, const int* __restrict__ table,
                const int* __restrict__ lens, T* __restrict__ out,
                float* __restrict__ ws, int* __restrict__ tickets, int nh,
                int hd, int P, int ps, int maxP, int pps, int splits,
                int kc, float scale_div) {
  constexpr int HD = 16 * G;
  constexpr int NG = QT / G;       // position groups
  constexpr int SP = NG * QU;      // positions a stage
  extern __shared__ __align__(16) unsigned char q8_smem[];
  uint4* ring = reinterpret_cast<uint4*>(q8_smem);
  float* sring = reinterpret_cast<float*>(q8_smem + q8_kv_bytes());
  int* pid = reinterpret_cast<int*>(q8_smem + q8_ring_bytes(G));
  // the warps' merge, over the ring once it is drained: [QNW][HD]
  float* sm_acc = reinterpret_cast<float*>(q8_smem);
  __shared__ float sm_m[QNW], sm_l[QNW];

  const int s = blockIdx.y, j = blockIdx.z;
  const int h = WIDE ? blockIdx.x / kc : blockIdx.x;
  const int hg = WIDE ? blockIdx.x - h * kc : 0;   // head-width group
  const int c0 = hg * HD;                          // its first column
  const int cols = WIDE ? min(HD, hd - c0) : hd;   // its columns
  const int ld = WIDE ? HD : hd;                   // a partial's stride
  const int t = threadIdx.x, gi = t / G, li = t % G, i0 = li * 16;
  const int* trow = table + (long long)s * maxP;
  const long long sh = (long long)s * nh + h;
  const long long sv = sh * kc + hg;               // its partials, ticket
  const int cache = min(pps, QPID_MAX);
  // lens, the split's table entries and q are independent loads: all in
  // flight at once
  const int ln = __ldg(lens + s);
  for (int e = t; e < cache; e += QT) {
    const int te = j * pps + e;
    pid[e] = te < maxP ? page_of(__ldg(trow + te), P) : 0;
  }
  float qf[16];
  load_q16<T, VECL>(q + sh * hd, i0, hd, qf);
  const int n = max(0, min(ln + 1, maxP * ps));
  const int span = pps * ps;
  const int ns = max(1, (n + span - 1) / span);   // splits with work
  if (j >= ns) return;
  __syncthreads();
  const int p0 = j * span, p1 = min(n, p0 + span);
  const int nst = (max(p1 - p0, 0) + SP - 1) / SP;  // stages of the split
  const long long pos_stride = (long long)nh * hd;
  const long long head_off = (long long)h * hd;
  const float inv_div = 1.f / scale_div;

  // stage st of the split into ring slot st % QSTAGES: this thread's K and
  // V slices of its group's QU positions and, by the group's lane 0,
  // their scales (zeros past the split); one commit group a stage, empty
  // past the last stage.  Called for st = 0, 1, 2, ... in turn: each
  // position's table column and offset in its page advance by SP
  // positions a call, with no division.
  int pp[QU], col[QU], po[QU];
#pragma unroll
  for (int u = 0; u < QU; ++u) {
    pp[u] = p0 + u * NG + gi;
    col[u] = pp[u] / ps;
    po[u] = pp[u] % ps;
  }
  const int sp_cols = SP / ps, sp_off = SP % ps;
  auto issue = [&](int st) {
    if (st < nst) {
      const int slot = st % QSTAGES;
#pragma unroll
      for (int u = 0; u < QU; ++u) {
        const bool ok = pp[u] < p1;
        long long row = 0;
        if (ok) {
          const int e = col[u] - j * pps;
          const int pg = e < cache
                             ? pid[e]
                             : page_of(__ldg(trow + col[u]), P);
          row = (long long)pg * ps + po[u];
        }
        const long long off = row * pos_stride + head_off;
        uint4* dk = ring + (slot * QU + u) * 2 * QT + t;
        if constexpr (VECL) {
          const bool on = ok && i0 < hd;
          const bool von = ok && c0 + i0 < hd;
          cp_async16(dk, kp + off + (on ? i0 : 0), on);
          cp_async16(dk + QT, vp + off + (von ? c0 + i0 : 0), von);
        } else {
          copy_i8_bytes(reinterpret_cast<int8_t*>(dk), kp + off, i0, hd, ok);
          copy_i8_bytes(reinterpret_cast<int8_t*>(dk + QT), vp + off,
                        c0 + i0, hd, ok);
        }
        if (li == 0) {
          float* sk = sring + (slot * QU + u) * 2 * NG + gi;
          cp_async4(sk, ksc + (ok ? row * nh + h : 0), ok);
          cp_async4(sk + NG, vsc + (ok ? row * nh + h : 0), ok);
        }
        pp[u] += SP;
        col[u] += sp_cols;
        po[u] += sp_off;
        if (po[u] >= ps) {
          po[u] -= ps;
          ++col[u];
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int st = 0; st < QSTAGES; ++st) issue(st);
  float m = NEG_INF, l = 0.f;
  float acc[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = 0.f;
  // the trip count is uniform over the block, so every lane reaches the
  // shuffles in group_sum
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<QSTAGES - 1>();
    __syncwarp();                  // lane 0's scales, for the whole group
    const int slot = st % QSTAGES;
    const uint4* kv = ring + slot * QU * 2 * QT + t;
    const float* sc2 = sring + slot * QU * 2 * NG + gi;
    bool ok[QU];
    float sc[QU];
    float mx = m;
#pragma unroll
    for (int u = 0; u < QU; ++u) {
      float kf[16], d4[4] = {0.f, 0.f, 0.f, 0.f};
      i8x16_float(kv[u * 2 * QT], kf);
#pragma unroll
      for (int k = 0; k < 16; ++k) d4[k & 3] = fmaf(qf[k], kf[k], d4[k & 3]);
      const int p = p0 + st * SP + u * NG + gi;
      ok[u] = p < p1;
      if constexpr (WIDE) {
        // K's other head-width groups, loaded here (q's from L1)
        if (ok[u]) {
          const int col = p / ps, e = col - j * pps;
          const int pg = e < cache ? pid[e] : page_of(__ldg(trow + col), P);
          const int8_t* krow =
              kp + ((long long)pg * ps + p % ps) * pos_stride + head_off;
#pragma unroll 1
          for (int c = 1; c < kc; ++c) {
            float qc[16];
            load_q16<T, VECL>(q + sh * hd, c * HD + i0, hd, qc);
            load_i8x16<VECL>(krow, c * HD + i0, hd, kf);
#pragma unroll
            for (int k = 0; k < 16; ++k)
              d4[k & 3] = fmaf(qc[k], kf[k], d4[k & 3]);
          }
        }
      }
      const float d = group_sum<G>((d4[0] + d4[1]) + (d4[2] + d4[3]));
      sc[u] = ok[u] ? d * sc2[u * 2 * NG] * inv_div : NEG_INF;
      mx = fmaxf(mx, sc[u]);
    }
    const float alpha = expf(m - mx);
    l *= alpha;
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[k] *= alpha;
#pragma unroll
    for (int u = 0; u < QU; ++u) {
      const float pu = ok[u] ? expf(sc[u] - mx) : 0.f;
      l += pu;
      const float pc = to_f(from_f<T>(pu));  // p cast to the compute dtype
      const float vs = sc2[u * 2 * NG + NG];
      float vf[16];
      i8x16_float(kv[u * 2 * QT + QT], vf);
      if constexpr (std::is_same_v<T, float>) {
        const float pv = pc * vs;                // no rounding in fp32
#pragma unroll
        for (int k = 0; k < 16; ++k) acc[k] = fmaf(pv, vf[k], acc[k]);
      } else {
#pragma unroll
        for (int k = 0; k < 16; k += 2) {        // V rounded to T, as p
          float a = vf[k] * vs, b = vf[k + 1] * vs;
          round_pair<T>(a, b);
          acc[k] = fmaf(pc, a, acc[k]);
          acc[k + 1] = fmaf(pc, b, acc[k + 1]);
        }
      }
    }
    m = mx;
    __syncwarp();                  // the group has read lane 0's scales
    issue(st + QSTAGES);
  }

  // the groups of a warp merged by a shuffle tree over lane offsets
  // G .. 16 (lanes 0 .. G-1 take the lower side of every pair)
#pragma unroll
  for (int o = G; o < 32; o <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, o);
    const float lo = __shfl_xor_sync(0xffffffffu, l, o);
    const float M = fmaxf(m, mo);
    const float wa = expf(m - M), wb = expf(mo - M);
    l = l * wa + lo * wb;
#pragma unroll
    for (int k = 0; k < 16; ++k)
      acc[k] = acc[k] * wa + __shfl_xor_sync(0xffffffffu, acc[k], o) * wb;
    m = M;
  }
  // then the warps, in one shared-memory pass over the drained ring (every
  // commit group with copies was waited for in the loop)
  const int w = t / 32, lane = t % 32;
  __syncthreads();
  if (lane == 0) {
    sm_m[w] = m;
    sm_l[w] = l;
  }
  if (lane < G) {
#pragma unroll
    for (int k = 0; k < 16; ++k) sm_acc[w * HD + i0 + k] = acc[k];
  }
  __syncthreads();
  float M = NEG_INF;
#pragma unroll
  for (int i = 0; i < QNW; ++i) M = fmaxf(M, sm_m[i]);
  float wt[QNW], L = 0.f;
#pragma unroll
  for (int i = 0; i < QNW; ++i) {
    wt[i] = expf(sm_m[i] - M);
    L += sm_l[i] * wt[i];
  }
  T* o = out + sh * hd + c0;
  for (int d = t; d < cols; d += QT) {
    float A = 0.f;
#pragma unroll
    for (int i = 0; i < QNW; ++i) A += sm_acc[i * HD + d] * wt[i];
    if (ns == 1)
      o[d] = from_f<T>(A / fmaxf(L, 1e-30f));
    else
      ws[(sv * splits + j) * ld + d] = A;
  }
  if (ns == 1) return;
  float* ml = ws + (long long)gridDim.y * nh * kc * splits * ld;
  if (t == 0) {
    ml[2 * (sv * splits + j)] = M;
    ml[2 * (sv * splits + j) + 1] = L;
  }
  merge_splits<T, QT, HD>(ws + sv * splits * ld, ml + 2 * sv * splits,
                          tickets + sv, o, cols, ld, ns);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The smallest power of two >= n (n >= 1).
int pow2_at_least(int n) {
  int g = 1;
  while (g < n) g *= 2;
  return g;
}

// Calls f(std::integral_constant<int, G>(), std::bool_constant<VECL>(),
// std::bool_constant<WIDE>()) for a head row of `slices` 16-byte slices: G
// the power of two from 1 to 32 that covers them, or, past 32 slices, G =
// 32 and WIDE (head-width groups of 32 slices).
template <typename F>
cudaError_t with_groups(int slices, bool vecl, F&& f) {
#define PT_G_CASE(G_, W_)                                                   \
  return vecl ? f(std::integral_constant<int, G_>(), std::true_type(),      \
                  std::bool_constant<W_>())                                 \
              : f(std::integral_constant<int, G_>(), std::false_type(),     \
                  std::bool_constant<W_>());
  switch (slices > 32 ? 64 : pow2_at_least(slices)) {
    case 1: PT_G_CASE(1, false)
    case 2: PT_G_CASE(2, false)
    case 4: PT_G_CASE(4, false)
    case 8: PT_G_CASE(8, false)
    case 16: PT_G_CASE(16, false)
    case 32: PT_G_CASE(32, false)
    case 64: PT_G_CASE(32, true)
    default:
      return cudaErrorInvalidValue;
  }
#undef PT_G_CASE
}

// The head-width groups of a head of hd elements, `per` elements a slice:
// one up to 32 slices, else ceil(hd / (32 per)).
int head_groups(int hd, int per) {
  return hd <= 32 * per ? 1 : (hd + 32 * per - 1) / (32 * per);
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* table, const int* lens, void* out, float* ws,
                     int* tickets, int S, int nh, int hd, int P, int ps,
                     int maxP, int pps, int splits, int kc, float scale_div,
                     cudaStream_t st) {
  constexpr int VEC = 16 / (int)sizeof(T);
  if (hd <= 0 || kc != head_groups(hd, VEC) ||
      (long long)nh * kc > 2147483647LL)
    return cudaErrorInvalidValue;
  const bool vecl = hd % VEC == 0 && aligned16(q) && aligned16(k) &&
                    aligned16(v);
  const dim3 grid(nh * kc, S, splits);
  return with_groups((hd + VEC - 1) / VEC, vecl,
                     [&](auto g, auto vl, auto wide) {
    paged_decode<T, decltype(g)::value, decltype(vl)::value,
                 decltype(wide)::value><<<grid, PT, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), table, lens, static_cast<T*>(out), ws,
        tickets, nh, hd, P, ps, maxP, pps, splits, kc, scale_div);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t dispatch_q8(const void* q, const int8_t* k, const float* ks,
                        const int8_t* v, const float* vs, const int* table,
                        const int* lens, void* out, float* ws, int* tickets,
                        int S, int nh, int hd, int P, int ps, int maxP,
                        int pps, int splits, int kc, float scale_div,
                        cudaStream_t st) {
  if (hd <= 0 || kc != head_groups(hd, 16) ||
      (long long)nh * kc > 2147483647LL)
    return cudaErrorInvalidValue;
  const bool vecl = hd % 16 == 0 && aligned16(q) && aligned16(k) &&
                    aligned16(v);
  const dim3 grid(nh * kc, S, splits);
  const int pids = pps < QPID_MAX ? pps : QPID_MAX;
  return with_groups((hd + 15) / 16, vecl, [&](auto g, auto vl, auto wide) {
    constexpr int G = decltype(g)::value;
    const auto kern =
        paged_decode_q8<T, G, decltype(vl)::value, decltype(wide)::value>;
    // more than 48 KB of dynamic shared memory is allowed once a device
    static uint64_t allowed = 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= 64 || !(allowed >> dev & 1)) {
      e = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               q8_ring_bytes(G) + QPID_MAX * 4);
      if (e != cudaSuccess) return e;
      if (dev < 64) allowed |= 1ull << dev;
    }
    kern<<<grid, QT, q8_ring_bytes(G) + pids * 4, st>>>(
        static_cast<const T*>(q), k, ks, v, vs, table, lens,
        static_cast<T*>(out), ws, tickets, nh, hd, P, ps, maxP, pps, splits,
        kc, scale_div);
    return cudaGetLastError();
  });
}

// The shapes and split plan both kernels take: pps pages a split, splits =
// ceil(maxP / pps) <= 32, ws and tickets given where splits > 1.
bool shapes_ok(int S, int nh, int P, int ps, int maxP, int pps, int splits,
               const float* ws, const int* tickets) {
  return S > 0 && nh > 0 && P > 0 && ps > 0 && maxP > 0 && S <= 65535 &&
         pps > 0 && splits > 0 && splits <= PMAX_SPLITS &&
         (long long)(splits - 1) * pps < maxP &&
         (long long)splits * pps >= maxP && (splits == 1 || (ws && tickets));
}

}  // namespace

// pps pages a split, splits = ceil(maxP / pps) <= 32; kc head-width groups
// (1 up to 32 16-byte slices a head, else ceil(hd / 32 slices)); ws: fp32
// [S * nh * kc][splits][ld] partial accumulators (ld = hd, or 32 slices'
// elements where kc > 1), then [S * nh * kc][splits][2] (m, l); tickets:
// int32 [S * nh * kc], kept at 0 (both unused when splits == 1).  At most
// 65,535 slots a call: the wrapper cuts larger S into calls, each with its
// own slice of ws and tickets.
extern "C" int pt_paged_attention_fwd(const void* q, const void* k,
                                      const void* v, const int* table,
                                      const int* lens, void* out, float* ws,
                                      int* tickets, int S, int nh, int hd,
                                      int P, int ps, int maxP, int pps,
                                      int splits, int kc, float scale_div,
                                      int dtype, void* stream) {
  if (!shapes_ok(S, nh, P, ps, maxP, pps, splits, ws, tickets))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0)
    e = dispatch<float>(q, k, v, table, lens, out, ws, tickets, S, nh, hd, P,
                        ps, maxP, pps, splits, kc, scale_div, st);
  else if (dtype == 1)
    e = dispatch<__nv_bfloat16>(q, k, v, table, lens, out, ws, tickets, S,
                                nh, hd, P, ps, maxP, pps, splits, kc,
                                scale_div, st);
  return (int)e;
}

// The int8 pool: k/v int8, k_scale / v_scale fp32 [P, ps, nh]; the plan,
// kc (of 512-column groups), ws and tickets as pt_paged_attention_fwd
// takes them.
extern "C" int pt_paged_attention_quant_fwd(
    const void* q, const void* k, const float* k_scale, const void* v,
    const float* v_scale, const int* table, const int* lens, void* out,
    float* ws, int* tickets, int S, int nh, int hd, int P, int ps, int maxP,
    int pps, int splits, int kc, float scale_div, int dtype, void* stream) {
  if (!shapes_ok(S, nh, P, ps, maxP, pps, splits, ws, tickets))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* kq = static_cast<const int8_t*>(k);
  const int8_t* vq = static_cast<const int8_t*>(v);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0)
    e = dispatch_q8<float>(q, kq, k_scale, vq, v_scale, table, lens, out, ws,
                           tickets, S, nh, hd, P, ps, maxP, pps, splits, kc,
                           scale_div, st);
  else if (dtype == 1)
    e = dispatch_q8<__nv_bfloat16>(q, kq, k_scale, vq, v_scale, table, lens,
                                   out, ws, tickets, S, nh, hd, P, ps, maxP,
                                   pps, splits, kc, scale_div, st);
  return (int)e;
}

extern "C" const char* pt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
