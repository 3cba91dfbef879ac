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
// lens[s]) are never read.  A table entry outside [0, P) is clamped, as
// XLA clamps the gather in the reference.
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
// The int8-pool walk (paged_decode_q8, replacing _paged_decode_kernel_
// quant) follows below; it keeps the one-block-per-(head, slot) design.
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/cuda/
// paged_attn.py); dtype codes: 0 = float32, 1 = bfloat16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
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

// grid (nh, S, splits); split j of slot s takes positions [j span,
// min(n, j span + span)), span = pps * ps.  G threads per position, each
// VEC = 16 / sizeof(T) elements of the head row: hd <= G * VEC, the lanes
// past hd masked.  ws: [S * nh][splits][hd] unnormalised accumulators,
// then [S * nh][splits][2] (m, l); tickets: [S * nh], kept at 0.
template <typename T, int G, bool VECL>
__global__ void __launch_bounds__(PT)
paged_decode(const T* __restrict__ q, const T* __restrict__ kp,
             const T* __restrict__ vp, const int* __restrict__ table,
             const int* __restrict__ lens, T* __restrict__ out,
             float* __restrict__ ws, int* __restrict__ tickets, int nh,
             int hd, int P, int ps, int maxP, int pps, int splits,
             float scale_div) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int HD = VEC * G;
  constexpr int NG = PT / G;       // position groups per block
  constexpr int MAXW = NG > PMAX_SPLITS ? NG : PMAX_SPLITS;
  // the merge of the splits: each thread keeps up to HDT output elements
  constexpr int HDT = (HD + PT - 1) / PT;
  __shared__ float sm_m[MAXW], sm_l[MAXW], sm_w[MAXW], sm_L;
  __shared__ float sm_acc[NG][HD];
  __shared__ int sm_pid[PID_CACHE];
  __shared__ int sm_last;

  const int h = blockIdx.x, s = blockIdx.y, j = blockIdx.z;
  const int gi = threadIdx.x / G, li = threadIdx.x % G;
  const int* trow = table + (long long)s * maxP;
  const long long sh = (long long)s * nh + h;
  const int i0 = li * VEC;
  // lens, the split's table entries and q are independent loads: all in
  // flight at once
  const int ln = __ldg(lens + s);
  for (int e = threadIdx.x; e < min(pps, PID_CACHE); e += PT) {
    const int te = j * pps + e;
    sm_pid[e] = te < maxP ? min(max(__ldg(trow + te), 0), P - 1) : 0;
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
    float kf[U][VEC], vf[U][VEC];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = base + u * NG + gi;
      ok[u] = p < p1;
      if (ok[u]) {
        const int e = p / ps - j * pps;          // page of the split
        const int pid = e < PID_CACHE
                            ? sm_pid[e]
                            : min(max(__ldg(trow + p / ps), 0), P - 1);
        const long long off =
            pid * page_stride + (long long)(p % ps) * pos_stride + head_off;
        load_row<T, VECL>(kp + off, i0, hd, kf[u]);
        load_row<T, VECL>(vp + off, i0, hd, vf[u]);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) kf[u][k] = vf[u][k] = 0.f;
      }
    }
    float sc[U];
    float mx = m;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float d = 0.f;
#pragma unroll
      for (int k = 0; k < VEC; ++k) d += qf[k] * kf[u][k];
      d = group_sum<G>(d);
      sc[u] = ok[u] ? d / scale_div : NEG_INF;
      mx = fmaxf(mx, sc[u]);
    }
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
  float* part = ws + (sh * splits + j) * hd;
  float* ml = ws + (long long)gridDim.y * nh * splits * hd;
  for (int d = threadIdx.x; d < hd; d += PT) {
    float A = 0.f;
    for (int g = 0; g < NG; ++g) A += sm_acc[g][d] * sm_w[g];
    if (ns == 1)
      out[sh * hd + d] = from_f<T>(A / fmaxf(L, 1e-30f));
    else
      part[d] = A;
  }
  if (ns == 1) return;
  if (threadIdx.x == 0) {
    float M = NEG_INF;
    for (int g = 0; g < NG; ++g) M = fmaxf(M, sm_m[g]);
    ml[2 * (sh * splits + j)] = M;
    ml[2 * (sh * splits + j) + 1] = L;
  }

  // the last split of (slot, head) to finish merges them all
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    sm_last = atomicAdd(tickets + sh, 1) == ns - 1;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  // one round trip: the partials' (m, l) and this thread's accumulator
  // elements of every split are loaded together, then weighted
  const float* parts = ws + sh * splits * hd;
  float v[HDT][PMAX_SPLITS];
#pragma unroll
  for (int e = 0; e < HDT; ++e) {
    const int d = threadIdx.x + e * PT;
#pragma unroll
    for (int i = 0; i < PMAX_SPLITS; ++i)
      v[e][i] = i < ns && d < hd ? __ldcg(parts + i * hd + d) : 0.f;
  }
  if (threadIdx.x < ns) {
    sm_m[threadIdx.x] = __ldcg(ml + 2 * (sh * splits + threadIdx.x));
    sm_l[threadIdx.x] = __ldcg(ml + 2 * (sh * splits + threadIdx.x) + 1);
  }
  __syncthreads();
  if (threadIdx.x < 32) merge_weights(sm_m, sm_l, sm_w, ns, &sm_L);
  __syncthreads();
  const float LL = sm_L;
#pragma unroll
  for (int e = 0; e < HDT; ++e) {
    const int d = threadIdx.x + e * PT;
    if (d >= hd) continue;
    float A = 0.f;
#pragma unroll
    for (int i = 0; i < PMAX_SPLITS; ++i)
      if (i < ns) A += v[e][i] * sm_w[i];       // in split order
    out[sh * hd + d] = from_f<T>(A / fmaxf(LL, 1e-30f));
  }
  if (threadIdx.x == 0) tickets[sh] = 0;
}

// ---------------------------------------------------------------------------
// int8 pool: replaces paddle_tpu/ops/pallas/paged_attn.py::
// _paged_decode_kernel_quant (launched by _paged_attention_quant_tpu).
// K/V pages are int8 [P, ps, nh, hd] with fp32 scales [P, ps, nh], one per
// position per head.  Same walk, groups and merge as paged_decode; each of
// the G threads of a position reads 16 int8 elements of K and of V (one
// 16-byte load where hd is a multiple of 16 and the pool 16-byte aligned,
// else one byte at a time) plus the position's two scales, so hd <= 16 * G,
// the lanes past hd masked.  The casts follow the Pallas kernel: q and K
// dequantize to fp32 (int8 * scale) and the scores are fp32; V dequantizes
// to fp32 and is then cast to the compute dtype T, as is p, before p.V
// accumulates in fp32.  Bound: bytes, about 1 byte per K/V element plus 8
// bytes of scales per position and head, against 2-4 bytes per element in
// the fp pool.
// ---------------------------------------------------------------------------
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

// 16 int8 at p[i0..] (zero past hd) as one uint4.
template <bool VECL>
__device__ __forceinline__ uint4 load_i8(const int8_t* __restrict__ p,
                                         int i0, int hd) {
  uint4 r = make_uint4(0, 0, 0, 0);
  if constexpr (VECL) {
    if (i0 < hd) r = __ldg(reinterpret_cast<const uint4*>(p + i0));
  } else {
    int8_t* rb = reinterpret_cast<int8_t*>(&r);
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (i0 + k < hd) rb[k] = __ldg(p + i0 + k);
  }
  return r;
}

// grid (nh, S); G threads per position, hd <= 16 * G.
template <typename T, int G, bool VECL>
__global__ void __launch_bounds__(THREADS)
paged_decode_q8(const T* __restrict__ q, const int8_t* __restrict__ kp,
                const float* __restrict__ ksc, const int8_t* __restrict__ vp,
                const float* __restrict__ vsc, const int* __restrict__ table,
                const int* __restrict__ lens, T* __restrict__ out, int nh,
                int hd, int P, int ps, int maxP, float scale_div) {
  constexpr int HD = 16 * G;
  constexpr int NG = THREADS / G;  // position groups per block
  __shared__ float sm_m[NG], sm_l[NG];
  __shared__ float sm_acc[NG][HD];

  const int h = blockIdx.x, s = blockIdx.y;
  const int gi = threadIdx.x / G, li = threadIdx.x % G;
  const int view = maxP * ps;
  const int n = max(0, min(__ldg(lens + s) + 1, view));
  const int* trow = table + (long long)s * maxP;
  const long long pos_stride = (long long)nh * hd;
  const long long head_off = (long long)h * hd;
  const int i0 = li * 16;

  float qf[16];
  load_q16<T, VECL>(q + ((long long)s * nh + h) * hd, i0, hd, qf);
  float m = NEG_INF, l = 0.f;
  float acc[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = 0.f;

  // the trip count is uniform over the block, so every lane reaches the
  // shuffles in group_sum
  for (int base = 0; base < n; base += NG * U) {
    uint4 kr[U], vr[U];
    float ks[U], vs[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = base + u * NG + gi;
      ok[u] = p < n;
      kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
      ks[u] = vs[u] = 0.f;
      if (ok[u]) {
        int pid = __ldg(trow + p / ps);
        pid = min(max(pid, 0), P - 1);
        const long long row = (long long)pid * ps + p % ps;
        const long long off = row * pos_stride + head_off;
        kr[u] = load_i8<VECL>(kp + off, i0, hd);
        vr[u] = load_i8<VECL>(vp + off, i0, hd);
        ks[u] = __ldg(ksc + row * nh + h);
        vs[u] = __ldg(vsc + row * nh + h);
      }
    }
    float sc[U];
    float mx = m;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int8_t* kb = reinterpret_cast<const int8_t*>(&kr[u]);
      float d = 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k) d += qf[k] * ((float)kb[k] * ks[u]);
      d = group_sum<G>(d);
      sc[u] = ok[u] ? d / scale_div : NEG_INF;
      mx = fmaxf(mx, sc[u]);
    }
    const float alpha = expf(m - mx);
    l *= alpha;
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[k] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float pu = ok[u] ? expf(sc[u] - mx) : 0.f;
      l += pu;
      const float pc = to_f(from_f<T>(pu));  // p cast to the compute dtype
      const int8_t* vb = reinterpret_cast<const int8_t*>(&vr[u]);
#pragma unroll
      for (int k = 0; k < 16; ++k)
        acc[k] += pc * to_f(from_f<T>((float)vb[k] * vs[u]));
    }
    m = mx;
  }

  if (li == 0) {
    sm_m[gi] = m;
    sm_l[gi] = l;
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) sm_acc[gi][i0 + k] = acc[k];
  __syncthreads();
  for (int d = threadIdx.x; d < hd; d += THREADS) {
    float M = NEG_INF;
    for (int g = 0; g < NG; ++g) M = fmaxf(M, sm_m[g]);
    float L = 0.f, A = 0.f;
    for (int g = 0; g < NG; ++g) {
      const float w = expf(sm_m[g] - M);
      L += sm_l[g] * w;
      A += sm_acc[g][d] * w;
    }
    out[((long long)s * nh + h) * hd + d] = from_f<T>(A / fmaxf(L, 1e-30f));
  }
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

// Calls f(std::integral_constant<int, G>(), std::bool_constant<VECL>())
// for G a power of two from 1 to 32; anything else is an invalid value.
template <typename F>
cudaError_t with_groups(int G, bool vecl, F&& f) {
#define PT_G_CASE(G_)                                                     \
  case G_:                                                                \
    return vecl ? f(std::integral_constant<int, G_>(), std::true_type())  \
                : f(std::integral_constant<int, G_>(), std::false_type());
  switch (G) {
    PT_G_CASE(1)
    PT_G_CASE(2)
    PT_G_CASE(4)
    PT_G_CASE(8)
    PT_G_CASE(16)
    PT_G_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef PT_G_CASE
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* table, const int* lens, void* out, float* ws,
                     int* tickets, int S, int nh, int hd, int P, int ps,
                     int maxP, int pps, int splits, float scale_div,
                     cudaStream_t st) {
  constexpr int VEC = 16 / (int)sizeof(T);
  if (hd <= 0) return cudaErrorInvalidValue;
  const bool vecl = hd % VEC == 0 && aligned16(q) && aligned16(k) &&
                    aligned16(v);
  const dim3 grid(nh, S, splits);
  return with_groups(pow2_at_least((hd + VEC - 1) / VEC), vecl,
                     [&](auto g, auto vl) {
    paged_decode<T, decltype(g)::value, decltype(vl)::value>
        <<<grid, PT, 0, st>>>(
            static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), table, lens, static_cast<T*>(out), ws,
            tickets, nh, hd, P, ps, maxP, pps, splits, scale_div);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t dispatch_q8(const void* q, const int8_t* k, const float* ks,
                        const int8_t* v, const float* vs, const int* table,
                        const int* lens, void* out, int S, int nh, int hd,
                        int P, int ps, int maxP, float scale_div,
                        cudaStream_t st) {
  if (hd <= 0) return cudaErrorInvalidValue;
  const bool vecl = hd % 16 == 0 && aligned16(q) && aligned16(k) &&
                    aligned16(v);
  const dim3 grid(nh, S);
  return with_groups(pow2_at_least((hd + 15) / 16), vecl,
                     [&](auto g, auto vl) {
    paged_decode_q8<T, decltype(g)::value, decltype(vl)::value>
        <<<grid, THREADS, 0, st>>>(
            static_cast<const T*>(q), k, ks, v, vs, table, lens,
            static_cast<T*>(out), nh, hd, P, ps, maxP, scale_div);
    return cudaGetLastError();
  });
}

}  // namespace

// pps pages a split, splits = ceil(maxP / pps) <= 32; ws and tickets as
// paged_decode takes them (unused when splits == 1).
extern "C" int pt_paged_attention_fwd(const void* q, const void* k,
                                      const void* v, const int* table,
                                      const int* lens, void* out, float* ws,
                                      int* tickets, int S, int nh, int hd,
                                      int P, int ps, int maxP, int pps,
                                      int splits, float scale_div, int dtype,
                                      void* stream) {
  if (S <= 0 || nh <= 0 || P <= 0 || ps <= 0 || maxP <= 0 || S > 65535 ||
      pps <= 0 || splits <= 0 || splits > PMAX_SPLITS ||
      (long long)(splits - 1) * pps >= maxP ||
      (long long)splits * pps < maxP || (splits > 1 && (!ws || !tickets)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0)
    e = dispatch<float>(q, k, v, table, lens, out, ws, tickets, S, nh, hd, P,
                        ps, maxP, pps, splits, scale_div, st);
  else if (dtype == 1)
    e = dispatch<__nv_bfloat16>(q, k, v, table, lens, out, ws, tickets, S,
                                nh, hd, P, ps, maxP, pps, splits, scale_div,
                                st);
  return (int)e;
}

extern "C" int pt_paged_attention_quant_fwd(
    const void* q, const void* k, const float* k_scale, const void* v,
    const float* v_scale, const int* table, const int* lens, void* out, int S,
    int nh, int hd, int P, int ps, int maxP, float scale_div, int dtype,
    void* stream) {
  if (S <= 0 || nh <= 0 || P <= 0 || ps <= 0 || maxP <= 0 || S > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* kq = static_cast<const int8_t*>(k);
  const int8_t* vq = static_cast<const int8_t*>(v);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == 0)
    e = dispatch_q8<float>(q, kq, k_scale, vq, v_scale, table, lens, out, S,
                           nh, hd, P, ps, maxP, scale_div, st);
  else if (dtype == 1)
    e = dispatch_q8<__nv_bfloat16>(q, kq, k_scale, vq, v_scale, table, lens,
                                   out, S, nh, hd, P, ps, maxP, scale_div, st);
  return (int)e;
}

extern "C" const char* pt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
