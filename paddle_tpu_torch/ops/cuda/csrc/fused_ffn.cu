// Fused transformer FFN for Hopper (sm_90a):
//   out = gelu_tanh(x @ w1 + b1) @ w2 + b2
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_ffn.py::_ffn_kernel
// (launched by _fused_ffn_tpu).  Same arithmetic: the first product
// accumulates in fp32 from the stored values, b1 is added in fp32, gelu
// (tanh form) runs in fp32, and h is rounded once to x's dtype before the
// second product; that product accumulates in fp32, gets b2 in fp32 and is
// rounded once to x's dtype.  The [M, F] intermediate never reaches device
// memory.
//
// Layout: x [M, H], w1 [H, F], b1 [F], w2 [F, H], b2 [H], out [M, H], all
// contiguous, 16-byte aligned and in x's dtype; the weights are read as
// stored.  M is free (ragged row tiles are masked); H and F are multiples of
// 8 (the wrapper zero-pads other widths), any size.
//
// Bound.  4*M*H*F flops against (2*M*H + 2*H*F + F + H) elements: at the
// GPT-3 1.3B training shape (M = 12288, H = 2048, F = 8192, bf16) 0.82 TFLOP
// against 168 MB, bound by operations on the tensor cores (0.834 ms at 989
// TFLOP/s).  The [M, F] intermediate stays on chip, so every 128-row tile
// reads both weights whole from the 50 MB L2: at that shape 96 tiles x 67
// MB = 6.4 GB of weights, plus x once for each F tile a block owns (3.2
// GB), about 9.6 GB; at full tensor rate that is more than the L2 serves,
// so the kernel lives between the two bounds.  A decode GEMM (M = 8) is
// bound by the weight bytes from HBM.
//
// Design for that bound (bf16, ffn_wg):
//  * A cluster of CS blocks (1, 2, 4 or 8) owns 128 rows; block c owns NC
//    output columns (64, 128 or 256) and keeps the [128, NC] fp32
//    accumulator in the registers of its two consumer warpgroups (64 rows
//    each; setmaxnreg gives them 240 registers and the producers 24, which
//    with 32-row w2 steps at NC = 256 leaves wgmma's pipeline unserialised).
//    Wider H takes more column groups (gridDim.y), each recomputing h:
//    H = 4096 runs two.  128 rows a cluster read a quarter of the weight
//    bytes that 32-row clusters read.
//  * F is walked in rounds of CS tiles of BF = 128.  In a round block c
//    computes its tile's h_c = gelu(x @ w1[:, tile] + b1) over the full H
//    (wgmma m64n128k16, both operands from shared memory), rounds it to
//    bf16 and stores it in shared memory in the wgmma A-fragment order of
//    the thread that wrote it.  After an mbarrier that every block of the
//    cluster arrives on, each block adds h_c' @ w2[tile c', its columns]
//    for every c' of the cluster, each thread loading its own fragment of
//    h_c' from block c' over distributed shared memory straight into
//    registers (wgmma m64nNCk16 with A in registers).  No product is
//    computed twice and nothing is split over k.  Two h buffers alternate
//    by round, so a block never waits for its peers to finish reading.
//  * Two producer threads issue TMA loads into two rings with mbarriers:
//    one the x k-slices [128, 64] with w1 tiles [64, 128] (three stages),
//    the other the w2 tiles [32 or 64, NC] (64 KB of stages).  One wgmma
//    group stays in flight in each product, and the next h_c' loads over
//    DSMEM while the current one multiplies.  Both weights are read as
//    stored, through wgmma's transposed-B (MN-major) descriptors, 128-byte
//    swizzled.  TMA fills rows past M, columns past H and F tiles past F
//    with zeros, which the products and gelu(0) = 0 turn into nothing.
//    Each block loads its own copy of the x slices: multicast to the
//    cluster would read a quarter of the x bytes from L2, but measured
//    slower on the H100, since every stage of a multicast ring waits for
//    every block of the cluster (tools/ffn_variants.py times it).
//  * Epilogue: + b2 in fp32, one bf16 rounding, a store masked to M and H.
// float32 stays on the CUDA cores (TF32 would break its 1e-5 tolerance):
// a block of 16 rows keeps a [16, 2048] column group of the accumulator, a
// thread per (row, f) for the first product and a thread per column group
// for the second; wider H takes more column groups (gridDim.y), each
// recomputing h, and reads x from L2 instead of shared memory.
//
// C interface (loaded with ctypes by paddle_tpu_torch/ops/cuda/fused_ffn.py);
// dtype codes: 0 = float32, 1 = bfloat16.  Returns the first CUDA error of
// the launch (0 on success).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float gelu_tanh(float u) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * u * (1.f + tanhf(c * (u + 0.044715f * u * u * u)));
}

// ---------------------------------------------------------------------------
// Hopper primitives: shared-memory addresses, mbarriers, TMA, wgmma.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// The address of this block's shared-memory word `a` in block `cta` of the
// cluster.
__device__ __forceinline__ uint32_t mapa(uint32_t a, uint32_t cta) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(a), "r"(cta));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], "
      "%1;\n"
      "@!done bra WAIT_%=;\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
      :: "r"(bar), "r"(bytes) : "memory");
}
// Arrive on the barrier at this block's offset `bar` in block `cta`.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t cta) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
      :: "r"(mapa(bar, cta)) : "memory");
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* m,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}
// Synchronise the 128 threads of consumer warpgroup `wg` (barriers 1, 2).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(wg + 1) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// A wgmma shared-memory descriptor for a 128-byte-swizzled operand whose
// 8-row x 128-byte swizzle atoms lie `lbo` bytes apart along M/N and `sbo`
// bytes apart along the other axis (PTX ISA, matrix descriptor format).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += A (smem, K-major) . B (smem, MN-major), m64n64k16, fp32 accumulate
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d += A (smem, K-major) . B (smem, MN-major), m64n128k16, fp32 accumulate
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d += A (registers) . B (smem, MN-major), m64n64k16, fp32 accumulate
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// d += A (registers) . B (smem, MN-major), m64n128k16, fp32 accumulate
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// d += A (registers) . B (smem, MN-major), m64n256k16, fp32 accumulate
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}


// ---------------------------------------------------------------------------
// bf16 on the tensor cores: ffn_wg<NC, BF>.  Grid (CS * row tiles, column
// groups), cluster (CS, 1, 1); 384 threads: consumer warpgroups 0 and 1
// (rows 0-63, 64-127 of the tile), producer warpgroup 2 (thread 256 issues
// the x / w1 loads, thread 288 the w2 loads).
// ---------------------------------------------------------------------------
constexpr int BM = 128;         // rows of a cluster's tile
constexpr int FFN_BF = 128;     // F tile a block owns in a round
constexpr int BK = 64;          // k slice of the first product (128 bytes)
constexpr int WG_THREADS = 384;
constexpr int X_BYTES = BM * BK * 2;   // 16 KB

// Shared-memory layout of ffn_wg<NC, BF>: BF is the F tile a block owns in
// a round, NC its output columns.
template <int NC, int BF, int KS2>
struct WgSmem {
  static constexpr int ST1 = BF == 64 ? 4 : 3;   // x / w1 stages
  static constexpr int ST2 = (BF == 64 ? 3 : 2) * 64 / KS2;   // w2 stages
  static constexpr int W1_BYTES = BK * BF * 2;
  static constexpr int W2_BYTES = KS2 * NC * 2;
  static constexpr int HX_BYTES = 256 * BF;  // BF / 4 u32 a thread
  static constexpr int X = 0;
  static constexpr int W1 = X + ST1 * X_BYTES;
  static constexpr int W2 = W1 + ST1 * W1_BYTES;
  static constexpr int HX = W2 + ST2 * W2_BYTES;
  static constexpr int BAR = HX + 2 * HX_BYTES;   // two h buffers
  // full1, empty1 [ST1]; full2, empty2 [ST2]; hfull [2]
  static constexpr int BYTES = BAR + 8 * (2 * ST1 + 2 * ST2 + 2);
  static constexpr int ALLOC = BYTES + 1024;   // room to align to 1024
};
// f rows of a second-product step: 32 for 256 columns a block (the
// accumulator then leaves registers for wgmma's pipeline), else 64
template <int NC> constexpr int ks2_for() { return NC == 256 ? 32 : 64; }
static_assert(WgSmem<256, 128, 32>::ALLOC <= 232448 &&
                  WgSmem<128, 128, 64>::ALLOC <= 232448,
              "ffn_wg fits in shared memory");

// Issue the second product's step for 64 rows of one h tile: acc += h
// (16 u32 of registers) @ the w2 tile in ring-2 stage at `w2`, once its
// barrier `full` flips.
template <int NC, int KS2>
__device__ __forceinline__ void second_issue(float (&acc)[NC / 2],
                                             const uint32_t (&h)[KS2 / 4],
                                             uint32_t w2, uint32_t full,
                                             uint32_t parity) {
  mbar_wait(full, parity);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KS2 / 16; ++ks) {
    // B: rows f (k) 16ks.. of the tile, 128-byte rows; 64-column boxes
    // lie KS2 * 128 bytes apart along N
    const uint64_t db = sw128_desc(w2 + ks * 2048, KS2 * 128, 1024);
    if constexpr (NC == 256) wgmma_rs_n256(acc, h + 4 * ks, db);
    else if constexpr (NC == 128) wgmma_rs_n128(acc, h + 4 * ks, db);
    else wgmma_rs_n64(acc, h + 4 * ks, db);
  }
  wgmma_commit();
}

// Release a ring stage whose products are done: one arrival a warpgroup
// on this block's barrier `bar`.
__device__ __forceinline__ void release(uint32_t bar, int wg) {
  wg_sync(wg);
  if ((threadIdx.x & 127) == 0) mbar_arrive_cluster(bar, cluster_rank());
}

// Thread `tid`'s h fragment of second-product step `sub` (16 u32, the
// k16 steps 4 sub .. 4 sub + 3) in block `cta`'s buffer at `hx`; the
// buffer holds [BF / 16 k16 steps][256 threads] x 16 bytes.
template <int KS2>
__device__ __forceinline__ void load_h(uint32_t (&h)[KS2 / 4], uint32_t hx,
                                       uint32_t cta, int tid, int sub) {
#pragma unroll
  for (int q = 0; q < KS2 / 16; ++q) {
    const uint32_t a =
        mapa(hx + ((KS2 / 16 * sub + q) * 256 + tid) * 16, cta);
    asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(h[4 * q]), "=r"(h[4 * q + 1]), "=r"(h[4 * q + 2]),
                   "=r"(h[4 * q + 3])
                 : "r"(a) : "memory");
  }
}

template <int NC, int BF, int KS2>
__global__ void __launch_bounds__(WG_THREADS, 1)
ffn_wg(const __grid_constant__ CUtensorMap tm_x,
       const __grid_constant__ CUtensorMap tm_w1,
       const __grid_constant__ CUtensorMap tm_w2,
       const bf16* __restrict__ b1, const bf16* __restrict__ b2,
       bf16* __restrict__ out, int M, int H, int F) {
  using L = WgSmem<NC, BF, KS2>;
  constexpr int ST1 = L::ST1, ST2 = L::ST2, SUB = BF / KS2;
  extern __shared__ __align__(1024) unsigned char smraw[];
  const uint32_t base = (smem_u32(smraw) + 1023) & ~1023u;
  const uint32_t sx = base + L::X, sw1 = base + L::W1, sw2 = base + L::W2;
  const uint32_t shx = base + L::HX;
  const uint32_t full1 = base + L::BAR, empty1 = full1 + 8 * ST1;
  const uint32_t full2 = empty1 + 8 * ST1, empty2 = full2 + 8 * ST2;
  const uint32_t hfull = empty2 + 8 * ST2;

  uint32_t ncta;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(ncta));
  const int cs = (int)ncta;
  const int rank = (int)cluster_rank();
  const int m0 = (blockIdx.x / cs) * BM;
  const int col0 = (blockIdx.y * cs + rank) * NC;
  const int KT = (H + BK - 1) / BK;
  const int rounds = (F + cs * BF - 1) / (cs * BF);
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int i = 0; i < ST1; ++i) {
      mbar_init(full1 + 8 * i, 1);
      mbar_init(empty1 + 8 * i, 2);   // both consumer warpgroups
    }
    for (int i = 0; i < ST2; ++i) {
      mbar_init(full2 + 8 * i, 1);
      mbar_init(empty2 + 8 * i, 2);
    }
    for (int i = 0; i < 2; ++i) mbar_init(hfull + 8 * i, 2 * cs);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every block's barriers exist before any block signals them
  cluster_sync();

  if (wg == 2) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      // ring 1: x slices and w1 tiles (BF / 64 boxes)
      int s1 = 0, p1 = 0;
      for (int r = 0; r < rounds; ++r) {
        const int f0 = (r * cs + rank) * BF;
        for (int kb = 0; kb < KT; ++kb) {
          mbar_wait(empty1 + 8 * s1, p1 ^ 1);
          mbar_expect_tx(full1 + 8 * s1, X_BYTES + L::W1_BYTES);
          tma_load(sx + s1 * X_BYTES, &tm_x, full1 + 8 * s1, kb * BK, m0);
#pragma unroll
          for (int j = 0; j < BF / 64; ++j)
            tma_load(sw1 + s1 * L::W1_BYTES + j * BK * 128, &tm_w1,
                     full1 + 8 * s1, f0 + 64 * j, kb * BK);
          if (++s1 == ST1) { s1 = 0; p1 ^= 1; }
        }
      }
    } else if (threadIdx.x == 288) {
      // ring 2: w2 tiles, in the order the consumers take the h tiles
      int s2 = 0, p2 = 0;
      for (int r = 0; r < rounds; ++r) {
        for (int n = 0; n < cs * SUB; ++n) {
          const int fc = (r * cs + (rank + n / SUB) % cs) * BF +
                         (n % SUB) * KS2;
          mbar_wait(empty2 + 8 * s2, p2 ^ 1);
          mbar_expect_tx(full2 + 8 * s2, L::W2_BYTES);
#pragma unroll
          for (int j = 0; j < NC / 64; ++j)
            tma_load(sw2 + s2 * L::W2_BYTES + j * KS2 * 128, &tm_w2,
                     full2 + 8 * s2, col0 + 64 * j, fc);
          if (++s2 == ST2) { s2 = 0; p2 ^= 1; }
        }
      }
    }
    cluster_sync();
  } else {
    // ---------------- consumers ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x;             // 0..255
    const int w = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    float acc[NC / 2];
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
    int s1 = 0, p1 = 0, s2 = 0, p2 = 0;

    for (int r = 0; r < rounds; ++r) {
      const int f0 = (r * cs + rank) * BF;
      const int buf = r & 1;                  // h buffers alternate
      const uint32_t hpar = (r >> 1) & 1;
      // 1. h_c = x_tile @ w1[:, f0:f0+BF] (this warpgroup's 64 rows)
      float hacc[BF / 2];
#pragma unroll
      for (int i = 0; i < BF / 2; ++i) hacc[i] = 0.f;
      int prev = -1;
      for (int kb = 0; kb < KT; ++kb) {
        mbar_wait(full1 + 8 * s1, p1);
        const uint32_t xa = sx + s1 * X_BYTES + wg * 64 * 128;
        const uint32_t wa = sw1 + s1 * L::W1_BYTES;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          // A: 128-byte rows of x, K-major; B: 128-byte rows of w1 (k),
          // 64-column boxes BK * 128 bytes apart along N
          const uint64_t da = sw128_desc(xa + ks * 32, 16, 1024);
          const uint64_t db = sw128_desc(wa + ks * 2048, BK * 128, 1024);
          if constexpr (BF == 128) wgmma_ss_n128(hacc, da, db);
          else wgmma_ss_n64(hacc, da, db);
        }
        wgmma_commit();
        wgmma_wait<1>();          // the previous stage's products are done
        if (prev >= 0) release(empty1 + 8 * prev, wg);
        prev = s1;
        if (++s1 == ST1) { s1 = 0; p1 ^= 1; }
      }
      wgmma_wait<0>();
      release(empty1 + 8 * prev, wg);

      // + b1, gelu, one rounding to bf16, in the A-fragment order of the
      // second product: u32 i holds h columns 8(i/2) + 2t, +1 of row
      // g + 8(i%2); u32 4q..4q+3 are k16 step q
      const uint32_t hx = shx + buf * L::HX_BYTES;
#pragma unroll
      for (int q = 0; q < BF / 16; ++q) {
        uint32_t h[4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * q + jj;
          const int f = f0 + 8 * j + 2 * t;   // F is a multiple of 8
          float bx = 0.f, by = 0.f;
          if (f < F) {
            const __nv_bfloat162 bb =
                *reinterpret_cast<const __nv_bfloat162*>(b1 + f);
            bx = __low2float(bb);
            by = __high2float(bb);
          }
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int e = 4 * j + 2 * hi;
            h[2 * jj + hi] = pack_bf16(gelu_tanh(hacc[e] + bx),
                                       gelu_tanh(hacc[e + 1] + by));
          }
        }
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                     :: "r"(hx + (q * 256 + tid) * 16), "r"(h[0]),
                        "r"(h[1]), "r"(h[2]), "r"(h[3])
                     : "memory");
      }
      asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
      wg_sync(wg);
      // this block's h is written: tell every block of the cluster
      if ((tid & 127) < cs) mbar_arrive_cluster(hfull + 8 * buf, tid & 127);
      mbar_wait(hfull + 8 * buf, hpar);

      // 2. acc += h_c' @ w2[tile c', this block's columns], every c', in
      // steps of 64 f rows; one step in flight: the next step's h loads
      // over DSMEM while this one multiplies
      const int steps = cs * SUB;
      uint32_t ha[KS2 / 4], hb[KS2 / 4];
      load_h<KS2>(ha, hx, (uint32_t)rank, tid, 0);
      int prev2 = -1;
      for (int n = 0; n < steps; n += 2) {
        second_issue<NC, KS2>(acc, ha, sw2 + s2 * L::W2_BYTES,
                              full2 + 8 * s2, p2);
        wgmma_wait<1>();                  // step n - 1 is done
        if (prev2 >= 0) release(empty2 + 8 * prev2, wg);
        prev2 = s2;
        if (++s2 == ST2) { s2 = 0; p2 ^= 1; }
        if (n + 1 < steps) {
          load_h<KS2>(hb, hx, (uint32_t)((rank + (n + 1) / SUB) % cs), tid,
                 (n + 1) % SUB);
          second_issue<NC, KS2>(acc, hb, sw2 + s2 * L::W2_BYTES,
                                full2 + 8 * s2, p2);
          wgmma_wait<1>();                // step n is done
          release(empty2 + 8 * prev2, wg);
          prev2 = s2;
          if (++s2 == ST2) { s2 = 0; p2 ^= 1; }
          if (n + 2 < steps)
            load_h<KS2>(ha, hx, (uint32_t)((rank + (n + 2) / SUB) % cs), tid,
                   (n + 2) % SUB);
        }
      }
      wgmma_wait<0>();
      release(empty2 + 8 * prev2, wg);
    }

    // + b2 in fp32, one rounding to bf16, masked to M and H
    const int row = m0 + wg * 64 + w * 16 + g;
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
      const int col = col0 + 8 * j + 2 * t;   // H is a multiple of 8
      if (col >= H) continue;
      const __nv_bfloat162 bb =
          *reinterpret_cast<const __nv_bfloat162*>(b2 + col);
      const float bx = __low2float(bb), by = __high2float(bb);
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int rr = row + 8 * hi;
        if (rr < M)
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)rr * H + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * hi] + bx,
                                    acc[4 * j + 2 * hi + 1] + by);
      }
    }
    // peers may still read this block's h and signal its barriers
    cluster_sync();
  }
}

// ---------------------------------------------------------------------------
// float32 on the CUDA cores.  Grid (row tiles of BM32, column groups);
// CPT: accumulator columns a thread owns (col0 + tid, + NT, ...), so a
// block covers NT * CPT columns.  XS: x's rows sit in shared memory (H up
// to 2048); otherwise they are read from L2.
// ---------------------------------------------------------------------------
constexpr int BM32 = 16;        // rows of a block
constexpr int NT = 512;         // threads of a block
constexpr int BFF = 32;         // F tile
constexpr int XS_MAX_H = 2048;  // widest x row kept in shared memory

template <int CPT, bool XS>
__global__ void __launch_bounds__(NT, 1)
ffn_f32(const float* __restrict__ x, const float* __restrict__ w1,
        const float* __restrict__ b1, const float* __restrict__ w2,
        const float* __restrict__ b2, float* __restrict__ out, int M, int H,
        int F) {
  extern __shared__ __align__(1024) unsigned char smraw[];
  float* Hs = reinterpret_cast<float*>(smraw);  // [BM32][BFF]
  float* Xs = Hs + BM32 * BFF;                  // XS: [BM32][H]
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM32;
  // XS: H fits one column group, so the block starts at column 0
  const int col0 = XS ? 0 : blockIdx.y * NT * CPT;
  if constexpr (XS) {
    for (int i = tid; i < BM32 * H; i += NT) {
      const int r = i / H, c = i % H;
      Xs[i] = m0 + r < M ? x[(long long)(m0 + r) * H + c] : 0.f;
    }
  }
  float acc[BM32][CPT];
#pragma unroll
  for (int r = 0; r < BM32; ++r)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[r][j] = 0.f;
  // first product: warp r / lane f of the F tile (BM32 * BFF == NT)
  const int hr = tid / BFF, hf = tid % BFF;
  const bool row_in = m0 + hr < M;
  __syncthreads();

  for (int f0 = 0; f0 < F; f0 += BFF) {
    const int f = f0 + hf;
    float u = 0.f;
    if (f < F) {
      const float* wc = w1 + f;
      if constexpr (XS) {
        const float* xr = Xs + hr * H;
#pragma unroll 8
        for (int k = 0; k < H; ++k)
          u = fmaf(xr[k], __ldg(wc + (long long)k * F), u);
      } else if (row_in) {
        const float* xr = x + (long long)(m0 + hr) * H;
#pragma unroll 8
        for (int k = 0; k < H; ++k)
          u = fmaf(__ldg(xr + k), __ldg(wc + (long long)k * F), u);
      }
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
        const int c = col0 + tid + NT * j;
        wv[j] = c < H ? __ldg(wr + c) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < BM32; ++r) {
        const float hv = Hs[r * BFF + ff];
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[r][j] = fmaf(hv, wv[j], acc[r][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int c = col0 + tid + NT * j;
    if (c >= H) continue;
    const float bb = b2[c];
#pragma unroll
    for (int r = 0; r < BM32; ++r)
      if (m0 + r < M) out[(long long)(m0 + r) * H + c] = acc[r][j] + bb;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D bf16 [rows, cols] row-major tensor map with boxes of [box_rows, 64]
// (128 bytes a row), 128-byte swizzled; out-of-bounds elements read zero.
bool bf16_map(CUtensorMap* m, const void* p, int rows, int cols,
              int box_rows) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NC, int BF>
cudaError_t launch_wg(const void* x, const void* w1, const void* b1,
                      const void* w2, const void* b2, void* out, int M, int H,
                      int F, cudaStream_t st) {
  // cluster size: blocks of NC columns to cover H, a power of two up to 8;
  // wider H takes more column groups
  int cs = 1;
  while (cs < 8 && cs * NC < H) cs *= 2;
  const int groups = (H + cs * NC - 1) / (cs * NC);
  CUtensorMap tx, t1, t2;
  if (!bf16_map(&tx, x, M, H, BM) ||
      !bf16_map(&t1, w1, H, F, BK) ||
      !bf16_map(&t2, w2, F, H, ks2_for<NC>()))
    return cudaErrorInvalidValue;
  constexpr int KS2 = ks2_for<NC>();
  constexpr int smem = WgSmem<NC, BF, KS2>::ALLOC;
  cudaError_t e = cudaFuncSetAttribute(
      ffn_wg<NC, BF, KS2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const long long tiles = (M + BM - 1) / BM;
  if (tiles * cs > 2147483647LL || groups > 65535) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * cs), (unsigned)groups, 1);
  cfg.blockDim = dim3(WG_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, ffn_wg<NC, BF, KS2>, tx, t1, t2,
                         static_cast<const bf16*>(b1),
                         static_cast<const bf16*>(b2), static_cast<bf16*>(out),
                         M, H, F);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int CPT, bool XS>
cudaError_t launch_f32(const void* x, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* out, int M, int H,
                       int F, cudaStream_t st) {
  const int smem = (BM32 * BFF + (XS ? BM32 * H : 0)) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      ffn_f32<CPT, XS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int groups = (H + NT * CPT - 1) / (NT * CPT);
  ffn_f32<CPT, XS><<<dim3((M + BM32 - 1) / BM32, groups), NT, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), M, H, F);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pt_fused_ffn(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* out, int M,
                            int H, int F, int dtype, void* stream) {
  if (M <= 0 || F <= 0 || H <= 0 || H % 8 || F % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    // columns a block owns: the fewest that cover H with 8 blocks
    if (H <= 8 * 64)
      return (int)launch_wg<64, FFN_BF>(x, w1, b1, w2, b2, out, M, H, F, st);
    if (H <= 8 * 128)
      return (int)launch_wg<128, FFN_BF>(x, w1, b1, w2, b2, out, M, H, F, st);
    return (int)launch_wg<256, FFN_BF>(x, w1, b1, w2, b2, out, M, H, F, st);
  }
  if (dtype == 0) {
    if (H > XS_MAX_H)
      return (int)launch_f32<4, false>(x, w1, b1, w2, b2, out, M, H, F, st);
    const int cpt = (H + NT - 1) / NT;
    if (cpt <= 1) return (int)launch_f32<1, true>(x, w1, b1, w2, b2, out, M, H, F, st);
    if (cpt <= 2) return (int)launch_f32<2, true>(x, w1, b1, w2, b2, out, M, H, F, st);
    return (int)launch_f32<4, true>(x, w1, b1, w2, b2, out, M, H, F, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pt_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
