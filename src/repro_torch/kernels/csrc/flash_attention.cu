// Causal / non-causal flash attention for Hopper (sm_90a): kernel K3 of the
// port.
//
//   o[b, i, h, :] = sum_j softmax_j(q[b, i, h, :] . k[b, j, h / G, :] / sqrt(hd))
//                   * v[b, j, h / G, :]          (j <= i when causal; G = H / Kv)
//
// Replaces the Pallas kernel `flash_attention` of
// src/repro/kernels/flash_attention/kernel.py (`_fa_kernel`).  There the grid
// (B, H, q blocks, k blocks) ran in order on one core, carrying the running
// max m, denominator l and accumulator acc in VMEM scratch across the k
// blocks of one q block; future k blocks were skipped under the causal mask,
// padded keys were masked with k_pos < seq_k, and the output was divided by
// max(l, 1e-30).  All of that is kept; the k loop runs inside the block.
//
// Layout: the model's q, o (B, S, H, hd) and k, v (B, S, Kv, hd), read in
// place; GQA reads kv head h / G (the reference's ops.py repeats K and V).
// Work tiles are numbered heaviest causal q tile first, and within a q tile
// the G query heads that share a kv head are neighbours, so their K/V reads
// meet in L2.
//
// bfloat16: a FlashAttention-3-shaped kernel.  One persistent block per SM
// walks the work tiles (128 query rows of one head and batch) with three
// warpgroups.
//   * Producer warpgroup (gives up its registers with setmaxnreg): one
//     thread issues TMA loads through 4-D tensor maps (hd, heads, S, B) with
//     128-byte swizzle -- each tile's Q into one of two buffers (one at HDP
//     256), K and V through a two-stage ring guarded by full / empty
//     mbarriers, running ahead into the next tile.  The box's zero fill pads
//     the ragged S edge and any hd below the compiled width HDP (64, 128 or
//     256); a tile never reads across a batch boundary.  Key tiles hold 128
//     keys (64 at HDP 256, so that the ring fits); tiles past the causal
//     diagonal are never loaded.
//   * Two consumer warpgroups of 64 query rows each.  S = Q K^T is one
//     wgmma m64nBKk16 chain (bf16 -> f32, both operands in shared memory)
//     and stays in registers, as does the online softmax (row max and sum
//     within the quad by __shfl_xor, ex2.approx with scale * log2 e folded
//     in, the mask only on the causal diagonal and the ragged last tile).
//     P is rounded to bf16 in registers (as the model's chunked_attention
//     rounds p to v's dtype) and is wgmma's A operand; V is the transposed B
//     operand in shared memory.  O stays in registers for the whole key loop
//     and is rescaled there.  Software pipeline: S of key tile kt is issued
//     together with O += P V of tile kt - 1, and tile kt's softmax runs while
//     that product is on the tensor cores; the two consumers take turns at
//     issuing (named barriers), so that one's softmax overlaps the other's
//     products.  The epilogue writes, when asked, each row's log-sum-exp
//     m + log(max(l, 1e-30)) in f32 (the backward kernel's input, in
//     flash_attention_bwd.cu), and O / max(l, 1e-30) as bf16 into the
//     warpgroup's own Q rows (the same swizzle) and stores it with one TMA
//     store per 64-column panel, which clips rows >= Sq and columns >= hd;
//     the Q buffer is handed back to the producer in the next tile, once the
//     store has read it.
//
// float32: split-precision TF32 on the tensor cores (3xTF32).  Each operand
// a is split into big = tf32(a) (cvt.rna) and small = tf32(a - big), and
// every product is small*big + big*small + big*big accumulated in f32: the
// dropped small*small term is ~2^-22 relative, so the result keeps f32's
// accuracy (plain TF32 would break the 3e-5 f32 tolerance).  P is f32 here
// and is split too.  One block of 8 warps per (128-row q tile, head,
// batch); each warp owns 16 rows and runs mma.sync m16n8k8 tf32.  Q stays
// in registers (split again in every key tile), K and V (32-key tiles) are
// double-buffered by cp.async with zero fill and split once per block in
// shared memory (big parts in place, small parts beside them: splitting
// them in every warp made the kernel bound by those instructions), S, P
// and O stay in registers.  Both contractions read their 8-wide k slices in
// a permuted order (logical k t -> 2t, t + 4 -> 2t + 1), which makes S's
// accumulator fragment P's A fragment without shuffles and lets Q and K be
// read as float2.  A warp skips key tiles wholly past its last row.
//
// Bound: tensor-core operations.  At the serving path's prefill shape
// (B 4, H 32, Kv 8, S 1024, hd 128, causal) the two products do
// 4 * B * H * hd * S(S+1)/2 = 34.4 GFLOP: 34.8 us at 989 TFLOP/s in bf16,
// 208.5 us at 495 / 3 TFLOP/s in f32 (3xTF32), against 84 MB of q, k, v and
// o in bf16 (25 us at 3.35 TB/s).
//
// The caller (the Python wrapper) pads hd to a multiple of 8 (bf16) or 4
// (f32) -- TMA and cp.async need 16-byte rows -- and hands 16-byte-aligned
// pointers.  Tensor maps are encoded on the host at every call (host-only
// work, so a call can be captured in a CUDA graph), with
// cuTensorMapEncodeTiled taken once from the driver through the runtime's
// cudaGetDriverEntryPoint(ByVersion), so the library needs no -lcuda.
//
// C interface (bound with ctypes): flash_attention_launch returns
// cudaGetLastError() after the launch; the caller raises if it is not 0.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Shape {
  int B, Sq, Sk, H, Kv, hd, causal, nq;
  float scale_log2;            // softmax scale * log2(e)
  float* lse;                  // (B, H, Sq) row log-sum-exp, or null
};

// the natural log-sum-exp of a row's scaled scores from its running max m
// (log2 units, -inf before any key) and its sum l of 2^(s - m):
// m + log(max(l, 1e-30)), in the units of the softmax's argument
__device__ __forceinline__ float row_lse(float m, float l) {
  const float mu = m == -INFINITY ? 0.f : m;
  return (mu + __log2f(fmaxf(l, 1e-30f))) * 0.6931471805599453f;
}

constexpr float kNegInf = -INFINITY;

// --------------------------------------------------------------------------
// PTX helpers: shared addresses, mbarriers, TMA, wgmma, mma.sync
// --------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// 2^x on the special-function unit (max relative error ~2^-22; -inf -> 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wgmma shared-memory descriptor for a 128-byte-swizzled tile (1024-byte
// aligned atoms of 8 rows x 128 bytes).  lbo / sbo in bytes.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t addr = smem_u32(p);
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;          // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous region
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma wrappers: D (64 x N, f32) from A (64 x 16, bf16) and B (16 x N,
// bf16), scale-d a predicate (0: D = A B, 1: D += A B)

// D(64 x 64, f32) (+)= A(64 x 16, bf16, smem, K-major) * B(16 x 64, bf16,
// smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 128, f32) (+)= A(64 x 16, bf16, smem, K-major) * B(16 x 128, bf16,
// smem, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 64, f32) += A(64 x 16, bf16, registers) * B(16 x 64, bf16, smem,
// N-major: the transposed operand)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 128, f32) += A(64 x 16, bf16, registers) * B(16 x 128, bf16, smem,
// N-major: the transposed operand)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 256, f32) += A(64 x 16, bf16, registers) * B(16 x 256, bf16, smem,
// N-major: the transposed operand)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// --------------------------------------------------------------------------
// online softmax of one key tile, on the accumulator fragment of 16-row
// MMAs: element 4j + e of `sc` is row r + 8 (e >> 1), column 8j + c + (e & 1)
// of the tile, r and c this thread's row and column in its 8x8 quad layout
// --------------------------------------------------------------------------

template <int NJ>
__device__ __forceinline__ void softmax_tile(float (&sc)[4 * NJ], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             bool masked, int q_row, int k_col,
                                             const Shape& p) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k_col + 8 * j + (e & 1);
        const int qp = q_row + 8 * (e >> 1);
        if (kp >= p.Sk || (p.causal && kp > qp)) sc[4 * j + e] = kNegInf;
      }
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  float mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r] * p.scale_log2);
    mu[r] = mn == kNegInf ? 0.f : mn;     // a row with no key yet
    corr[r] = exp2_approx(m[r] - mu[r]);
    m[r] = mn;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pr =
          exp2_approx(fmaf(sc[4 * j + e], p.scale_log2, -mu[e >> 1]));
      sc[4 * j + e] = pr;
      rs[e >> 1] += pr;
    }
  // per-thread partial sums: the quad's are added in the epilogue
  l[0] = l[0] * corr[0] + rs[0];
  l[1] = l[1] * corr[1] + rs[1];
}

// --------------------------------------------------------------------------
// bfloat16: TMA + wgmma, one producer and two consumer warpgroups
// --------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// S (64 x BK) = Q (64 x HDP) K^T, both from 128-byte-swizzled panels of
// 64 columns: a k16 slice is 32 bytes into a panel's rows
template <int HDP, int BK, int BQ>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2],
                                         const unsigned char* Qw,
                                         const unsigned char* Kt) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const int pn = kk / 4, kin = kk % 4;
    wgmma_ss<BK>(sc, make_desc(Qw + pn * BQ * 128 + kin * 32, 16, 1024),
                 make_desc(Kt + pn * BK * 128 + kin * 32, 16, 1024),
                 kk > 0 ? 1 : 0);
  }
  wgmma_commit();
}

// O (64 x HDP) += P (64 x BK, registers) V: V is the N-major B operand
// (64-column panels BK * 128 bytes apart, 8-key groups 1024 bytes apart)
template <int HDP, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[HDP / 2],
                                         const uint32_t (&pf)[BK / 16][4],
                                         const unsigned char* Vt) {
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<HDP>(o, pf[kk], make_desc(Vt + kk * 16 * 128, BK * 128, 1024));
  wgmma_commit();
}

// P in bf16 as wgmma's A fragments: k16 slice kk of the S fragment
template <int BK>
__device__ __forceinline__ void to_bf16_frags(const float (&sc)[BK / 2],
                                              uint32_t (&pf)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pf[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
}

template <int HDP>
__device__ __forceinline__ void rescale(float (&o)[HDP / 2],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    o[4 * j + 0] *= corr[0];
    o[4 * j + 1] *= corr[0];
    o[4 * j + 2] *= corr[1];
    o[4 * j + 3] *= corr[1];
  }
}

template <int HDP>
struct Bf16Cfg {
  static constexpr int BQ = 128;                   // two consumers x 64 rows
  static constexpr int BK = HDP <= 128 ? 128 : 64; // keys per tile
  static constexpr int kQStages = HDP <= 128 ? 2 : 1;  // Q / O buffers
  static constexpr int kPanels = HDP / 64;         // 64 columns x 128 bytes
  static constexpr int kQBytes = BQ * HDP * 2;
  static constexpr int kTileBytes = BK * HDP * 2;  // one K or V tile
  // Q[kQStages] | K[2] | V[2] | barriers
  static constexpr int kKOff = kQStages * kQBytes;
  static constexpr int kVOff = kKOff + 2 * kTileBytes;
  static constexpr int kBarOff = kVOff + 2 * kTileBytes;
  static constexpr int kBars = 2 * kQStages + 8;
  static constexpr int kBytes = kBarOff + kBars * 8 + 1024;  // + alignment
  static constexpr int kThreads = 384;
};

// work tile t -> (q0, head, batch): heaviest causal q tile first; a q
// tile's heads in order, so the G heads of one kv head are neighbours
struct Tile {
  int q0, h, b, kvh, n_kt;
};

template <int BQ, int BK>
__device__ __forceinline__ Tile tile_at(int t, const Shape& p) {
  Tile r;
  r.h = t % p.H;
  t /= p.H;
  r.b = t % p.B;
  t /= p.B;
  r.q0 = (p.nq - 1 - t) * BQ;
  r.kvh = r.h / (p.H / p.Kv);
  const int nk = (p.Sk + BK - 1) / BK;
  // key tiles wholly past the tile's last row are never loaded
  r.n_kt = p.causal ? min(nk, (r.q0 + BQ - 1) / BK + 1) : nk;
  return r;
}

template <int HDP>
__global__ void __launch_bounds__(384, 1)
fa_kernel_wgmma(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap omap, Shape p) {
  using C = Bf16Cfg<HDP>;
  constexpr int BQ = C::BQ, BK = C::BK, NP = C::kPanels, NQ = C::kQStages;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment of every tile: the 128-byte swizzle's atom
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = smem;
  unsigned char* Ks = smem + C::kKOff;
  unsigned char* Vs = smem + C::kVOff;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* q_full = bars;            // [NQ] a tile's Q arrived
  uint64_t* q_empty = bars + NQ;      // [NQ] both consumers stored their O
  uint64_t* k_full = bars + 2 * NQ;   // [2] a stage's K tile arrived
  uint64_t* v_full = k_full + 2;      // [2] a stage's V tile arrived
  uint64_t* k_empty = k_full + 4;     // [2] both consumers are done with K
  uint64_t* v_empty = k_full + 6;     // [2] both consumers are done with V

  // persistent: block c takes work tiles c, c + gridDim.x, ...
  const int n_tiles = p.nq * p.H * p.B;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < NQ; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 2);      // one storing thread per consumer
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 256);    // every consumer thread arrives
      mbar_init(&v_empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the Q buffers and the K/V ring full,
    // running ahead into the next work tile ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      int it = 0, kv = 0;             // work tiles, key tiles loaded
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
        const Tile tc = tile_at<BQ, BK>(t, p);
        const int qb = it % NQ;
        mbar_wait(&q_empty[qb], ((it / NQ) & 1) ^ 1);
        mbar_expect_tx(&q_full[qb], C::kQBytes);
        for (int pn = 0; pn < NP; ++pn)
          tma_load_4d(Qs + qb * C::kQBytes + pn * BQ * 128, &qmap,
                      &q_full[qb], pn * 64, tc.h, tc.q0, tc.b);
        for (int kt = 0; kt < tc.n_kt; ++kt, ++kv) {
          const int s = kv & 1, free_ph = ((kv >> 1) & 1) ^ 1;
          unsigned char* kd = Ks + s * C::kTileBytes;
          unsigned char* vd = Vs + s * C::kTileBytes;
          mbar_wait(&k_empty[s], free_ph);
          mbar_expect_tx(&k_full[s], C::kTileBytes);
          for (int pn = 0; pn < NP; ++pn)
            tma_load_4d(kd + pn * BK * 128, &kmap, &k_full[s], pn * 64,
                        tc.kvh, kt * BK, tc.b);
          mbar_wait(&v_empty[s], free_ph);
          mbar_expect_tx(&v_full[s], C::kTileBytes);
          for (int pn = 0; pn < NP; ++pn)
            tma_load_4d(vd + pn * BK * 128, &vmap, &v_full[s], pn * 64,
                        tc.kvh, kt * BK, tc.b);
        }
      }
    }
    return;
  }

  // ---- consumers: 64 query rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int w = wg - 1;
  const int row0 = w * 64;                      // of the tile's 128 rows
  const int warp = tid / 32, lane = tid % 32;
  const int ra = warp * 16 + lane / 4;          // rows ra, ra + 8 of 64
  const int c0 = (lane % 4) * 2;                // columns c0, c0 + 1 of 8

  // The two consumers take turns (named barriers 3 and 4) at issuing their
  // products, so that one's softmax overlaps the other's products;
  // consumer 0 starts, and each turn's sync meets exactly one arrive of the
  // other consumer (consumer 1 passes no turn after its very last).
  const int my_turn = 3 + w, their_turn = 4 - w;
  if (w == 1) named_barrier_arrive(3, 256);

  float o[HDP / 2];
  float m[2], l[2], corr[2];
  float sc[BK / 2];
  uint32_t pf[BK / 16][4];

  int it = 0, kv = 0;                 // work tiles, key tiles consumed
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    const Tile tc = tile_at<BQ, BK>(t, p);
    const int n_kt = tc.n_kt;
    // key tiles wholly past this warpgroup's last row are not computed
    const int n_comp =
        p.causal ? min(n_kt, (tc.q0 + row0 + 63) / BK + 1) : n_kt;
    const bool last_work = t + static_cast<int>(gridDim.x) >= n_tiles;
    const int qb = it % NQ;
    unsigned char* Qb = Qs + qb * C::kQBytes;
    const unsigned char* Qw = Qb + row0 * 128; // this WG's rows of a panel
    auto take_turn = [&]() { named_barrier_sync(my_turn, 256); };
    auto pass_turn = [&](int kt) {
      if (!(w == 1 && last_work && kt == n_kt - 1))
        named_barrier_arrive(their_turn, 256);
    };
    // the mask is applied only on the causal diagonal and the ragged last
    // key tile: diag_k0 is the first key tile start that needs it
    const int diag_k0 = tc.q0 + row0 - BK + 2;
    const int q_row = tc.q0 + row0 + ra;

#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;

    // Software pipeline: S(kt) = Q K(kt)^T is issued together with
    // O += P(kt - 1) V(kt - 1), and the softmax of tile kt runs while the
    // latter is on the tensor cores.  Ring slot of key tile kt: kv + kt.
    mbar_wait(&q_full[qb], (it / NQ) & 1);
    {
      const int s = kv & 1, ph = (kv >> 1) & 1;
      mbar_wait(&k_full[s], ph);
      take_turn();
      issue_qk<HDP, BK, BQ>(sc, Qw, Ks + s * C::kTileBytes);
      pass_turn(0);
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(&k_empty[s]);
      if (NQ > 1 && tid == 0 && it > 0) {
        // the previous tile's O store has long read its buffer: free it
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(&q_empty[(it - 1) % NQ]);
      }
      softmax_tile<BK / 8>(sc, m, l, corr,
                           BK > p.Sk || (p.causal && 0 >= diag_k0), q_row,
                           c0, p);
      to_bf16_frags<BK>(sc, pf);
    }
    for (int kt = 1; kt < n_comp; ++kt) {
      const int r = kv + kt;
      const int s = r & 1, ph = (r >> 1) & 1;
      const int sp = (r - 1) & 1, php = ((r - 1) >> 1) & 1;
      mbar_wait(&k_full[s], ph);
      take_turn();
      issue_qk<HDP, BK, BQ>(sc, Qw, Ks + s * C::kTileBytes);
      rescale<HDP>(o, corr);
      mbar_wait(&v_full[sp], php);
      issue_pv<HDP, BK>(o, pf, Vs + sp * C::kTileBytes);
      pass_turn(kt);
      wgmma_wait<1>();                // S(kt) is in
      fence_regs(sc);
      mbar_arrive(&k_empty[s]);
      const int k0 = kt * BK;
      softmax_tile<BK / 8>(sc, m, l, corr,
                           k0 + BK > p.Sk || (p.causal && k0 >= diag_k0),
                           q_row, k0 + c0, p);
      wgmma_wait<0>();                // O += P(kt - 1) V(kt - 1) is done
      fence_regs(o);
      fence_regs(pf);
      mbar_arrive(&v_empty[sp]);
      to_bf16_frags<BK>(sc, pf);
    }
    {
      const int r = kv + n_comp - 1;
      const int s = r & 1, ph = (r >> 1) & 1;
      rescale<HDP>(o, corr);
      mbar_wait(&v_full[s], ph);
      issue_pv<HDP, BK>(o, pf, Vs + s * C::kTileBytes);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pf);
      mbar_arrive(&v_empty[s]);
    }
    // key tiles past this warpgroup's rows: take the turn and release the
    // stage, after its loads land so that the arrivals count for their own
    // phase
    for (int kt = n_comp; kt < n_kt; ++kt) {
      const int r = kv + kt;
      const int s = r & 1, ph = (r >> 1) & 1;
      mbar_wait(&k_full[s], ph);
      take_turn();
      pass_turn(kt);
      mbar_arrive(&k_empty[s]);
      mbar_wait(&v_full[s], ph);
      mbar_arrive(&v_empty[s]);
    }
    kv += n_kt;

    // epilogue: O / max(l, 1e-30) in bf16 into this WG's own Q rows (same
    // 128-byte swizzle), then one TMA store per panel (clips rows >= Sq and
    // columns >= hd); the Q buffer is free again once the store has read it
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      inv[i] = 1.f / fmaxf(l[i], 1e-30f);
    }
    if (p.lse != nullptr && c0 == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = tc.q0 + row0 + ra + 8 * i;
        if (row < p.Sq)
          p.lse[(static_cast<int64_t>(tc.b) * p.H + tc.h) * p.Sq + row] =
              row_lse(m[i], l[i]);
      }
    }
    unsigned char* Ow = Qb + row0 * 128;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int pn = j / 8, ch = j % 8;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = ra + 8 * i;
        *reinterpret_cast<uint32_t*>(Ow + pn * BQ * 128 + row * 128 +
                                     ((ch ^ (row & 7)) << 4) + c0 * 2) =
            pack_bf16(o[4 * j + 2 * i] * inv[i],
                      o[4 * j + 2 * i + 1] * inv[i]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_barrier_sync(1 + w, 128);
    if (tid == 0) {
      if (tc.q0 + row0 < p.Sq) {
        for (int pn = 0; pn < NP; ++pn)
          tma_store_4d(&omap, Ow + pn * BQ * 128, pn * 64, tc.h,
                       tc.q0 + row0, tc.b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
      if (NQ == 1) {
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(&q_empty[qb]);
      }
    }
  }
  // the last store must have read shared memory before the block exits
  if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// --------------------------------------------------------------------------
// float32: 3xTF32 on mma.sync m16n8k8, 8 warps of 16 rows, cp.async ring
// --------------------------------------------------------------------------

template <int HDP>
struct F32Cfg {
  static constexpr int BQ = 128, BK = 32, kThreads = 256;  // 8 warps
  static constexpr int LDK = HDP + 8;   // float2 reads of K rows: no conflict
  static constexpr int LDV = HDP + 4;   // column reads of V: no conflict
  static constexpr int kKFloats = BK * LDK, kVFloats = BK * LDV;
  // K, V ring of two stages (raw, then TF32 big parts in place) and the
  // small parts of the tile being computed
  static constexpr int kBytes = 3 * (kKFloats + kVFloats) * 4;
};



// volatile: the split of Q's fragments is redone in every key tile;
// hoisted out of the loop it would hold 128 more registers and spill
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  asm volatile("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm volatile("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in 3xTF32: small terms first, then big * big
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           uint32_t bb0, uint32_t bb1,
                                           uint32_t bs0, uint32_t bs1) {
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// rows [k0, k0 + BK) of a (S, ., hd) slab into a (BK, LD) tile; rows >= Sk
// and columns >= hd are zero-filled
template <int HDP, int LD>
__device__ __forceinline__ void load_kv_tile(float* dst, const float* src,
                                             int k0, int Sk, int64_t stride,
                                             int hd) {
  constexpr int CH = HDP / 4;
  constexpr int BK = F32Cfg<HDP>::BK;
#pragma unroll
  for (int i = threadIdx.x; i < BK * CH; i += F32Cfg<HDP>::kThreads) {
    const int r = i / CH, c = i % CH;
    const bool ok = k0 + r < Sk && c * 4 < hd;
    const float* s = ok ? src + static_cast<int64_t>(k0 + r) * stride + c * 4
                        : src;
    cp_async16(dst + r * LD + c * 4, s, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// a (BK, LD) tile split in place into TF32 big parts, and its small parts
// into `small`: each element once per block, not once per warp
template <int HDP, int LD>
__device__ __forceinline__ void split_tile(float* big, float* small) {
  constexpr int C4 = HDP / 4;
  constexpr int BK = F32Cfg<HDP>::BK;
  for (int i = threadIdx.x; i < BK * C4; i += F32Cfg<HDP>::kThreads) {
    const int off = (i / C4) * LD + 4 * (i % C4);
    const float4 x = *reinterpret_cast<const float4*>(big + off);
    uint32_t b[4], sm[4];
    split_tf32(x.x, b[0], sm[0]);
    split_tf32(x.y, b[1], sm[1]);
    split_tf32(x.z, b[2], sm[2]);
    split_tf32(x.w, b[3], sm[3]);
    *reinterpret_cast<uint4*>(big + off) = make_uint4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<uint4*>(small + off) =
        make_uint4(sm[0], sm[1], sm[2], sm[3]);
  }
}

template <int HDP>
__global__ void __launch_bounds__(256, 1)
fa_kernel_tf32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, Shape p) {
  using C = F32Cfg<HDP>;
  constexpr int BQ = C::BQ, BK = C::BK, LDK = C::LDK, LDV = C::LDV;
  constexpr int NC = HDP / 8, NJ = BK / 8;
  extern __shared__ __align__(16) float fsmem[];
  float* Ks = fsmem;                        // [2][BK][LDK]
  float* Vs = fsmem + 2 * C::kKFloats;      // [2][BK][LDV]
  float* Ksm = Vs + 2 * C::kVFloats;        // [BK][LDK] small parts
  float* Vsm = Ksm + C::kKFloats;           // [BK][LDV]

  int bid = blockIdx.x;
  const int h = bid % p.H;
  bid /= p.H;
  const int b = bid % p.B;
  bid /= p.B;
  const int q0 = (p.nq - 1 - bid) * BQ;
  const int kvh = h / (p.H / p.Kv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr0 = q0 + warp * 16;           // the warp's first query row

  const int64_t q_stride = static_cast<int64_t>(p.H) * p.hd;
  const int64_t kv_stride = static_cast<int64_t>(p.Kv) * p.hd;
  const float* kb = k + (static_cast<int64_t>(b) * p.Sk * p.Kv + kvh) * p.hd;
  const float* vb = v + (static_cast<int64_t>(b) * p.Sk * p.Kv + kvh) * p.hd;
  const int nk = (p.Sk + BK - 1) / BK;
  const int n_kt = p.causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
  const int n_kt_w = p.causal ? min(nk, (wr0 + 15) / BK + 1) : nk;

  load_kv_tile<HDP, LDK>(Ks, kb, 0, p.Sk, kv_stride, p.hd);
  load_kv_tile<HDP, LDV>(Vs, vb, 0, p.Sk, kv_stride, p.hd);

  // this thread's Q: rows wr0 + g (qa) and wr0 + g + 8 (qb), columns
  // 8c + 2t and + 1 (the permuted k order: logical t -> 2t, t + 4 -> 2t + 1)
  float2 qa[NC], qb[NC];
  {
    const float* qbase =
        q + (static_cast<int64_t>(b) * p.Sq * p.H + h) * p.hd;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 8 * c + 2 * t;
      qa[c] = qb[c] = make_float2(0.f, 0.f);
      if (col < p.hd) {
        if (wr0 + g < p.Sq)
          qa[c] = *reinterpret_cast<const float2*>(
              qbase + static_cast<int64_t>(wr0 + g) * q_stride + col);
        if (wr0 + g + 8 < p.Sq)
          qb[c] = *reinterpret_cast<const float2*>(
              qbase + static_cast<int64_t>(wr0 + g + 8) * q_stride + col);
      }
    }
  }

  float oacc[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
    oacc[c][0] = oacc[c][1] = oacc[c][2] = oacc[c][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      const int s1 = (kt + 1) & 1;
      load_kv_tile<HDP, LDK>(Ks + s1 * C::kKFloats, kb, (kt + 1) * BK, p.Sk,
                             kv_stride, p.hd);
      load_kv_tile<HDP, LDV>(Vs + s1 * C::kVFloats, vb, (kt + 1) * BK, p.Sk,
                             kv_stride, p.hd);
      asm volatile("cp.async.wait_group 2;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    float* Kt = Ks + (kt & 1) * C::kKFloats;
    float* Vt = Vs + (kt & 1) * C::kVFloats;
    split_tile<HDP, LDK>(Kt, Ksm);
    split_tile<HDP, LDV>(Vt, Vsm);
    __syncthreads();
    if (kt < n_kt_w) {
      const int k0 = kt * BK;

      // S = Q K^T: 16 x BK per warp
      float sc[4 * NJ];
#pragma unroll
      for (int i = 0; i < 4 * NJ; ++i) sc[i] = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        uint32_t ab[4], as[4];
        split_tf32(qa[c].x, ab[0], as[0]);
        split_tf32(qb[c].x, ab[1], as[1]);
        split_tf32(qa[c].y, ab[2], as[2]);
        split_tf32(qb[c].y, ab[3], as[3]);
        uint2 bb[NJ], bs[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int off = (8 * j + g) * LDK + 8 * c + 2 * t;
          bb[j] = *reinterpret_cast<const uint2*>(Kt + off);
          bs[j] = *reinterpret_cast<const uint2*>(Ksm + off);
        }
        // the three passes over the NJ independent accumulators in turn
#pragma unroll
        for (int pass = 0; pass < 3; ++pass)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            float acc[4] = {sc[4 * j], sc[4 * j + 1], sc[4 * j + 2],
                            sc[4 * j + 3]};
            if (pass == 0) mma_tf32(acc, as, bb[j].x, bb[j].y);
            if (pass == 1) mma_tf32(acc, ab, bs[j].x, bs[j].y);
            if (pass == 2) mma_tf32(acc, ab, bb[j].x, bb[j].y);
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[4 * j + e] = acc[e];
          }
      }

      float corr[2];
      const bool masked = k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > wr0);
      softmax_tile<NJ>(sc, m, l, corr, masked, wr0 + g, k0 + 2 * t, p);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        oacc[c][0] *= corr[0];
        oacc[c][1] *= corr[0];
        oacc[c][2] *= corr[1];
        oacc[c][3] *= corr[1];
      }

      // O += P V, keys of each 8-slice in the permuted order: P's A
      // fragment is S's accumulator fragment, V rows 2t and 2t + 1
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t pb[4], ps[4];
        split_tf32(sc[4 * j + 0], pb[0], ps[0]);
        split_tf32(sc[4 * j + 2], pb[1], ps[1]);
        split_tf32(sc[4 * j + 1], pb[2], ps[2]);
        split_tf32(sc[4 * j + 3], pb[3], ps[3]);
        const int v0 = (8 * j + 2 * t) * LDV + g;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          mma_3xtf32(oacc[c], pb, ps, __float_as_uint(Vt[v0 + 8 * c]),
                     __float_as_uint(Vt[v0 + LDV + 8 * c]),
                     __float_as_uint(Vsm[v0 + 8 * c]),
                     __float_as_uint(Vsm[v0 + LDV + 8 * c]));
      }
    }
    __syncthreads();   // the stage and the small parts are refilled next
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  if (p.lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wr0 + g + 8 * r;
      if (row < p.Sq)
        p.lse[(static_cast<int64_t>(b) * p.H + h) * p.Sq + row] =
            row_lse(m[r], l[r]);
    }
  }
  float* ob = o + (static_cast<int64_t>(b) * p.Sq * p.H + h) * p.hd;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = 8 * c + 2 * t;
    if (col >= p.hd) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wr0 + g + 8 * r;
      if (row < p.Sq)
        *reinterpret_cast<float2*>(ob + static_cast<int64_t>(row) * q_stride +
                                   col) =
            make_float2(oacc[c][2 * r] * inv[r], oacc[c][2 * r + 1] * inv[r]);
    }
  }
}

// --------------------------------------------------------------------------
// host side
// --------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a 4-D bf16 map (hd, heads, S, B) of a contiguous (B, S, heads, hd)
// tensor; box 64 columns x 1 head x `rows` rows x 1 batch, 128-byte swizzle,
// zero fill outside
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int hd,
              int heads, int S, int B, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// raise a kernel's dynamic shared-memory cap once per device, so that later
// launches (possibly inside a CUDA graph capture) make no attribute call
template <typename Kernel>
int configure(Kernel kernel, int smem, bool (&configured)[64]) {
  int dev = 0, max_optin = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (smem > max_optin) return cudaErrorInvalidValue;
  if (!configured[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  return cudaSuccess;
}

template <int HDP>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                Shape p, cudaStream_t stream) {
  using C = Bf16Cfg<HDP>;
  static bool configured[64] = {};
  int err = configure(fa_kernel_wgmma<HDP>, C::kBytes, configured);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap qm, km, vm, om;
  if (!make_map(enc, &qm, q, p.hd, p.H, p.Sq, p.B, C::BQ) ||
      !make_map(enc, &km, k, p.hd, p.Kv, p.Sk, p.B, C::BK) ||
      !make_map(enc, &vm, v, p.hd, p.Kv, p.Sk, p.B, C::BK) ||
      !make_map(enc, &om, o, p.hd, p.H, p.Sq, p.B, C::BQ / 2))
    return cudaErrorInvalidValue;
  p.nq = (p.Sq + C::BQ - 1) / C::BQ;
  const int64_t tiles = static_cast<int64_t>(p.nq) * p.H * p.B;
  if (tiles > 0x7fffffff || sms <= 0) return cudaErrorInvalidValue;
  // one persistent block per SM (one fits: 168 registers x 384 threads)
  const unsigned blocks = static_cast<unsigned>(tiles < sms ? tiles : sms);
  fa_kernel_wgmma<HDP><<<blocks, C::kThreads, C::kBytes, stream>>>(
      qm, km, vm, om, p);
  return cudaGetLastError();
}

template <int HDP>
int launch_f32(const void* q, const void* k, const void* v, void* o, Shape p,
               cudaStream_t stream) {
  using C = F32Cfg<HDP>;
  static bool configured[64] = {};
  int err = configure(fa_kernel_tf32<HDP>, C::kBytes, configured);
  if (err != cudaSuccess) return err;
  p.nq = (p.Sq + C::BQ - 1) / C::BQ;
  const int64_t blocks = static_cast<int64_t>(p.nq) * p.H * p.B;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  fa_kernel_tf32<HDP><<<static_cast<unsigned>(blocks), C::kThreads, C::kBytes,
                        stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 2 = bfloat16.  q, o: (B, Sq, H, hd); k, v:
// (B, Sk, Kv, hd); all contiguous and 16-byte aligned; H % Kv == 0; hd a
// multiple of 8 (bf16, <= 256) or 4 (f32, <= 128).  lse: null, or a float32
// (B, H, Sq) that receives each row's log-sum-exp of its scaled scores.
int flash_attention_launch(int dtype, const void* q, const void* k,
                           const void* v, void* o, void* lse, int B, int Sq,
                           int Sk, int H, int Kv, int hd, int causal,
                           float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  if (Sk <= 0 || Kv <= 0 || H % Kv != 0 || hd <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return static_cast<int>(cudaErrorInvalidValue);
  Shape p{B, Sq, Sk, H, Kv, hd, causal ? 1 : 0, 0,
          scale * 1.4426950408889634f, static_cast<float*>(lse)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 2 && hd % 8 == 0) {
    if (hd <= 64) return launch_bf16<64>(q, k, v, o, p, s);
    if (hd <= 128) return launch_bf16<128>(q, k, v, o, p, s);
    if (hd <= 256) return launch_bf16<256>(q, k, v, o, p, s);
  }
  if (dtype == 0 && hd % 4 == 0) {
    if (hd <= 64) return launch_f32<64>(q, k, v, o, p, s);
    if (hd <= 128) return launch_f32<128>(q, k, v, o, p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
