// The backward of flash attention for Hopper (sm_90a): the gradient of
// kernel K3 (flash_attention.cu).
//
// The reference has no backward Pallas kernel: its training attention
// (src/repro/models/attention.py, chunked_attention) runs each query block's
// key loop as lax.scan(jax.checkpoint(body)), so its backward recomputes
// every live (query block, key block) tile's scores from q and k and keeps
// no (S, S) tensor.  This kernel does the same recompute, FlashAttention-2
// style, from the row log-sum-exp that K3's forward writes beside O:
//
//   P  = exp(q k^T * scale - lse)             (masked: causal, padded keys)
//   dV = P^T dO                               (P rounded to the input type,
//                                              as the forward rounds p)
//   dP = dO V^T,  dS = P * (dP - delta),  delta = rowsum(dO * O)
//   dQ = dS K * scale,  dK = dS^T Q * scale
//
// Three grids (four when G > 1), no atomics, every output written once:
//   * fa_bwd_delta_kernel: delta[b, h, i] = sum_d dO * O in f32, a warp a row.
//   * fa_bwd_dkdv_kernel: one block per (key tile of 64 keys, query head of the
//     kv head's group, kv head, batch), heaviest causal key tile first.
//     Four warps of 16 keys each (times two at a head width of 256, which
//     split dK / dV's columns in halves so that their f32 accumulators fit
//     in registers).  The block walks the query tiles that see its keys
//     (causal: from the diagonal on); Q, dO, lse and delta tiles are
//     double-buffered by cp.async.  S^T and dP^T are recomputed per tile in
//     registers, dK and dV accumulate in f32 registers.  With G = 1 they
//     are written as they are; with G > 1 each block writes its head's
//     f32 share, and fa_bwd_reduce_kernel sums the G shares in head order
//     (fixed: deterministic) into dK and dV.  (A block walking all G heads, the
//     sum in its registers, left qwen2-7b's 28 / 4 heads at S 4096 with
//     256 blocks of which key tile 0's did 64x the last one's work: the
//     head split gives 7x the blocks and a 7x shorter longest block.)
//   * fa_bwd_dq_kernel: one block per (query tile of 64 rows, head, batch),
//     heaviest first; four warps of 16 rows; key tiles up to the diagonal
//     double-buffered by cp.async; dQ accumulates in f32 registers.
//
// Products.  bfloat16: mma.sync m16n8k16 (bf16 -> f32), operands from
// shared memory by ldmatrix (row tiles padded by 16 bytes: no bank
// conflicts), P and dS converted from the accumulator fragment to the A
// fragment in registers.  float32: split-precision TF32 on mma.sync m16n8k8
// (3xTF32, as K3's forward: each operand a = big + small, big = tf32(a),
// and a*b ~ small*big + big*small + big*big in f32), operands read from
// shared memory as scalars, P and dS reused from the accumulator fragment
// in the forward's permuted k order (logical k t -> 2t, t + 4 -> 2t + 1).
//
// Masks: key >= Sk, query >= Sq and, when causal, key > query (aligned at
// position 0, as the forward), applied only on tiles that cross an edge.
// Rows and columns past S or hd are zero-filled by cp.async.  The caller
// pads hd to a multiple of 8 (bf16) or 4 (f32) and hands contiguous,
// 16-byte-aligned tensors.
//
// C interface (bound with ctypes): flash_attention_backward_launch returns
// cudaGetLastError() after the launches; the caller raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

struct BwdShape {
  int B, Sq, Sk, H, Kv, hd, causal;
  float scale;                 // softmax scale
  float scale_log2;            // scale * log2(e)
};

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
struct Elem;
template <>
struct Elem<bf16> {
  static constexpr int kVec = 8;   // elements in 16 bytes
  static constexpr int kPad = 8;   // row padding: 16 bytes
};
template <>
struct Elem<float> {
  static constexpr int kVec = 4;
  static constexpr int kPad = 4;
};

template <typename T, int HDP>
struct BwdCfg {
  static constexpr int LD = HDP + Elem<T>::kPad;  // shared row stride
  // dK / dV: the columns a warp accumulates, and the warps sharing its keys
  static constexpr int HDW = HDP < 128 ? HDP : 128;
  static constexpr int NWD = HDP / HDW;
  static constexpr int KG = 4;                    // warps of 16 keys
  static constexpr int BK = 16 * KG;              // keys a block
  // query rows a dK/dV step: 64 where the step's tiles fit in registers
  // (a 64-row step halves the barriers a row), 32 at 256 and f32 at 128
  static constexpr int BQ =
      HDP <= 64 || (HDP == 128 && sizeof(T) == 2) ? 64 : 32;
  static constexpr int kKvThreads = 32 * KG * NWD;
  static constexpr int kKvBytes =
      (2 * BK * LD + 4 * BQ * LD) * static_cast<int>(sizeof(T)) + 4 * BQ * 4;
  // dQ
  static constexpr int QW = 4;                    // warps of 16 rows
  static constexpr int BQ2 = 16 * QW;             // query rows a block
  static constexpr int BK2 = HDP <= 128 ? 64 : 32;  // keys a step
  static constexpr int kQThreads = 32 * QW;
  static constexpr int kQBytes =
      (2 * BQ2 * LD + 4 * BK2 * LD) * static_cast<int>(sizeof(T));
};

// rows [r0, r0 + ROWS) of a (., S, heads, hd) slab (src at row 0 of the
// head) into a (ROWS, LD) tile; rows >= S and columns >= hd zero-filled
template <typename T, int HDP, int LD, int ROWS, int NT>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int r0, int S,
                                          int64_t stride, int hd) {
  constexpr int V = Elem<T>::kVec, CH = HDP / V;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < S && c * V < hd;
    const T* s = ok ? src + static_cast<int64_t>(r0 + r) * stride + c * V
                    : src;
    cp_async16(dst + r * LD + c * V, s, ok);
  }
}

// --------------------------------------------------------------------------
// bfloat16 products: mma.sync m16n8k16, ldmatrix
// --------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// acc[j] += A (16 x KD, rows of `a`) . B^T (rows 8j.. of `b`, KD columns)
template <int NT, int KD, int LD>
__device__ __forceinline__ void gemm_nt(float (&acc)[NT][4], const bf16* a,
                                        const bf16* b, int lane) {
  static_assert(NT % 2 == 0 && KD % 16 == 0, "bf16 tiles");
#pragma unroll
  for (int k0 = 0; k0 < KD; k0 += 16) {
    uint32_t af[4];
    ldsm_x4(af, a + (lane % 16) * LD + k0 + (lane / 16) * 8);
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (jj * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + k0 +
                      ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * jj], af, bf[0], bf[1]);
      mma_bf16(acc[2 * jj + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[d] += P (16 x 8 NK, accumulator fragments, rounded to bf16) . B
// (rows 0..8 NK of `b`, columns 8d..)
template <int ND, int NK, int LD>
__device__ __forceinline__ void gemm_rn(float (&acc)[ND][4],
                                        const float (&pm)[NK][4],
                                        const bf16* b, int lane) {
  static_assert(NK % 2 == 0 && ND % 2 == 0, "bf16 tiles");
#pragma unroll
  for (int kk = 0; kk < NK / 2; ++kk) {
    const uint32_t af[4] = {
        pack_bf16(pm[2 * kk][0], pm[2 * kk][1]),
        pack_bf16(pm[2 * kk][2], pm[2 * kk][3]),
        pack_bf16(pm[2 * kk + 1][0], pm[2 * kk + 1][1]),
        pack_bf16(pm[2 * kk + 1][2], pm[2 * kk + 1][3])};
#pragma unroll
    for (int dd = 0; dd < ND / 2; ++dd) {
      uint32_t bf[4];
      ldsm_x4_t(bf, b + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                        dd * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * dd], af, bf[0], bf[1]);
      mma_bf16(acc[2 * dd + 1], af, bf[2], bf[3]);
    }
  }
}

// --------------------------------------------------------------------------
// float32 products: 3xTF32 on mma.sync m16n8k8
// --------------------------------------------------------------------------

__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32 from unsplit operands: small terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const float (&a)[4],
                                           float b0, float b1) {
  uint32_t ab[4], as[4], bb0, bs0, bb1, bs1;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ab[i], as[i]);
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}

template <int NT, int KD, int LD>
__device__ __forceinline__ void gemm_nt(float (&acc)[NT][4], const float* a,
                                        const float* b, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll 4
  for (int k0 = 0; k0 < KD; k0 += 8) {
    const float af[4] = {a[g * LD + k0 + t], a[(g + 8) * LD + k0 + t],
                         a[g * LD + k0 + t + 4], a[(g + 8) * LD + k0 + t + 4]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* bj = b + (8 * j + g) * LD + k0 + t;
      mma_3xtf32(acc[j], af, bj[0], bj[4]);
    }
  }
}

// P's accumulator fragment as the A fragment of a k8 slice in the permuted
// order (logical t -> column 2t, t + 4 -> 2t + 1); B's rows follow it
template <int ND, int NK, int LD>
__device__ __forceinline__ void gemm_rn(float (&acc)[ND][4],
                                        const float (&pm)[NK][4],
                                        const float* b, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    const float af[4] = {pm[j][0], pm[j][2], pm[j][1], pm[j][3]};
    const float* bj = b + (8 * j + 2 * t) * LD + g;
#pragma unroll
    for (int dd = 0; dd < ND; ++dd)
      mma_3xtf32(acc[dd], af, bj[8 * dd], bj[LD + 8 * dd]);
  }
}

// --------------------------------------------------------------------------
// output stores: accumulator fragment rows r0 + g (+ 8), columns c0 + 8d +
// 2t (+ 1), times `mul`, into a (., S, heads, hd) slab
// --------------------------------------------------------------------------

__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

template <typename T, int ND>
__device__ __forceinline__ void store_frag(T* slab, const float (&acc)[ND][4],
                                           int r0, int c0, int S,
                                           int64_t stride, int hd, float mul,
                                           int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const int col = c0 + 8 * d + 2 * t;
    if (col >= hd) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + g + 8 * h;
      if (row < S)
        store2(slab + static_cast<int64_t>(row) * stride + col,
               acc[d][2 * h] * mul, acc[d][2 * h + 1] * mul);
    }
  }
}

// --------------------------------------------------------------------------
// delta = rowsum(dO * O)
// --------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__global__ void fa_bwd_delta_kernel(const T* __restrict__ o,
                                    const T* __restrict__ dout,
                                    float* __restrict__ delta, BwdShape p) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) +
                      threadIdx.x / 32;   // (b, i, h) in o's layout
  const int lane = threadIdx.x % 32;
  const int64_t rows = static_cast<int64_t>(p.B) * p.Sq * p.H;
  if (row >= rows) return;
  const T* orow = o + row * p.hd;
  const T* drow = dout + row * p.hd;
  float s = 0.f;
  for (int d = lane; d < p.hd; d += 32) s += to_f32(orow[d]) * to_f32(drow[d]);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (lane == 0) {
    const int h = static_cast<int>(row % p.H);
    const int64_t bi = row / p.H;
    const int i = static_cast<int>(bi % p.Sq);
    const int b = static_cast<int>(bi / p.Sq);
    delta[(static_cast<int64_t>(b) * p.H + h) * p.Sq + i] = s;
  }
}

// --------------------------------------------------------------------------
// dK, dV: one block per (key tile, kv head, batch)
// --------------------------------------------------------------------------

template <typename T, int HDP>
__global__ void __launch_bounds__(BwdCfg<T, HDP>::kKvThreads)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv,
            float* __restrict__ share, BwdShape p) {
  using C = BwdCfg<T, HDP>;
  constexpr int LD = C::LD, BK = C::BK, BQ = C::BQ, HDW = C::HDW;
  constexpr int NT = C::kKvThreads, NQ = BQ / 8, ND = HDW / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);          // [BK][LD]
  T* Vs = Ks + BK * LD;                            // [BK][LD]
  T* Qs = Vs + BK * LD;                            // [2][BQ][LD]
  T* Ds = Qs + 2 * BQ * LD;                        // [2][BQ][LD] dO
  float* Ls = reinterpret_cast<float*>(Ds + 2 * BQ * LD);  // [2][BQ] lse*log2e
  float* Es = Ls + 2 * BQ;                         // [2][BQ] delta

  // key tile slowest, first: under the causal mask key tile 0 has the
  // most query tiles to visit; then the query head of the group
  const int G = p.H / p.Kv;
  const int bid = blockIdx.x;
  const int kt = bid / (p.Kv * p.B * G);
  const int gi = bid % G;
  const int kvh = (bid / G) % p.Kv;
  const int b = (bid / (G * p.Kv)) % p.B;
  const int k0 = kt * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kr = k0 + (warp % C::KG) * 16;   // this warp's first key
  const int dw = (warp / C::KG) * HDW;       // its first dK / dV column
  const int g = lane / 4, t = lane % 4;

  const int64_t qs = static_cast<int64_t>(p.H) * p.hd;     // q row stride
  const int64_t ks = static_cast<int64_t>(p.Kv) * p.hd;
  const int64_t kv_off = (static_cast<int64_t>(b) * p.Sk * p.Kv + kvh) * p.hd;
  load_rows<T, HDP, LD, BK, NT>(Ks, k + kv_off, k0, p.Sk, ks, p.hd);
  load_rows<T, HDP, LD, BK, NT>(Vs, v + kv_off, k0, p.Sk, ks, p.hd);
  cp_async_commit();

  // the query tiles that see this key tile: from the diagonal on
  const int nqt = (p.Sq + BQ - 1) / BQ;
  const int qt0 = p.causal ? min(k0 / BQ, nqt) : 0;
  const int n_it = nqt - qt0;
  const int h = kvh * G + gi;

  auto fetch = [&](int it, int buf) {
    const int q0 = (qt0 + it) * BQ;
    const int64_t off = (static_cast<int64_t>(b) * p.Sq * p.H + h) * p.hd;
    load_rows<T, HDP, LD, BQ, NT>(Qs + buf * BQ * LD, q + off, q0, p.Sq, qs,
                                  p.hd);
    load_rows<T, HDP, LD, BQ, NT>(Ds + buf * BQ * LD, dout + off, q0, p.Sq,
                                  qs, p.hd);
    const int64_t lo = (static_cast<int64_t>(b) * p.H + h) * p.Sq;
    for (int i = threadIdx.x; i < BQ; i += NT) {
      const bool ok = q0 + i < p.Sq;
      Ls[buf * BQ + i] = ok ? lse[lo + q0 + i] * kLog2e : 0.f;
      Es[buf * BQ + i] = ok ? delta[lo + q0 + i] : 0.f;
    }
  };

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;

  if (n_it > 0) fetch(0, 0);
  cp_async_commit();
  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) fetch(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = (qt0 + it) * BQ;
    // a warp whose keys are all past the tile's last query has no work
    if (!(p.causal && kr > q0 + BQ - 1)) {
      const T* Qb = Qs + buf * BQ * LD;
      const T* Db = Ds + buf * BQ * LD;
      const float* Lb = Ls + buf * BQ;
      const float* Eb = Es + buf * BQ;
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      const T* Kw = Ks + (warp % C::KG) * 16 * LD;
      const T* Vw = Vs + (warp % C::KG) * 16 * LD;
      gemm_nt<NQ, HDP, LD>(st, Kw, Qb, lane);     // S^T = K Q^T
      gemm_nt<NQ, HDP, LD>(dpt, Vw, Db, lane);    // dP^T = V dO^T
      const bool edge = kr + 16 > p.Sk || q0 + BQ > p.Sq ||
                        (p.causal && kr + 15 > q0);
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * j + 2 * t + (e & 1);
          float pr = exp2_approx(fmaf(st[j][e], p.scale_log2, -Lb[qi]));
          if (edge) {
            const int key = kr + g + 8 * (e >> 1), qq = q0 + qi;
            if (key >= p.Sk || qq >= p.Sq || (p.causal && key > qq)) pr = 0.f;
          }
          st[j][e] = pr;                            // P^T
          dpt[j][e] = pr * (dpt[j][e] - Eb[qi]);    // dS^T
        }
      gemm_rn<ND, NQ, LD>(dva, st, Db + dw, lane);   // dV += P^T dO
      gemm_rn<ND, NQ, LD>(dka, dpt, Qb + dw, lane);  // dK += dS^T Q
    }
    __syncthreads();   // this buffer is refilled by the next fetch
  }
  cp_async_wait<0>();

  if (G == 1) {
    store_frag<T, ND>(dk + kv_off, dka, kr, dw, p.Sk, ks, p.hd, p.scale,
                      lane);
    store_frag<T, ND>(dv + kv_off, dva, kr, dw, p.Sk, ks, p.hd, 1.f, lane);
  } else {
    // this head's f32 share: share[0 or 1][gi] has dk's / dv's layout
    const int64_t n = static_cast<int64_t>(p.B) * p.Sk * p.Kv * p.hd;
    float* sk = share + gi * n + kv_off;
    float* sv = share + (G + gi) * n + kv_off;
    store_frag<float, ND>(sk, dka, kr, dw, p.Sk, ks, p.hd, p.scale, lane);
    store_frag<float, ND>(sv, dva, kr, dw, p.Sk, ks, p.hd, 1.f, lane);
  }
}

// dK, dV = the sums of the G heads' shares, in head order; n4 = elements / 4
template <typename T>
__global__ void fa_bwd_reduce_kernel(const float* __restrict__ share,
                              T* __restrict__ dk, T* __restrict__ dv,
                              int64_t n4, int G) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= 2 * n4) return;
  const bool is_v = i >= n4;
  const int64_t j = is_v ? i - n4 : i;
  const float4* src = reinterpret_cast<const float4*>(share) +
                      (is_v ? G * n4 : 0) + j;
  float4 acc = src[0];
  for (int g = 1; g < G; ++g) {
    const float4 x = src[g * n4];
    acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
  }
  T* out = (is_v ? dv : dk) + 4 * j;
  store2(out, acc.x, acc.y);
  store2(out + 2, acc.z, acc.w);
}

// --------------------------------------------------------------------------
// dQ: one block per (query tile, head, batch)
// --------------------------------------------------------------------------

template <typename T, int HDP>
__global__ void __launch_bounds__(BwdCfg<T, HDP>::kQThreads)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, BwdShape p) {
  using C = BwdCfg<T, HDP>;
  constexpr int LD = C::LD, BQ = C::BQ2, BK = C::BK2;
  constexpr int NT = C::kQThreads, NK = BK / 8, ND = HDP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [BQ][LD]
  T* Ds = Qs + BQ * LD;                     // [BQ][LD] dO
  T* Ks = Ds + BQ * LD;                     // [2][BK][LD]
  T* Vs = Ks + 2 * BK * LD;                 // [2][BK][LD]

  const int nqt = (p.Sq + BQ - 1) / BQ;
  int bid = blockIdx.x;
  const int h = bid % p.H;
  bid /= p.H;
  const int b = bid % p.B;
  const int q0 = (nqt - 1 - bid / p.B) * BQ;   // heaviest causal tile first
  const int kvh = h / (p.H / p.Kv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = q0 + warp * 16;               // this warp's first row

  const int64_t qs = static_cast<int64_t>(p.H) * p.hd;
  const int64_t ks = static_cast<int64_t>(p.Kv) * p.hd;
  const int64_t q_off = (static_cast<int64_t>(b) * p.Sq * p.H + h) * p.hd;
  const int64_t kv_off = (static_cast<int64_t>(b) * p.Sk * p.Kv + kvh) * p.hd;
  load_rows<T, HDP, LD, BQ, NT>(Qs, q + q_off, q0, p.Sq, qs, p.hd);
  load_rows<T, HDP, LD, BQ, NT>(Ds, dout + q_off, q0, p.Sq, qs, p.hd);
  cp_async_commit();

  const int nk = (p.Sk + BK - 1) / BK;
  const int n_kt = p.causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
  auto fetch = [&](int kt, int buf) {
    load_rows<T, HDP, LD, BK, NT>(Ks + buf * BK * LD, k + kv_off, kt * BK,
                                  p.Sk, ks, p.hd);
    load_rows<T, HDP, LD, BK, NT>(Vs + buf * BK * LD, v + kv_off, kt * BK,
                                  p.Sk, ks, p.hd);
  };

  // this thread's rows wr + g and wr + g + 8
  float l2[2], dl[2];
  const int64_t lo = (static_cast<int64_t>(b) * p.H + h) * p.Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wr + g + 8 * r;
    l2[r] = row < p.Sq ? lse[lo + row] * kLog2e : 0.f;
    dl[r] = row < p.Sq ? delta[lo + row] : 0.f;
  }

  float dqa[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[d][e] = 0.f;

  fetch(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_kt) fetch(kt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int kk0 = kt * BK;
    if (!(p.causal && kk0 > wr + 15) && wr < p.Sq) {
      const T* Kb = Ks + buf * BK * LD;
      const T* Vb = Vs + buf * BK * LD;
      float s[NK][4], dp[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      gemm_nt<NK, HDP, LD>(s, Qs + warp * 16 * LD, Kb, lane);   // S = Q K^T
      gemm_nt<NK, HDP, LD>(dp, Ds + warp * 16 * LD, Vb, lane);  // dP = dO V^T
      const bool edge = kk0 + BK > p.Sk || wr + 16 > p.Sq ||
                        (p.causal && kk0 + BK - 1 > wr);
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float pr = exp2_approx(fmaf(s[j][e], p.scale_log2, -l2[r]));
          if (edge) {
            const int key = kk0 + 8 * j + 2 * t + (e & 1);
            const int row = wr + g + 8 * r;
            if (key >= p.Sk || row >= p.Sq || (p.causal && key > row))
              pr = 0.f;
          }
          s[j][e] = pr * (dp[j][e] - dl[r]);       // dS
        }
      gemm_rn<ND, NK, LD>(dqa, s, Kb, lane);       // dQ += dS K
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  store_frag<T, ND>(dq + q_off, dqa, wr, 0, p.Sq, qs, p.hd, p.scale, lane);
}

// --------------------------------------------------------------------------
// host side
// --------------------------------------------------------------------------

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

template <typename T, int HDP>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* lse, const void* dout, void* dq, void* dk, void* dv,
           void* delta, void* share, BwdShape p, cudaStream_t stream) {
  using C = BwdCfg<T, HDP>;
  static bool conf_kv[64] = {}, conf_q[64] = {};
  int err = configure(fa_bwd_dkdv_kernel<T, HDP>, C::kKvBytes, conf_kv);
  if (err != cudaSuccess) return err;
  err = configure(fa_bwd_dq_kernel<T, HDP>, C::kQBytes, conf_q);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float* lt = static_cast<const float*>(lse);
  float* de = static_cast<float*>(delta);

  const int64_t rows = static_cast<int64_t>(p.B) * p.Sq * p.H;
  const int64_t blocks_d = (rows + 7) / 8;
  const int G = p.H / p.Kv;
  const int64_t blocks_kv =
      static_cast<int64_t>((p.Sk + C::BK - 1) / C::BK) * p.Kv * p.B * G;
  const int64_t n4 = static_cast<int64_t>(p.B) * p.Sk * p.Kv * p.hd / 4;
  if (G > 1 && share == nullptr) return cudaErrorInvalidValue;
  const int64_t blocks_q =
      static_cast<int64_t>((p.Sq + C::BQ2 - 1) / C::BQ2) * p.H * p.B;
  if (blocks_d > 0x7fffffff || blocks_kv > 0x7fffffff ||
      blocks_q > 0x7fffffff)
    return cudaErrorInvalidValue;
  fa_bwd_delta_kernel<T><<<static_cast<unsigned>(blocks_d), 256, 0, stream>>>(
      static_cast<const T*>(o), dot, de, p);
  fa_bwd_dkdv_kernel<T, HDP><<<static_cast<unsigned>(blocks_kv), C::kKvThreads,
                        C::kKvBytes, stream>>>(
      qt, kt, vt, dot, lt, de, static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<float*>(share), p);
  if (G > 1)
    fa_bwd_reduce_kernel<T>
        <<<static_cast<unsigned>((2 * n4 + 255) / 256), 256, 0, stream>>>(
            static_cast<const float*>(share), static_cast<T*>(dk),
            static_cast<T*>(dv), n4, G);
  fa_bwd_dq_kernel<T, HDP><<<static_cast<unsigned>(blocks_q), C::kQThreads,
                      C::kQBytes, stream>>>(qt, kt, vt, dot, lt, de,
                                            static_cast<T*>(dq), p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 2 = bfloat16.  q, o, dout, dq: (B, Sq, H, hd); k, v,
// dk, dv: (B, Sk, Kv, hd); lse and the scratch delta: float32 (B, H, Sq);
// the scratch share: float32 (2, G, B, Sk, Kv, hd) when G = H / Kv > 1
// (else null); all contiguous and 16-byte aligned; hd a multiple of 8
// (bf16, <= 256) or 4 (f32, <= 128).
int flash_attention_backward_launch(int dtype, const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* lse, const void* dout,
                                    void* dq, void* dk, void* dv, void* delta,
                                    void* share, int B, int Sq, int Sk, int H,
                                    int Kv, int hd, int causal, float scale,
                                    void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || Sk <= 0)
    return static_cast<int>(cudaGetLastError());
  if (Kv <= 0 || H % Kv != 0 || hd <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {q, k, v, o, lse, dout, dq, dk, dv, delta, share};
  for (const void* ptr : ptrs)
    if (!aligned16(ptr)) return static_cast<int>(cudaErrorInvalidValue);
  BwdShape p{B, Sq, Sk, H, Kv, hd, causal ? 1 : 0, scale, scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 2 && hd % 8 == 0) {
    if (hd <= 64) return launch<bf16, 64>(q, k, v, o, lse, dout, dq, dk, dv,
                                          delta, share, p, s);
    if (hd <= 128) return launch<bf16, 128>(q, k, v, o, lse, dout, dq, dk, dv,
                                            delta, share, p, s);
    if (hd <= 256) return launch<bf16, 256>(q, k, v, o, lse, dout, dq, dk, dv,
                                            delta, share, p, s);
  }
  if (dtype == 0 && hd % 4 == 0) {
    if (hd <= 64) return launch<float, 64>(q, k, v, o, lse, dout, dq, dk, dv,
                                           delta, share, p, s);
    if (hd <= 128) return launch<float, 128>(q, k, v, o, lse, dout, dq, dk,
                                             dv, delta, share, p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
