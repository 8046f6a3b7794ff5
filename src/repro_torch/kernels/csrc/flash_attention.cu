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
// max(l, 1e-30).  All of that is kept, but the k loop runs inside the block.
//
// Design (simple and right first):
//   * One block of 4 warps per (64-row q tile, head, batch).  Each warp owns
//     16 rows of the tile; the rows' m, l and the f32 accumulator O (64 x hd)
//     stay in shared memory across the block's k tiles.
//   * Layout: the model's (B, S, H, hd) and (B, S, Kv, hd), read in place.
//     GQA reads kv head h / (H / Kv); nothing is repeated in memory (the
//     reference's ops.py repeats K and V G times).
//   * Per 64-key tile: Q, K and V tiles sit in shared memory, zero-padded to
//     a compiled head width HDP (32, 64, 128 or 256) and to 64 rows (16-byte
//     loads where hd allows); every shared row is padded by 16 bytes (4 f32)
//     so that the rows of a fragment fall in different banks.  For bf16 both
//     products run on tensor cores through WMMA (mma.sync, 16x16x16 bf16 in,
//     f32 accumulate): S = Q K^T into shared memory; then the online softmax
//     with two lanes per row, 32 keys each, in f32; P rounded to bf16 (as the
//     model's chunked_attention rounds p to v's dtype); then O = O * corr +
//     P V with O loaded from and stored back to shared memory.  For f32 the
//     same steps run as f32 FMAs (TF32 tensor cores would lose the f32
//     tolerance).
//   * Causal: k tiles past the q tile's last row are never visited.  Padded
//     keys (k_pos >= Sk) and, when causal, k_pos > q_pos score -1e30, as in the
//     Pallas body; padded query rows are computed and not written.
//   * wgmma, TMA, O in registers and a pipelined tile ring are later work.
//
// Bound: tensor-core operations.  At the serving path's prefill shape
// (B 4, H 32, Kv 8, S 1024, hd 128, bf16, causal) the two products do
// 4 * B * H * hd * S(S+1)/2 = 34.4 GFLOP: 34.8 us at 989 TFLOP/s, against
// 84 MB of q, k, v and o (25 us at 3.35 TB/s).
//
// Shared memory per block: 3 * 64 * (HDP * sizeof(T) + 16) + 64 * 68 * 4
// (+ 64 * 72 * 2 for bf16 P) + 64 * (HDP + 4) * 4 + 512 bytes: 83 KB at
// hd 128 bf16, 153 KB at hd 128 f32, 195 KB at hd 256 bf16.  The wrapper
// refuses f32 above hd 128 (it would not fit the 227 KB a block can have).
//
// C interface (bound with ctypes): flash_attention_launch returns
// cudaGetLastError() after the launch; the caller raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kWarps = 4;        // each warp owns 16 query rows
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

struct Shape {
  int Sq, Sk, H, Kv, hd, causal;
  float scale;
};

// Shared-memory layout of one block, in elements of each array's type.
template <typename T, int HDP>
struct Smem {
  static constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int LDT = HDP + 16 / static_cast<int>(sizeof(T));  // Q K V
  static constexpr int LDS = kBK + 4;                                  // S f32
  static constexpr int LDP = kBK + 8;                                  // P bf16
  static constexpr int LDO = HDP + 4;                                  // O f32
  static constexpr size_t kTile = static_cast<size_t>(kBQ) * LDT * sizeof(T);
  static constexpr size_t kS = static_cast<size_t>(kBQ) * LDS * sizeof(float);
  static constexpr size_t kP = kMma ? static_cast<size_t>(kBQ) * LDP * 2 : 0;
  static constexpr size_t kO = static_cast<size_t>(kBQ) * LDO * sizeof(float);
  static constexpr size_t kBytes = 3 * kTile + kS + kP + kO
                                   + 2 * kBQ * sizeof(float);
};

// rows [row0, row0 + 64) of a (S, ., hd) slab with row stride `stride`
// elements into a (64, LD) shared tile; rows >= S and columns >= hd are 0.
template <typename T, int HDP, int LD>
__device__ void load_tile(T* __restrict__ dst, const T* __restrict__ src,
                          int row0, int S, int64_t stride, int hd, bool vec) {
  constexpr int VN = 16 / sizeof(T);
  if (vec) {
    constexpr int kPerRow = HDP / VN;
    const int valid = hd / VN;
    for (int i = threadIdx.x; i < kBQ * kPerRow; i += kThreads) {
      const int r = i / kPerRow, c = i % kPerRow;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < S && c < valid)
        val = __ldg(reinterpret_cast<const uint4*>(
            src + static_cast<int64_t>(row0 + r) * stride + c * VN));
      *reinterpret_cast<uint4*>(dst + r * LD + c * VN) = val;
    }
  } else {
    for (int i = threadIdx.x; i < kBQ * HDP; i += kThreads) {
      const int r = i / HDP, c = i % HDP;
      T val = from_f32<T>(0.f);
      if (row0 + r < S && c < hd)
        val = src[static_cast<int64_t>(row0 + r) * stride + c];
      dst[r * LD + c] = val;
    }
  }
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, Shape p, bool vec) {
  using L = Smem<T, HDP>;
  constexpr bool kMma = L::kMma;
  constexpr int LDT = L::LDT, LDS = L::LDS, LDP = L::LDP, LDO = L::LDO;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.Kv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  // softmax ownership: two lanes per row, 32 keys each
  const int my_row = r0 + lane / 2;
  const int half = lane % 2;

  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kBQ * LDT;
  T* Vs = Ks + kBK * LDT;
  float* Ss = reinterpret_cast<float*>(Vs + kBK * LDT);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(Ss + kBQ * LDS);
  float* Os = reinterpret_cast<float*>(smem + 3 * L::kTile + L::kS + L::kP);
  float* ms = Os + kBQ * LDO;
  float* ls = ms + kBQ;

  const int64_t q_stride = static_cast<int64_t>(p.H) * p.hd;
  const int64_t kv_stride = static_cast<int64_t>(p.Kv) * p.hd;
  const T* qb = q + (static_cast<int64_t>(b) * p.Sq * p.H + h) * p.hd;
  const T* kb = k + (static_cast<int64_t>(b) * p.Sk * p.Kv + kvh) * p.hd;
  const T* vb = v + (static_cast<int64_t>(b) * p.Sk * p.Kv + kvh) * p.hd;

  load_tile<T, HDP, LDT>(Qs, qb, q0, p.Sq, q_stride, p.hd, vec);
  for (int i = threadIdx.x; i < kBQ * LDO; i += kThreads) Os[i] = 0.f;
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    ms[i] = kNegInf;
    ls[i] = 0.f;
  }

  const int nk = (p.Sk + kBK - 1) / kBK;
  const int kt_end = p.causal ? min(nk, (q0 + kBQ - 1) / kBK + 1) : nk;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                  // every warp is done with the last K, V
    load_tile<T, HDP, LDT>(Ks, kb, k0, p.Sk, kv_stride, p.hd, vec);
    load_tile<T, HDP, LDT>(Vs, vb, k0, p.Sk, kv_stride, p.hd, vec);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows (unscaled, f32)
    if constexpr (kMma) {
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int d = 0; d < HDP; d += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> fb;
          wmma::load_matrix_sync(fa, Qs + r0 * LDT + d, LDT);
          wmma::load_matrix_sync(fb, Ks + j * 16 * LDT + d, LDT);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(Ss + r0 * LDS + j * 16, acc, LDS,
                                wmma::mem_row_major);
      }
    } else {
      for (int c = half * 32; c < half * 32 + 32; ++c) {
        float acc = 0.f;
#pragma unroll 8
        for (int d = 0; d < HDP; ++d)
          acc += to_f32(Qs[my_row * LDT + d]) * to_f32(Ks[c * LDT + d]);
        Ss[my_row * LDS + c] = acc;
      }
    }
    __syncwarp();

    // online softmax over this tile: this lane's 32 keys of its row
    {
      const int q_pos = q0 + my_row;
      float s[32];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int c = half * 32 + j;
        const int k_pos = k0 + c;
        const bool ok = k_pos < p.Sk && (!p.causal || q_pos >= k_pos);
        s[j] = ok ? Ss[my_row * LDS + c] * p.scale : kNegInf;
        mx = fmaxf(mx, s[j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_prev = ms[my_row];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float pr = expf(s[j] - m_new);
        sum += pr;
        const int c = half * 32 + j;
        if constexpr (kMma) Ps[my_row * LDP + c] = __float2bfloat16(pr);
        else Ss[my_row * LDS + c] = pr;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float corr = expf(m_prev - m_new);
      __syncwarp();                   // both lanes of the row read ms first
      if (half == 0) {
        ls[my_row] = ls[my_row] * corr + sum;
        ms[my_row] = m_new;
      }
#pragma unroll 8
      for (int d = half * (HDP / 2); d < (half + 1) * (HDP / 2); ++d)
        Os[my_row * LDO + d] *= corr;
    }
    __syncwarp();

    // O += P V for this warp's 16 rows
    if constexpr (kMma) {
#pragma unroll
      for (int j = 0; j < HDP / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::load_matrix_sync(acc, Os + r0 * LDO + j * 16, LDO,
                               wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fb;
          wmma::load_matrix_sync(fa, Ps + r0 * LDP + kk * 16, LDP);
          wmma::load_matrix_sync(fb, Vs + kk * 16 * LDT + j * 16, LDT);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(Os + r0 * LDO + j * 16, acc, LDO,
                                wmma::mem_row_major);
      }
    } else {
      for (int d = half * (HDP / 2); d < (half + 1) * (HDP / 2); ++d) {
        float acc = Os[my_row * LDO + d];
#pragma unroll 8
        for (int c = 0; c < kBK; ++c)
          acc += Ss[my_row * LDS + c] * to_f32(Vs[c * LDT + d]);
        Os[my_row * LDO + d] = acc;
      }
    }
    __syncwarp();
  }

  // o = O / max(l, 1e-30) for this warp's valid rows, a row at a time
  T* ob = o + (static_cast<int64_t>(b) * p.Sq * p.H + h) * p.hd;
  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr;
    if (q0 + r >= p.Sq) break;
    const float inv_l = 1.f / fmaxf(ls[r], 1e-30f);
    for (int d = lane; d < p.hd; d += 32)
      ob[static_cast<int64_t>(q0 + r) * q_stride + d] =
          from_f32<T>(Os[r * LDO + d] * inv_l);
  }
}

template <typename T, int HDP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           Shape p, cudaStream_t stream) {
  constexpr size_t smem = Smem<T, HDP>::kBytes;
  int dev = 0, max_optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (smem > static_cast<size_t>(max_optin)) return cudaErrorInvalidValue;
  // raise this instantiation's dynamic shared-memory cap once per device, so
  // that later launches (possibly inside a CUDA graph capture) make no
  // attribute call
  static bool configured[64] = {};
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        fa_kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  constexpr int VN = 16 / sizeof(T);
  const bool vec = p.hd % VN == 0;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, B);
  fa_kernel<T, HDP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), p, vec);
  return cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B,
              Shape p, cudaStream_t stream) {
  if (p.hd <= 32) return launch<T, 32>(q, k, v, o, B, p, stream);
  if (p.hd <= 64) return launch<T, 64>(q, k, v, o, B, p, stream);
  if (p.hd <= 128) return launch<T, 128>(q, k, v, o, B, p, stream);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (p.hd <= 256) return launch<T, 256>(q, k, v, o, B, p, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 2 = bfloat16.  q, o: (B, Sq, H, hd); k, v:
// (B, Sk, Kv, hd); all contiguous; H % Kv == 0.
int flash_attention_launch(int dtype, const void* q, const void* k,
                           const void* v, void* o, int B, int Sq, int Sk,
                           int H, int Kv, int hd, int causal, float scale,
                           void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return static_cast<int>(cudaGetLastError());
  if (Sk <= 0 || Kv <= 0 || H % Kv != 0 || hd <= 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Shape p{Sq, Sk, H, Kv, hd, causal ? 1 : 0, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_hd<float>(q, k, v, o, B, p, s);
    case 2: return launch_hd<__nv_bfloat16>(q, k, v, o, B, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
