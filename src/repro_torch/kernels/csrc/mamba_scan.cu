// Mamba-1 selective scan for Hopper (sm_90a): kernel K4 of the port.
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t      (per channel d,
//   y_t = sum_n C_t[n] * h_t[n] + D * x_t                     N states each)
//
// with h_0 = 0, in f32 for f32 and bf16 inputs; writes y (B, L, Di) in x's
// dtype and the state after the last step, h_final (B, Di, N) in f32.
// Any A (Di, N), any N in 1..16, any L and Di.
//
// Replaces the Pallas kernel `mamba_scan` of
// src/repro/kernels/mamba_scan/kernel.py (`_scan_kernel`).  Its grid
// (batch, d_inner block, time chunk) ran the time chunks in order, carrying
// h (block_d, N) in VMEM scratch, so it never materialised the
// (B, L, Di, N) tensor.  It did not return h; the model's prefill needs it
// for the decode cache, so this kernel also writes h_final.
//
// What bounds it at the serving path's prefill shape (B 4, L 1024, Di 8192,
// N 16, bf16):
//   * device memory: x and dt read and y written (67 MB each), B_t and C_t
//     (0.26 MB), h_final (2.1 MB): 204 MB, 61 us at 3.35 TB/s;
//   * the special-function units: B*L*Di*N = 537 M exponentials at 16 per
//     SM per clock, ~128 us on 132 SMs at 1.98 GHz (outside the table of
//     peak rates, so no part of the bound);
//   * the FP32 pipe: with A pre-scaled by log2(e), 4 FP32 instructions per
//     (b, t, d, n) (dt*A', dt*x*B, the a*h FMA, the h*C FMA): ~64 us at 128
//     lanes per SM per clock;
//   * issue: the step loop of the serving instantiation (bf16, two lanes,
//     16-byte rows) holds 449 instructions for its 64 exponentials, 7.02
//     per (b, t, d, n): 136 FMUL, 136 FFMA, 64 MUFU.EX2, 48 shared loads,
//     8 shuffles and 8 FADD, 16 bf16 -> f32 and 8 f32 -> bf16 conversions,
//     8 stores of y, and 17 address and loop instructions (counted in its
//     SASS by tools/k4_sass.py).  At one warp instruction per clock on each
//     of the 528 schedulers that is 112.6 us at 1.98 GHz.
//   The kernel reads ~205 us on an NVIDIA H100 80GB HBM3 at 700 W
//   (chip_smoke.py), above all four.  What holds it there is not measured (no profiler on the
//   card machine).  Variants timed while it was designed, with no figures
//   kept, point away from the SFU alone: an FMUL in place of every ex2 saved
//   little, and moving an eighth or a quarter of the exponentials onto an
//   FMA polynomial made it slower.  Issue and latency are the hypothesis.
//
// Design, and what it does about each limit:
//   * Parallelism.  A channel's N states are split over two adjacent lanes
//     of a warp, kSPL = 8 states each (one lane for N <= 8): 65 K threads
//     at the serving shape, 16 warps on each SM, every block resident at
//     once, and each lane's 8 states independent chains (ILP).  y is the
//     two lanes' partial sums, combined by one xor shuffle (p0 + p1, the
//     same bits on both lanes).  Four lanes of four states keep twice the
//     warps but issue more instructions a state (x, dt, shuffles); two
//     channels a thread halve the B / C reads but halve the warps: both
//     were slower on the card.
//   * Step groups.  Steps run in groups of kGroup = 8: the group's shared
//     reads first, the state updates in time order, then all 8 shuffles
//     together, so the shuffles' latency overlaps and the next steps'
//     exponentials do not wait behind them.
//   * Asynchronous staging.  A block takes kChannels = 64 channels of one
//     batch row and walks time in tiles of 64 steps (bf16; 32 in f32, 8 KB
//     a tile).  The x and dt tiles of chunk c+1 are copied with cp.async
//     (16-byte pieces where Di and the pointers allow, 8 or 4 otherwise,
//     each width compiled as such; the wrapper pads an odd bf16 Di, which
//     it must copy, to a 16-byte row) into the second of two buffers while
//     chunk c computes.  Padding every ragged Di to a 16-byte row instead
//     would cost a copy of x and dt and of y back: with it, Di 8100 bf16
//     (B 4, L 1000) read 525.6 us against 275.3 at the 8-byte width, and
//     Di 8190 f32 647.2 against 325.3 (tools/k4_row_widths.py, NVIDIA
//     H100 80GB HBM3, 700 W); for the odd Di 4099 the 16-byte row beat one
//     padded channel, 228.7 against 254.3 us, both with the copy.  The
//     chunk's B_t and C_t rows are loaded into registers during chunk c and
//     stored to shared memory as f32 after it, so that each step a lane
//     reads its 8 B values and its 8 C values as two 16-byte vectors each.
//   * Exponentials on the SFU.  A is scaled by log2(e) once per channel, so
//     exp(dt*A) is one FMUL and one ex2.approx.ftz.f32 (MUFU.EX2, relative
//     error ~2^-22); nothing assumes the model's A = -(n+1).
//   * Stores.  Each step's y goes to a shared-memory tile; after the chunk
//     the block writes the tile with 16-byte stores (8 or 4 where Di does
//     not allow 16).  h_final is written once at the end.
//
// C interface (bound with ctypes): mamba_scan_launch returns
// cudaGetLastError() after the launch; the caller raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kChannels = 64;    // channels per block
constexpr int kTileBytes = 8192; // one staged x (or dt) tile of a block
constexpr int kSPL = 8;          // states per lane
constexpr int kMaxN = 16;        // states per channel
constexpr int kGroup = 8;        // time steps whose lane sums go together
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// cp.async of kBytes (4, 8 or 16), zero-filled when !valid
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(kBytes), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// one piece of kVec bytes, shared -> global
template <int kVec>
__device__ __forceinline__ void store_piece(void* dst, const void* src) {
  if constexpr (kVec == 16) {
    *static_cast<uint4*>(dst) = *static_cast<const uint4*>(src);
  } else if constexpr (kVec == 8) {
    *static_cast<uint2*>(dst) = *static_cast<const uint2*>(src);
  } else {
    *static_cast<uint32_t*>(dst) = *static_cast<const uint32_t*>(src);
  }
}

// At least 4 blocks on an SM: 128 registers a thread at kLanes 2 (every
// block of the serving shape resident at once), 255 at kLanes 1.
template <typename T, int kLanes, int kVec>
__global__ void __launch_bounds__(kChannels * kLanes, 4)
scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
            const float* __restrict__ A, const T* __restrict__ Bt,
            const T* __restrict__ Ct, const float* __restrict__ Dw,
            T* __restrict__ y, float* __restrict__ h_final, int64_t L, int Di,
            int N) {
  constexpr int kThreads = kChannels * kLanes;
  // time steps per staged tile: 64 in bf16, 32 in f32
  constexpr int kChunk = kTileBytes / (kChannels * sizeof(T));
  constexpr int kRowBytes = kChannels * static_cast<int>(sizeof(T));
  // B_t / C_t elements of one chunk that each thread stages
  constexpr int kBC = kChunk * kMaxN / kThreads;
  static_assert(kChunk * kMaxN % kThreads == 0, "B/C staging split");
  static_assert(kChunk % kGroup == 0, "whole groups in a full chunk");
  // x, dt and y rows move in pieces of kVec bytes
  constexpr int kPieces = kRowBytes / kVec;  // per tile row
  constexpr int kElems = kVec / static_cast<int>(sizeof(T));   // per piece

  __shared__ __align__(16) T xs[2][kChunk][kChannels];
  __shared__ __align__(16) T ds[2][kChunk][kChannels];
  __shared__ __align__(16) T ys[kChunk][kChannels];
  __shared__ __align__(16) float bs[kChunk][kMaxN];
  __shared__ __align__(16) float cs[kChunk][kMaxN];

  const int tid = threadIdx.x;
  const int lane = tid % kLanes;             // which kSPL states
  const int c = tid / kLanes;                // channel within the block
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + c;
  const bool active = d < Di;
  const int64_t row0 = static_cast<int64_t>(b) * L;

  float a[kSPL], h[kSPL];
#pragma unroll
  for (int s = 0; s < kSPL; ++s) {
    const int n = lane * kSPL + s;
    a[s] = (active && n < N) ? A[static_cast<int64_t>(d) * N + n] * kLog2e
                             : 0.f;
    h[s] = 0.f;
  }
  const float dd = active ? Dw[d] : 0.f;

  // x, dt tiles of the chunk at t0 into buffer `buf`: one commit group
  auto stage_xdt = [&](int64_t t0, int tc, int buf) {
    for (int i = tid; i < 2 * kChunk * kPieces; i += kThreads) {
      const int which = i / (kChunk * kPieces);
      const int r = i % (kChunk * kPieces);
      const int t = r / kPieces, p = r % kPieces;
      if (t >= tc) continue;
      const int dp = d0 + p * kElems;
      const bool valid = dp < Di;
      const int64_t idx = (row0 + t0 + t) * Di + (valid ? dp : 0);
      const T* src = (which ? dt : x) + idx;
      char* dst = reinterpret_cast<char*>(which ? &ds[buf][t][0]
                                                : &xs[buf][t][0]) + p * kVec;
      cp_async<kVec>(dst, src, valid);
    }
    cp_async_commit();
  };
  // B_t, C_t of the chunk at t0 into registers (zero past N and tc)
  T breg[kBC], creg[kBC];
  auto load_bc = [&](int64_t t0, int tc) {
#pragma unroll
    for (int j = 0; j < kBC; ++j) {
      const int i = tid + j * kThreads;
      const int t = i / kMaxN, n = i % kMaxN;
      const bool ok = t < tc && n < N;
      const int64_t idx = (row0 + t0 + t) * N + n;
      breg[j] = ok ? Bt[idx] : from_f32<T>(0.f);
      creg[j] = ok ? Ct[idx] : from_f32<T>(0.f);
    }
  };
  auto store_bc = [&]() {
#pragma unroll
    for (int j = 0; j < kBC; ++j) {
      const int i = tid + j * kThreads;
      bs[i / kMaxN][i % kMaxN] = to_f32(breg[j]);
      cs[i / kMaxN][i % kMaxN] = to_f32(creg[j]);
    }
  };
  // U consecutive steps from t of buffer buf: their shared-memory reads
  // first, then the state updates in order, then the lane sums of all U
  // steps together, so that each shuffle's latency overlaps the others'
  // and no step's exponentials wait behind the last step's shuffle
  auto steps = [&](auto width, int buf, int t) {
    constexpr int U = decltype(width)::value;
    float xv[U], dv[U], acc[U];
    float4 bv[U][kSPL / 4], cv[U][kSPL / 4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      xv[u] = to_f32(xs[buf][t + u][c]);
      dv[u] = to_f32(ds[buf][t + u][c]);
#pragma unroll
      for (int q = 0; q < kSPL / 4; ++q) {
        // 16-byte reads of the lane's B and C values
        bv[u][q] = *reinterpret_cast<const float4*>(
            &bs[t + u][lane * kSPL + 4 * q]);
        cv[u][q] = *reinterpret_cast<const float4*>(
            &cs[t + u][lane * kSPL + 4 * q]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float dx = dv[u] * xv[u];
      acc[u] = 0.f;
#pragma unroll
      for (int q = 0; q < kSPL / 4; ++q) {
        float* hq = h + 4 * q;
        const float* aq = a + 4 * q;
        const float4 b4 = bv[u][q], c4 = cv[u][q];
        hq[0] = ex2(dv[u] * aq[0]) * hq[0] + dx * b4.x;
        hq[1] = ex2(dv[u] * aq[1]) * hq[1] + dx * b4.y;
        hq[2] = ex2(dv[u] * aq[2]) * hq[2] + dx * b4.z;
        hq[3] = ex2(dv[u] * aq[3]) * hq[3] + dx * b4.w;
        acc[u] += hq[0] * c4.x;
        acc[u] += hq[1] * c4.y;
        acc[u] += hq[2] * c4.z;
        acc[u] += hq[3] * c4.w;
      }
    }
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], o);
    }
    // every lane of the channel holds the same sum (the xor tree is
    // commutative at each level) and stores it: no branch
#pragma unroll
    for (int u = 0; u < U; ++u) ys[t + u][c] = from_f32<T>(acc[u] + dd * xv[u]);
  };

  const int64_t nchunks = (L + kChunk - 1) / kChunk;
  auto chunk_len = [&](int64_t ci) {
    return static_cast<int>(min(static_cast<int64_t>(kChunk),
                                L - ci * kChunk));
  };
  stage_xdt(0, chunk_len(0), 0);
  load_bc(0, chunk_len(0));
  store_bc();

  for (int64_t ci = 0; ci < nchunks; ++ci) {
    const int buf = static_cast<int>(ci & 1);
    const int64_t t0 = ci * kChunk;
    const int tc = chunk_len(ci);
    cp_async_wait_all();          // this thread's pieces of chunk ci
    // everyone's pieces and B/C of chunk ci are visible; the last chunk's
    // y tile is written out, and buffer buf ^ 1 is free
    __syncthreads();
    const bool more = ci + 1 < nchunks;
    if (more) {
      stage_xdt(t0 + kChunk, chunk_len(ci + 1), buf ^ 1);
      load_bc(t0 + kChunk, chunk_len(ci + 1));
    }
    int t = 0;
    for (; t + kGroup <= tc; t += kGroup)
      steps(std::integral_constant<int, kGroup>{}, buf, t);
    for (; t < tc; ++t) steps(std::integral_constant<int, 1>{}, buf, t);
    __syncthreads();              // the y tile is whole; bs, cs are free
    for (int i = tid; i < tc * kPieces; i += kThreads) {
      const int t = i / kPieces, p = i % kPieces;
      const int dp = d0 + p * kElems;
      if (dp < Di)
        store_piece<kVec>(y + (row0 + t0 + t) * Di + dp,
                          reinterpret_cast<const char*>(&ys[t][0]) + p * kVec);
    }
    if (more) store_bc();
  }
  if (active) {
#pragma unroll
    for (int s = 0; s < kSPL; ++s) {
      const int n = lane * kSPL + s;
      if (n < N) h_final[(static_cast<int64_t>(b) * Di + d) * N + n] = h[s];
    }
  }
}

template <typename T, int kVec>
void launch(int lanes, dim3 grid, cudaStream_t s, const void* x,
            const void* dt, const float* A, const void* Bt, const void* Ct,
            const float* D, void* y, float* h, long long L, int Di, int N) {
  static_assert(2 * kSPL == kMaxN, "one or two lanes hold a channel");
  const T* xp = static_cast<const T*>(x);
  const T* dp = static_cast<const T*>(dt);
  const T* bp = static_cast<const T*>(Bt);
  const T* cp = static_cast<const T*>(Ct);
  T* yp = static_cast<T*>(y);
  if (lanes == 1)
    scan_kernel<T, 1, kVec><<<grid, kChannels, 0, s>>>(
        xp, dp, A, bp, cp, D, yp, h, L, Di, N);
  else
    scan_kernel<T, 2, kVec><<<grid, 2 * kChannels, 0, s>>>(
        xp, dp, A, bp, cp, D, yp, h, L, Di, N);
}

// the widest piece (16, 8 or 4 bytes) on which every tile row of x, dt and
// y starts; cudaErrorMisalignedAddress if none does (an odd bf16 Di, which
// the wrapper pads to a 16-byte row)
template <typename T>
cudaError_t launch_rows(int lanes, dim3 grid, cudaStream_t s, const void* x,
                        const void* dt, const float* A, const void* Bt,
                        const void* Ct, const float* D, void* y, float* h,
                        long long L, int Di, int N) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(dt) |
                         reinterpret_cast<uintptr_t>(y) |
                         static_cast<uintptr_t>(Di) * sizeof(T);
  if (bits % 16 == 0)
    launch<T, 16>(lanes, grid, s, x, dt, A, Bt, Ct, D, y, h, L, Di, N);
  else if (bits % 8 == 0)
    launch<T, 8>(lanes, grid, s, x, dt, A, Bt, Ct, D, y, h, L, Di, N);
  else if (bits % 4 == 0)
    launch<T, 4>(lanes, grid, s, x, dt, A, Bt, Ct, D, y, h, L, Di, N);
  else
    return cudaErrorMisalignedAddress;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 2 = bfloat16 (x, dt, Bt, Ct and y).  A (Di, N) and
// D (Di,) are f32; h_final (B, Di, N) f32.  All contiguous.
int mamba_scan_launch(int dtype, const void* x, const void* dt, const void* A,
                      const void* Bt, const void* Ct, const void* D, void* y,
                      void* h_final, int batch, long long L, int Di, int N,
                      void* stream) {
  if (batch <= 0 || Di <= 0) return static_cast<int>(cudaGetLastError());
  if (N <= 0 || N > kMaxN || batch > 65535 || L < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((Di + kChannels - 1) / kChannels, batch);
  const int lanes = N <= kSPL ? 1 : 2;
  const float* Ap = static_cast<const float*>(A);
  const float* Dp = static_cast<const float*>(D);
  float* hp = static_cast<float*>(h_final);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_rows<float>(
          lanes, grid, s, x, dt, Ap, Bt, Ct, Dp, y, hp, L, Di, N));
    case 2:
      return static_cast<int>(launch_rows<__nv_bfloat16>(
          lanes, grid, s, x, dt, Ap, Bt, Ct, Dp, y, hp, L, Di, N));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* mamba_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
