// Mamba-1 selective scan for Hopper (sm_90a): kernel K4 of the port.
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t      (per channel d,
//   y_t = sum_n C_t[n] * h_t[n] + D * x_t                     N states each)
//
// with h_0 = 0; writes y (B, L, Di) in x's dtype and the state after the
// last step, h_final (B, Di, N) in f32.
//
// Replaces the Pallas kernel `mamba_scan` of
// src/repro/kernels/mamba_scan/kernel.py (`_scan_kernel`).  Its grid
// (batch, d_inner block, time chunk) ran the time chunks in order, carrying
// h (block_d, N) in VMEM scratch, so it never materialised the
// (B, L, Di, N) tensor.  It did not return h; the model's prefill needs it
// for the decode cache, so this kernel also writes h_final.
//
// Design (simple and right first):
//   * One thread per (b, d) channel holds its N <= 16 states and its row of
//     A in registers, and loops over all L steps itself: the sequential grid
//     axis of the TPU becomes a loop inside the thread.  A block is 128
//     channels of one batch row.
//   * Time goes in chunks of 32 steps.  Per chunk the block stages, with one
//     coalesced load per element, the chunk's x and dt columns of its 128
//     channels and the B_t, C_t rows (shared by all channels) in shared
//     memory as f32, so the step loop waits on no device-memory load.
//   * Each step computes, in f32 and in the Pallas body's order,
//     a = exp(dt * A[n]), h = a * h + (dt * x) * B_t[n], y = sum_n h * C_t[n]
//     + D * x, and writes y at once.  Ragged L needs no padding (the Pallas
//     kernel padded L with dt = 0 steps, which leave h unchanged); ragged
//     Di is masked.
//
// Bound: device-memory bytes, by the table of peak rates this repository
// uses (3.35 TB/s; 67 TFLOP/s f32).  At the serving path's prefill shape
// (B 4, L 1024, Di 8192, N 16, bf16) it reads x and dt and writes y
// (67 MB each), reads B_t and C_t (0.26 MB) and writes h_final (2.1 MB):
// 204 MB, 61 us; its ~6 f32 operations per (b, t, d, n) are 3.2 GFLOP,
// 48 us.  The 537 M exponentials it takes go to the special-function units
// (16 per SM per clock): ~0.13 ms at 1.98 GHz, a limit outside that table.
// With 32 K channels (256 blocks of 128 threads, about two per SM), each
// thread's 1024 dependent steps make it latency-bound: expect a multiple of
// either bound.
//
// C interface (bound with ctypes): mamba_scan_launch returns
// cudaGetLastError() after the launch; the caller raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;    // channels per block
constexpr int kChunk = 32;       // time steps staged per chunk
constexpr int kMaxN = 16;        // states per channel

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
            const float* __restrict__ A, const T* __restrict__ Bt,
            const T* __restrict__ Ct, const float* __restrict__ Dw,
            T* __restrict__ y, float* __restrict__ h_final, int64_t L, int Di,
            int N) {
  __shared__ float xs[kChunk][kThreads];
  __shared__ float ds[kChunk][kThreads];
  __shared__ float bs[kChunk][kMaxN];
  __shared__ float cs[kChunk][kMaxN];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kThreads;
  const int d = d0 + threadIdx.x;
  const bool active = d < Di;

  float a[kMaxN], h[kMaxN];
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    a[n] = (active && n < N) ? A[static_cast<int64_t>(d) * N + n] : 0.f;
    h[n] = 0.f;
  }
  const float dd = active ? Dw[d] : 0.f;
  const int64_t row0 = static_cast<int64_t>(b) * L;

  for (int64_t t0 = 0; t0 < L; t0 += kChunk) {
    const int tc = static_cast<int>(min(static_cast<int64_t>(kChunk), L - t0));
    __syncthreads();                  // the last chunk's staging is consumed
    for (int t = 0; t < tc; ++t) {
      const int64_t idx = (row0 + t0 + t) * Di + d;
      xs[t][threadIdx.x] = active ? to_f32(x[idx]) : 0.f;
      ds[t][threadIdx.x] = active ? to_f32(dt[idx]) : 0.f;
    }
    for (int i = threadIdx.x; i < tc * N; i += kThreads) {
      const int t = i / N, n = i % N;
      const int64_t idx = (row0 + t0 + t) * N + n;
      bs[t][n] = to_f32(Bt[idx]);
      cs[t][n] = to_f32(Ct[idx]);
    }
    __syncthreads();
    if (!active) continue;
    for (int t = 0; t < tc; ++t) {
      const float xv = xs[t][threadIdx.x];
      const float dv = ds[t][threadIdx.x];
      const float dx = dv * xv;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) {
        if (n < N) {
          h[n] = expf(dv * a[n]) * h[n] + dx * bs[t][n];
          acc += h[n] * cs[t][n];
        }
      }
      y[(row0 + t0 + t) * Di + d] = from_f32<T>(acc + dd * xv);
    }
  }
  if (active) {
#pragma unroll
    for (int n = 0; n < kMaxN; ++n)
      if (n < N) h_final[(static_cast<int64_t>(b) * Di + d) * N + n] = h[n];
  }
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
  const dim3 grid((Di + kThreads - 1) / kThreads, batch);
  const float* Ap = static_cast<const float*>(A);
  const float* Dp = static_cast<const float*>(D);
  float* hp = static_cast<float*>(h_final);
  switch (dtype) {
    case 0:
      scan_kernel<float><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(dt), Ap,
          static_cast<const float*>(Bt), static_cast<const float*>(Ct), Dp,
          static_cast<float*>(y), hp, L, Di, N);
      break;
    case 2:
      scan_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const __nv_bfloat16*>(dt), Ap,
          static_cast<const __nv_bfloat16*>(Bt),
          static_cast<const __nv_bfloat16*>(Ct), Dp,
          static_cast<__nv_bfloat16*>(y), hp, L, Di, N);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* mamba_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
