// Padded gather-table spmv for Hopper (sm_90a): kernel K1 of the port.
//
//   y[b, i] = sum_j s[b, i, j] * x[b, table[b, i, j]]  +  loops[b, i] * x[b, i]
//
// Replaces the Pallas kernel `spmv_padded` of src/repro/kernels/spmv.py
// (both bodies: `_plain_kernel`, no signs, and `_signed_kernel`, per-slot
// signs).  The Pallas version kept all of x in VMEM and streamed the (n, k)
// table in row blocks; its grid ran in order on one core.
//
// Design (simple and right first):
//   * One thread per (b, row).  The k gathers go through the read-only data
//     path (__ldg).  The sum runs over j in table order and adds the loop
//     term last, the order of the Pallas bodies.
//   * x is NOT staged in shared memory: at the main path's shapes it is
//     454 KB (lps(61,5), n = 113,460, f32), above the 227 KB one block can
//     have.  It stays resident in the 50 MB L2 instead, which plays the role
//     VMEM played on the TPU.
//   * Ragged n is masked (row < n), not padded.  A batch dimension is the
//     grid's y axis; an operand shared across the batch has batch stride 0.
//   * Accumulation is f32 for f32 and bf16 inputs (bf16 converted with
//     __bfloat162float / __float2bfloat16) and f64 for f64 inputs; loops and
//     signs arrive already in the accumulation type.
//
// Bound: device-memory bytes.  Per row it reads k int32 indices, k + 1
// x values, one loop weight (and k signs) and writes one y value, for 2k + 3
// flops.  At lps(61,5), f32 with loops, one matvec moves 4.08 MB (table
// 2.72 MB; x, loops, y 0.45 MB each): 1.22 us at 3.35 TB/s.  At
// hypercube(16) (k = 16) it moves 4.98 MB: 1.49 us.  The table read is
// strided by k between neighbouring threads of a warp, so each warp touches
// k times the cache lines a coalesced read would in one instruction; a
// warp-per-row or a transposed (k, n) table layout is later work.
//
// C interface (bound with ctypes): spmv_padded_launch returns
// cudaGetLastError() after the launch; the caller raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_acc(const float* p) { return __ldg(p); }
__device__ __forceinline__ double load_acc(const double* p) { return __ldg(p); }
__device__ __forceinline__ float load_acc(const __nv_bfloat16* p) {
  unsigned short raw = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(raw));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, typename A, bool SIGNED, bool LOOPS>
__global__ void __launch_bounds__(kThreads)
spmv_kernel(const T* __restrict__ x, const int32_t* __restrict__ table,
            const A* __restrict__ loops, const A* __restrict__ signs,
            T* __restrict__ y, int64_t n, int k, int64_t x_bstride,
            int64_t tab_bstride, int64_t loop_bstride, int64_t sign_bstride) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= n) return;
  const int64_t b = blockIdx.y;
  const T* xb = x + b * x_bstride;
  const int32_t* t = table + b * tab_bstride + row * k;
  A acc = A(0);
  if (SIGNED) {
    const A* s = signs + b * sign_bstride + row * k;
    for (int j = 0; j < k; ++j) acc += __ldg(s + j) * load_acc(xb + __ldg(t + j));
  } else {
    for (int j = 0; j < k; ++j) acc += load_acc(xb + __ldg(t + j));
  }
  if (LOOPS) acc += __ldg(loops + b * loop_bstride + row) * load_acc(xb + row);
  store(y + b * n + row, acc);
}

template <typename T, typename A>
void launch(const void* x, const void* table, const void* loops,
            const void* signs, void* y, int64_t n, int k, int batch,
            int64_t x_bstride, int64_t tab_bstride, int64_t loop_bstride,
            int64_t sign_bstride, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  const T* xp = static_cast<const T*>(x);
  const int32_t* tp = static_cast<const int32_t*>(table);
  const A* lp = static_cast<const A*>(loops);
  const A* sp = static_cast<const A*>(signs);
  T* yp = static_cast<T*>(y);
#define SPMV_LAUNCH(S, L)                                                   \
  spmv_kernel<T, A, S, L><<<grid, kThreads, 0, stream>>>(                   \
      xp, tp, lp, sp, yp, n, k, x_bstride, tab_bstride, loop_bstride,       \
      sign_bstride)
  if (signs && loops) SPMV_LAUNCH(true, true);
  else if (signs) SPMV_LAUNCH(true, false);
  else if (loops) SPMV_LAUNCH(false, true);
  else SPMV_LAUNCH(false, false);
#undef SPMV_LAUNCH
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64, 2 = bfloat16 (x and y).  loops / signs
// may be NULL; when given they hold the accumulation type (f64 for f64,
// else f32).  A batch stride of 0 shares that operand across the batch.
int spmv_padded_launch(int dtype, const void* x, const void* table,
                       const void* loops, const void* signs, void* y,
                       long long n, int k, int batch, long long x_bstride,
                       long long tab_bstride, long long loop_bstride,
                       long long sign_bstride, void* stream) {
  if (n <= 0 || batch <= 0) return static_cast<int>(cudaGetLastError());
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch<float, float>(x, table, loops, signs, y, n, k, batch, x_bstride,
                           tab_bstride, loop_bstride, sign_bstride, s);
      break;
    case 1:
      launch<double, double>(x, table, loops, signs, y, n, k, batch, x_bstride,
                             tab_bstride, loop_bstride, sign_bstride, s);
      break;
    case 2:
      launch<__nv_bfloat16, float>(x, table, loops, signs, y, n, k, batch,
                                   x_bstride, tab_bstride, loop_bstride,
                                   sign_bstride, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
