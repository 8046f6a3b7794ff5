// Cayley-graph adjacency matvec for Hopper (sm_90a): kernel K2 of the port.
//
//   y[b, i] = sum_j x[b, table[i, j]]  +  loops[i] * x[b, i]
//
// unsigned, summed in f32 for f32 and bf16 inputs, written in x's dtype.
//
// Replaces the Pallas kernel `cayley_spmv` of
// src/repro/kernels/cayley_spmv/kernel.py (body `_spmv_kernel`), which kept
// all of x in VMEM and streamed the (n, k) table in row blocks, padding the
// last block with rows that gather index 0.
//
// Design (simple and right first):
//   * One thread per (b, row); ragged n is masked (row < n), not padded.
//   * The radix k is a template parameter for the radices the Cayley and
//     lift families use (3-8, 16, 32); other radices take a runtime loop in
//     chunks of 8 in the same kernel.  Every index of a chunk is loaded,
//     then every x value, then the values are added: the gathers of a row
//     are in flight together instead of one dependent load after another
//     (K1 at lps(61,5) measured 7.0 us against a 1.22 us bound, one wave of
//     dependent loads).
//   * The sum runs over j in table order from 0 and adds the loop term
//     last, the order of the Pallas body.
//   * x stays in the 50 MB L2, which plays the role VMEM played on the TPU;
//     each gather reads a 32-byte sector there.  Shared memory cannot take
//     that role: lps(61,5)'s x is 454 KB, above the 227 KB one block can
//     have, and a thread-block cluster that holds it whole in distributed
//     shared memory serves the gathers more slowly.  Random 4-byte loads
//     from the other blocks of a cluster run at 40-164 G/s over the card
//     (chip_smoke.py's dsmem_probe, C 16 to 2) against ~220 G sectors/s
//     from L2, and the copy of x into every cluster comes on top.
//     tools/k2_cluster.py times such a kernel (tools/k2_cluster.cu) beside
//     this one: slower or level on every single vector, slower on every
//     LPS table, faster only on batches over random-lift and random tables,
//     which no rule on the shapes tells apart from LPS tables (PERF.md).
//   * A batch of B vectors over the one table is the grid's y axis.
//
// Bound: device-memory bytes.  Per row it reads k int32 indices, k + 1
// x values and one loop weight and writes one y value, for k + 2 flops.  At
// lps(61,5), f32 with loops (n = 113,460, k = 6), one matvec moves
// (4 + 24 + 4 + 4) n = 4.08 MB: 1.22 us at 3.35 TB/s.
//
// C interface (bound with ctypes): cayley_spmv_launch returns
// cudaGetLastError() after the launch; the caller raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;       // gathers in flight per step of the runtime-k loop

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  unsigned short raw = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(raw));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// K > 0: compiled radix; K == 0: runtime radix k.
template <typename T, int K, bool LOOPS>
__global__ void __launch_bounds__(kThreads)
cayley_spmv_kernel(const T* __restrict__ x, const int32_t* __restrict__ table,
                   const float* __restrict__ loops, T* __restrict__ y,
                   int64_t n, int k) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= n) return;
  const T* xb = x + static_cast<int64_t>(blockIdx.y) * n;
  float acc = 0.0f;
  if (K > 0) {
    const int32_t* t = table + row * K;
    int32_t idx[K > 0 ? K : 1];
    float v[K > 0 ? K : 1];
#pragma unroll
    for (int j = 0; j < K; ++j) idx[j] = __ldg(t + j);
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = load_f32(xb + idx[j]);
#pragma unroll
    for (int j = 0; j < K; ++j) acc += v[j];
  } else {
    const int32_t* t = table + row * k;
    for (int j0 = 0; j0 < k; j0 += kChunk) {
      const int m = k - j0 < kChunk ? k - j0 : kChunk;
      int32_t idx[kChunk];
      float v[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (j < m) idx[j] = __ldg(t + j0 + j);
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (j < m) v[j] = load_f32(xb + idx[j]);
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (j < m) acc += v[j];
    }
  }
  if (LOOPS) acc += __ldg(loops + row) * load_f32(xb + row);
  store(y + static_cast<int64_t>(blockIdx.y) * n + row, acc);
}

template <typename T, int K>
void launch_k(const T* x, const int32_t* table, const float* loops, T* y,
              int64_t n, int k, dim3 grid, cudaStream_t stream) {
  if (loops)
    cayley_spmv_kernel<T, K, true><<<grid, kThreads, 0, stream>>>(
        x, table, loops, y, n, k);
  else
    cayley_spmv_kernel<T, K, false><<<grid, kThreads, 0, stream>>>(
        x, table, loops, y, n, k);
}

template <typename T>
void launch(const void* x, const void* table, const void* loops, void* y,
            int64_t n, int k, int batch, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  const T* xp = static_cast<const T*>(x);
  const int32_t* tp = static_cast<const int32_t*>(table);
  const float* lp = static_cast<const float*>(loops);
  T* yp = static_cast<T*>(y);
  switch (k) {
    case 3: launch_k<T, 3>(xp, tp, lp, yp, n, k, grid, stream); break;
    case 4: launch_k<T, 4>(xp, tp, lp, yp, n, k, grid, stream); break;
    case 5: launch_k<T, 5>(xp, tp, lp, yp, n, k, grid, stream); break;
    case 6: launch_k<T, 6>(xp, tp, lp, yp, n, k, grid, stream); break;
    case 7: launch_k<T, 7>(xp, tp, lp, yp, n, k, grid, stream); break;
    case 8: launch_k<T, 8>(xp, tp, lp, yp, n, k, grid, stream); break;
    case 16: launch_k<T, 16>(xp, tp, lp, yp, n, k, grid, stream); break;
    case 32: launch_k<T, 32>(xp, tp, lp, yp, n, k, grid, stream); break;
    default: launch_k<T, 0>(xp, tp, lp, yp, n, k, grid, stream); break;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 2 = bfloat16 (x and y, both (batch, n) contiguous).
// table: (n, k) int32, shared by the batch; loops: (n,) float32 or NULL.
int cayley_spmv_launch(int dtype, const void* x, const void* table,
                       const void* loops, void* y, long long n, int k,
                       int batch, void* stream) {
  if (n <= 0 || batch <= 0) return static_cast<int>(cudaGetLastError());
  if (k < 0 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<float>(x, table, loops, y, n, k, batch, s); break;
    case 2: launch<__nv_bfloat16>(x, table, loops, y, n, k, batch, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* cayley_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
