// Measurement probes for chip_smoke.py (sm_90a).  Not a kernel of the port:
// nothing in src/repro_torch calls them.
//
//   * probe_l2_read: reads an L2-resident buffer `reps` times in 16-byte
//     loads that bypass L1 (ld.global.cg), so that the smoke can state the
//     card's L2 read bandwidth beside K1's and K2's count of L2 sectors.
//   * probe_empty: launches a kernel that does nothing, over a given grid,
//     so that the smoke can time the launch floor a CUDA graph replay of a
//     small kernel cannot go below.
//
// C interface (bound with ctypes): each launcher returns cudaGetLastError()
// after its launch; the caller raises if it is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(256)
l2_read_kernel(const uint4* __restrict__ buf, int64_t n16, int reps,
               unsigned* __restrict__ out) {
  unsigned acc = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int rep = 0; rep < reps; ++rep) {
#pragma unroll 4
    for (int64_t i = first; i < n16; i += stride) {
      const uint4 v = __ldcg(buf + i);
      acc ^= v.x ^ v.y ^ v.z ^ v.w;
    }
  }
  if (acc == 0x9e3779b9u) atomicXor(out, acc);   // keeps the loads
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// Reads `bytes` (a multiple of 16) at `buf` `reps` times over `blocks`
// blocks of 256 threads; `out` is one unsigned int of scratch.
int probe_l2_read(const void* buf, long long bytes, int reps, void* out,
                  int blocks, void* stream) {
  l2_read_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(buf), bytes / 16, reps,
      static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel over `blocks` blocks of `threads` threads.
int probe_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
