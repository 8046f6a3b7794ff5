// Measurement probes for chip_smoke.py (sm_90a).  Not a kernel of the port:
// nothing in src/repro_torch calls them.
//
//   * probe_l2_read: reads an L2-resident buffer `reps` times in 16-byte
//     loads that bypass L1 (ld.global.cg), so that the smoke can state the
//     card's L2 read bandwidth beside K1's and K2's count of L2 sectors.
//   * probe_empty: launches a kernel that does nothing, over a given grid,
//     so that the smoke can time the launch floor a CUDA graph replay of a
//     small kernel cannot go below.
//   * probe_dsmem_gather: 4-byte ld.shared::cluster loads across a
//     thread-block cluster of C blocks, each holding 2^log_words words of
//     shared memory, so that the smoke can state the rate at which a
//     cluster's distributed shared memory would serve K2's gathers (a
//     diagnostic beside K2's row, never part of a bound): every lane at a
//     random word (K2's pattern), or, for contrast, a warp's 32 lanes on
//     the 32 words of one random 128-byte line.  The grid is as
//     tools/k2_cluster.cu sizes its own: at most one block an SM, no more
//     clusters than the card holds at once.
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

constexpr int kGathers = 8;   // gathers in flight per thread, as K2 issues a row

__global__ void __launch_bounds__(1024, 1)
dsmem_gather_kernel(int log_words, int cluster_log, int rounds, int lines,
                    unsigned* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t words[];
  const int n = 1 << log_words;
  for (int i = threadIdx.x; i < n; i += blockDim.x) words[i] = i * 2654435761u;
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;" ::: "memory");
  const uint32_t local = static_cast<uint32_t>(__cvta_generic_to_shared(words));
  const int bits = log_words + cluster_log;
  const uint32_t mask = (1u << log_words) - 1u;
  uint32_t h = (blockIdx.x * blockDim.x + threadIdx.x) * 0x9e3779b9u + rank;
  uint32_t acc = 0;
  for (int r = 0; r < rounds; ++r) {
    uint32_t v[kGathers];
#pragma unroll
    for (int u = 0; u < kGathers; ++u) {
      h = h * 1664525u + 1013904223u;
      uint32_t idx = bits > 0 ? h >> (32 - bits) : 0u;
      if (lines)   // lane 0's line, each lane its own word of it
        idx = (__shfl_sync(0xffffffffu, idx, 0) & ~31u) | (threadIdx.x & 31u);
      uint32_t addr;
      asm("mapa.shared::cluster.u32 %0, %1, %2;"
          : "=r"(addr) : "r"(local + (idx & mask) * 4u), "r"(idx >> log_words));
      asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v[u]) : "r"(addr) : "memory");
    }
#pragma unroll
    for (int u = 0; u < kGathers; ++u) acc += v[u];
  }
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;" ::: "memory");
  if (acc == 0x9e3779b9u) atomicXor(out, acc);   // keeps the loads
}

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

// `rounds` x 8 4-byte gathers a thread over clusters of `cluster` blocks
// (1, 2, 4, 8 or 16) of `threads` threads (a multiple of 32), each block
// holding 2^log_words words (log_words >= 5): at random words, or with
// `lines` on whole random 128-byte lines a warp; *blocks gets the blocks
// launched, *active cudaOccupancyMaxActiveClusters.  `out` is one unsigned
// int of scratch.
int probe_dsmem_gather(int cluster, int log_words, int threads, int rounds,
                       int lines, void* out, void* stream, int* blocks,
                       int* active) {
  int cluster_log = 0;
  while ((1 << cluster_log) < cluster) ++cluster_log;
  if ((1 << cluster_log) != cluster || cluster > 16 || threads > 1024 ||
      threads % 32 != 0 || log_words < 5)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(uint32_t) << log_words;
  cudaError_t e = cudaFuncSetAttribute(
      dsmem_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute(dsmem_gather_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(active, dsmem_gather_kernel, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (*active <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int clusters = *active < sms / cluster ? *active : sms / cluster;
  *blocks = clusters * cluster;
  cfg.gridDim = dim3(*blocks);
  e = cudaLaunchKernelEx(&cfg, dsmem_gather_kernel, log_words, cluster_log,
                         rounds, lines, static_cast<unsigned*>(out));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

const char* probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
