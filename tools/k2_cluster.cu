// A Cayley-graph adjacency matvec that holds x in a thread-block cluster's
// distributed shared memory (sm_90a): the design tried as kernel K2's
// redesign, kept as a measurement beside K2 (tools/k2_cluster.py), not as a
// kernel of the port.
//
//   y[b, i] = sum_j x[b, table[i, j]]  +  loops[i] * x[b, i]
//
// with K2's operands and K2's arithmetic (src/repro_torch/kernels/csrc/
// cayley_spmv.cu): f32 and bf16 summed in f32 in table order from 0.0f, the
// loop term last as one fused multiply-add, so f32 results equal K2's and
// K1's bit for bit.
//
// Layout.  A persistent grid of clusters of C blocks (C <= 16; 16 with the
// non-portable cluster size) holds x whole in the cluster's distributed
// shared memory: block r of a cluster holds elements [r 2^s, (r + 1) 2^s)
// (all n where C = 1), so a gathered index's owner is idx >> s and its
// offset idx & (2^s - 1).  A batch (B, n) over the one table is staged
// interleaved, row i holding the P values x[g P .. g P + P - 1, i] of a
// group g of P vectors (P * elem <= 16 bytes), so that one gathered
// neighbour brings its P values in one ld.shared::cluster.v{2,4}; B > P runs
// the groups one after another.
//
// Copy.  One vector's slice (P = 1) is copied by cp.async.bulk in pieces of
// 32 KB completing on an mbarrier, the ragged tail by the threads; an
// interleaved group is copied by the threads, 16 element loads in flight
// each.  Each thread loads its first row's indices, loop weight and x values
// before the copy, so those device-memory reads overlap it.
//
// Gathers.  After a cluster barrier each thread computes whole rows: it
// prefetches the next row's indices (a runtime radix: the next chunk of 8),
// maps each index to its owner's shared memory (mapa.shared::cluster) and
// issues all of a row's (or chunk's) ld.shared::cluster loads before it adds
// any of them.  A second cluster barrier keeps every block alive until its
// peers have finished reading its shared memory.  The grid is
// min(cudaOccupancyMaxActiveClusters, SMs / C, the clusters the rows need).
//
// C interface (bound with ctypes by tools/k2_cluster.py):
// k2_cluster_launch returns the launch's error or cudaGetLastError(); a
// configuration the card cannot schedule (cudaOccupancyMaxActiveClusters
// == 0) is cudaErrorInvalidConfiguration.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kChunk = 8;         // gathers in flight per step of a runtime-k loop
constexpr int kStageUnroll = 16;  // x loads in flight per thread (interleaved copy)
constexpr uint32_t kBulkBytes = 32768;  // bytes a bulk copy
constexpr int kBarrierBytes = 16;       // the mbarrier, before x
constexpr int kMaxThreads = 512;        // threads a block, at most

__device__ __forceinline__ float widen(uint32_t w) { return __uint_as_float(w); }
__device__ __forceinline__ float widen(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);   // bf16 -> f32, exact
}
__device__ __forceinline__ void narrow(uint32_t* p, float v) { *p = __float_as_uint(v); }
__device__ __forceinline__ void narrow(uint16_t* p, float v) {
  *p = __bfloat16_as_ushort(__float2bfloat16(v));
}

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_nctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_index() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster: writes to shared memory before
// it are visible to the whole cluster's reads after it.  Not `.aligned`: the
// threads of a warp may arrive from row loops of different lengths.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;" ::: "memory");
}

// The shared::cluster address of shared::cta address `local` in block `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t local, uint32_t rank) {
  uint32_t remote;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

// One gathered row of P values (P * sizeof(raw) bytes, aligned to its size)
// from distributed shared memory, widened to f32.
template <typename R, int P>
__device__ __forceinline__ void gather_row(uint32_t addr, float (&v)[P]) {
  if constexpr (sizeof(R) == 4) {
    if constexpr (P == 1) {
      asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v[0]) : "r"(addr) : "memory");
    } else if constexpr (P == 2) {
      asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];"
                   : "=f"(v[0]), "=f"(v[1]) : "r"(addr) : "memory");
    } else {
      static_assert(P == 4, "f32 rows of 1, 2 or 4 values");
      asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
                   : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
                   : "r"(addr) : "memory");
    }
  } else {
    if constexpr (P == 1) {
      unsigned short h;
      asm volatile("ld.shared::cluster.u16 %0, [%1];" : "=h"(h) : "r"(addr) : "memory");
      v[0] = widen(static_cast<uint16_t>(h));
    } else {
      constexpr int W = P / 2;          // 32-bit words: two bf16 values each
      uint32_t w[W];
      if constexpr (W == 1) {
        asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(w[0]) : "r"(addr) : "memory");
      } else if constexpr (W == 2) {
        asm volatile("ld.shared::cluster.v2.u32 {%0, %1}, [%2];"
                     : "=r"(w[0]), "=r"(w[1]) : "r"(addr) : "memory");
      } else {
        static_assert(W == 4, "bf16 rows of 1, 2, 4 or 8 values");
        asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];"
                     : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
                     : "r"(addr) : "memory");
      }
#pragma unroll
      for (int q = 0; q < W; ++q) {
        v[2 * q] = __uint_as_float(w[q] << 16);          // low half: lower index
        v[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
      }
    }
  }
}

// Copy this block's slice of group g into shared memory, interleaved: entry
// e = i P + p holds x[g P + p, base + i], zero beyond n or B.  Each thread
// has kStageUnroll loads in flight before it stores any of them.
template <typename R, int P>
__device__ __forceinline__ void stage_slice(R* sm, const R* __restrict__ x,
                                            int64_t n, int B, int g,
                                            int64_t base, int total) {
  for (int e0 = threadIdx.x; e0 < total; e0 += kStageUnroll * blockDim.x) {
    R v[kStageUnroll];
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int e = e0 + u * static_cast<int>(blockDim.x);
      const int i = e / P, p = e % P;
      const int b = g * P + p;
      const int64_t gi = base + i;
      v[u] = (e < total && b < B && gi < n)
                 ? __ldg(x + static_cast<int64_t>(b) * n + gi) : R(0);
    }
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int e = e0 + u * static_cast<int>(blockDim.x);
      if (e < total) sm[e] = v[u];
    }
  }
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               "fence.mbarrier_init.release.cluster;" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One vector's slice, contiguous in x and in shared memory: thread 0 asks the
// copy engine for its 16-byte-aligned body in pieces of kBulkBytes
// (cp.async.bulk, completing on the block's mbarrier) while the block's
// threads load the rest (the tail, or all of it where the slice does not
// start on 16 bytes), then every thread waits for the body.
template <typename R>
__device__ __forceinline__ void stage_bulk(R* sm, uint32_t bar, uint32_t parity,
                                           const R* __restrict__ x, int64_t n,
                                           int64_t base, int rows) {
  const int valid = static_cast<int>(n - base < rows ? (n > base ? n - base : 0)
                                                     : rows);
  const R* src = x + base;
  const bool aligned = reinterpret_cast<uintptr_t>(src) % 16 == 0;
  const uint32_t body =
      aligned ? (static_cast<uint32_t>(valid) * sizeof(R)) & ~15u : 0u;
  if (threadIdx.x == 0) {
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(sm));
    // the previous group's generic reads of this memory come first
    asm volatile("fence.proxy.async.shared::cta;\n"
                 "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(body) : "memory");
    for (uint32_t off = 0; off < body; off += kBulkBytes) {
      const uint32_t len = body - off < kBulkBytes ? body - off : kBulkBytes;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];"
          :: "r"(dst + off), "l"(reinterpret_cast<const char*>(src) + off),
             "r"(len), "r"(bar) : "memory");
    }
  }
  const int head = static_cast<int>(body / sizeof(R));
  stage_slice<R, 1>(sm + head, x, n, 1, 0, base + head, valid - head);
  mbar_wait(bar, parity);
}

// A row's operands from device memory: its K indices (compiled radix only),
// its loop weight and its P x values (for the loop term).
template <typename R, int K, int P>
struct RowOperands {
  int32_t idx[K > 0 ? K : 1];
  float lw;
  float xi[P];
};

template <typename R, int K, int P>
__device__ __forceinline__ void load_row(RowOperands<R, K, P>& o, int64_t row,
                                         const R* __restrict__ x,
                                         const int32_t* __restrict__ table,
                                         const float* __restrict__ loops,
                                         int64_t n, int B, int g) {
  if constexpr (K > 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) o.idx[j] = __ldg(table + row * K + j);
  }
  o.lw = 0.0f;
  if (loops) {
    o.lw = __ldg(loops + row);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int b = g * P + p;
      o.xi[p] = b < B ? widen(__ldg(x + static_cast<int64_t>(b) * n + row)) : 0.0f;
    }
  }
}

// Gather M indices' rows (M <= kChunk or K), then add them in index order.
template <typename R, int P, int M>
__device__ __forceinline__ void gather_add(const int32_t* idx, int m,
                                           uint32_t local, int s, uint32_t mask,
                                           float (&acc)[P]) {
  constexpr uint32_t kRowBytes = P * sizeof(R);
  float v[M][P];
#pragma unroll
  for (int j = 0; j < M; ++j)
    if (j < m) {
      const uint32_t id = static_cast<uint32_t>(idx[j]);
      gather_row<R, P>(map_rank(local + (id & mask) * kRowBytes, id >> s), v[j]);
    }
#pragma unroll
  for (int j = 0; j < M; ++j)
    if (j < m) {
#pragma unroll
      for (int p = 0; p < P; ++p) acc[p] += v[j][p];
    }
}

// K > 0: compiled radix; K == 0: runtime radix k.  Grid: clusters of C
// blocks along x; each cluster takes rows [cluster * share, + share).
// Dynamic shared memory: the mbarrier of the bulk copy (kBarrierBytes), then
// the slice.
template <typename R, int P, int K>
__global__ void __launch_bounds__(kMaxThreads, 1)
cayley_cluster_kernel(const R* __restrict__ x, const int32_t* __restrict__ table,
                      const float* __restrict__ loops, R* __restrict__ y,
                      int64_t n, int k, int B, int s, int rows,
                      int64_t share) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  R* sm = reinterpret_cast<R*>(smem_raw + kBarrierBytes);
  const uint32_t bar = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t rank = cluster_ctarank();
  const int64_t C = cluster_nctarank();
  const uint32_t local = static_cast<uint32_t>(__cvta_generic_to_shared(sm));
  const uint32_t mask = (1u << s) - 1u;
  const int64_t r0 = static_cast<int64_t>(cluster_index()) * share;
  const int64_t r1 = r0 + share < n ? r0 + share : n;
  const int64_t first = r0 + static_cast<int64_t>(rank) * blockDim.x + threadIdx.x;
  const int64_t stride = C * blockDim.x;
  const int groups = (B + P - 1) / P;
  if constexpr (P == 1) {
    if (threadIdx.x == 0) mbar_init(bar);
    __syncthreads();
  }
  for (int g = 0; g < groups; ++g) {
    int64_t row = first;
    RowOperands<R, K, P> cur;
    if (row < r1) load_row<R, K, P>(cur, row, x, table, loops, n, B, g);
    const int64_t base = static_cast<int64_t>(rank) << s;
    if constexpr (P == 1)
      stage_bulk<R>(sm, bar, g & 1, x + static_cast<int64_t>(g) * n, n, base, rows);
    else
      stage_slice<R, P>(sm, x, n, B, g, base, P * rows);
    cluster_sync();
    while (row < r1) {
      const int64_t next = row + stride;
      RowOperands<R, K, P> nxt;
      if (next < r1) load_row<R, K, P>(nxt, next, x, table, loops, n, B, g);
      float acc[P];
#pragma unroll
      for (int p = 0; p < P; ++p) acc[p] = 0.0f;
      if constexpr (K > 0) {
        gather_add<R, P, K>(cur.idx, K, local, s, mask, acc);
      } else {
        // the next chunk's indices load while this chunk's values gather
        const int32_t* t = table + row * k;
        int32_t idx[kChunk], ahead[kChunk];
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          if (j < k) idx[j] = __ldg(t + j);
        for (int j0 = 0; j0 < k; j0 += kChunk) {
          const int m = k - j0 < kChunk ? k - j0 : kChunk;
          const int m2 = k - j0 - kChunk < kChunk ? k - j0 - kChunk : kChunk;
#pragma unroll
          for (int j = 0; j < kChunk; ++j)
            if (j < m2) ahead[j] = __ldg(t + j0 + kChunk + j);
          gather_add<R, P, kChunk>(idx, m, local, s, mask, acc);
#pragma unroll
          for (int j = 0; j < kChunk; ++j) idx[j] = ahead[j];
        }
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int b = g * P + p;
        if (b < B) {
          if (loops) acc[p] = __fmaf_rn(cur.lw, cur.xi[p], acc[p]);
          narrow(y + static_cast<int64_t>(b) * n + row, acc[p]);
        }
      }
      cur = nxt;
      row = next;
    }
    cluster_sync();   // no block leaves, or restages, while a peer reads it
  }
}

template <typename R_, int P_, int K_>
struct Inst {
  using R = R_;
  static constexpr int P = P_, K = K_;
};

// f(Inst<R, P, K>{}) for the instantiation a (dtype, group, k) needs; returns
// cudaErrorInvalidValue for a combination that has none.
template <typename R, int P, typename F>
int with_radix(int k, F&& f) {
  switch (k) {
    case 3: return f(Inst<R, P, 3>{});
    case 4: return f(Inst<R, P, 4>{});
    case 5: return f(Inst<R, P, 5>{});
    case 6: return f(Inst<R, P, 6>{});
    case 7: return f(Inst<R, P, 7>{});
    case 8: return f(Inst<R, P, 8>{});
    default: return f(Inst<R, P, 0>{});
  }
}

template <typename F>
int with_instance(int dtype, int group, int k, F&& f) {
  if (dtype == 0) {
    switch (group) {
      case 1: return with_radix<uint32_t, 1>(k, f);
      case 2: return with_radix<uint32_t, 2>(k, f);
      case 4: return with_radix<uint32_t, 4>(k, f);
    }
  } else if (dtype == 2) {
    switch (group) {
      case 1: return with_radix<uint16_t, 1>(k, f);
      case 2: return with_radix<uint16_t, 2>(k, f);
      case 4: return with_radix<uint16_t, 4>(k, f);
      case 8: return with_radix<uint16_t, 8>(k, f);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The largest dynamic shared memory set so far on each kernel, and each
// (kernel, device, threads, cluster, bytes)'s cudaOccupancyMaxActiveClusters.
std::mutex g_mu;
std::map<const void*, size_t> g_smem_set;
std::map<std::tuple<const void*, int, int, int, size_t>, int> g_active;

// Sets the kernel's attributes for this configuration (once) and stores the
// number of clusters the card can hold at once in *active.
template <typename Fn>
int cluster_occupancy(Fn fn, int threads, int cluster, size_t smem, int* active) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const void* key = reinterpret_cast<const void*>(fn);
  std::lock_guard<std::mutex> lock(g_mu);
  auto hit = g_active.find(std::make_tuple(key, dev, threads, cluster, smem));
  if (hit != g_active.end()) {
    *active = hit->second;
    return 0;
  }
  size_t& set = g_smem_set[key];
  if (smem > set) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    set = smem;
  }
  if (cluster > 8) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int count = 0;
  e = cudaOccupancyMaxActiveClusters(&count, fn, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  g_active[std::make_tuple(key, dev, threads, cluster, smem)] = count;
  *active = count;
  return 0;
}

// The grid: clusters the card holds at once, at most one block an SM, and no
// more than the rows need.
int cluster_grid(int active, int cluster, int threads, int64_t n) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t need = (n + static_cast<int64_t>(cluster) * threads - 1) /
                       (static_cast<int64_t>(cluster) * threads);
  return static_cast<int>(std::min<int64_t>(
      std::min<int64_t>(active, std::max(1, sms / cluster)), need));
}

// A block's slice: 2^slice_shift rows, or all n where one block holds x.
long long slice_rows(int slice_shift, long long n) {
  return std::min(1LL << slice_shift, n);
}

bool cluster_args_ok(int cluster, int slice_shift, int group, long long n,
                     int elem, int threads) {
  if (cluster < 1 || cluster > 16 || (cluster & (cluster - 1)) != 0) return false;
  if (slice_shift < 0 || slice_shift > 20) return false;
  if ((static_cast<long long>(cluster) << slice_shift) < n) return false;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0) return false;
  return kBarrierBytes + static_cast<long long>(group) * elem *
                             slice_rows(slice_shift, n) <= 232448;
}

}  // namespace

extern "C" {

// The cluster kernel for a layout (clusters of `cluster` blocks of `threads`
// threads, each block holding 2^slice_shift rows of `group` values), on K2's
// operands: dtype 0 = float32, 2 = bfloat16 (x and y (batch, n)
// contiguous); table (n, k) int32; loops (n,) float32 or NULL.  *active gets
// cudaOccupancyMaxActiveClusters, *grid the clusters launched.
int k2_cluster_launch(int dtype, const void* x, const void* table,
                      const void* loops, void* y, long long n, int k, int batch,
                      int cluster, int slice_shift, int group, int threads,
                      void* stream, int* active, int* grid) {
  if (n <= 0 || batch <= 0) return static_cast<int>(cudaGetLastError());
  const int elem = dtype == 0 ? 4 : 2;
  return with_instance(dtype, group, k, [&](auto inst) -> int {
    using I = decltype(inst);
    using R = typename I::R;
    auto fn = cayley_cluster_kernel<R, I::P, I::K>;
    if (k < 0 || !cluster_args_ok(cluster, slice_shift, group, n, elem, threads))
      return static_cast<int>(cudaErrorInvalidValue);
    const int rows = static_cast<int>(slice_rows(slice_shift, n));
    const size_t smem = kBarrierBytes + static_cast<size_t>(I::P) * sizeof(R) * rows;
    int rc = cluster_occupancy(fn, threads, cluster, smem, active);
    if (rc != 0) return rc;
    if (*active <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    *grid = cluster_grid(*active, cluster, threads, n);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(*grid * cluster));
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const int64_t share = (n + *grid - 1) / *grid;
    cudaError_t e = cudaLaunchKernelEx(
        &cfg, fn, static_cast<const R*>(x), static_cast<const int32_t*>(table),
        static_cast<const float*>(loops), static_cast<R*>(y),
        static_cast<int64_t>(n), k, batch, slice_shift, rows, share);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  });
}

const char* k2_cluster_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
