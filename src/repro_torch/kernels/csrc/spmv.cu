// Padded gather-table spmv for Hopper (sm_90a): kernel K1 of the port.
//
//   y[b, i] = sum_j s[b, i, j] * x[b, table[b, i, j]]  +  loops[b, i] * x[b, i]
//
// Replaces the Pallas kernel `spmv_padded` of src/repro/kernels/spmv.py
// (both bodies: `_plain_kernel`, no signs, and `_signed_kernel`, per-slot
// signs).  The Pallas version kept all of x in VMEM and streamed the (n, k)
// table in row blocks; its grid ran in order on one core and had no batch
// (the reference batches by vmap).
//
// What bounds it.  Signs, table, loops, x and y stream once from device
// memory: that is the bound chip_smoke.py states, and the lift search's
// per-b signs (50 MB a call at (24, 16384, 32)) make those forms
// device-memory bound.  Each gathered value is a random read that moves a
// whole 32-byte L2 sector unless L1 holds it, so the gathers move up to
// n k sectors for one vector (lps(61,5), k = 6: 21.8 MB of L2 reads
// against 4.08 MB of device memory) and, for B vectors over one table,
// n k ceil(B elem / 32) sectors where a neighbour's B values lie side by
// side.  The smoke reports that sector count's time at the L2 read
// bandwidth it measures beside the bound, not in it: hypercube's low-bit
// neighbours share sectors in L1 and read faster.
//
// Two paths, chosen by the wrapper (kernels/spmv.py):
//
//   * Batch path: x (B, n) over one shared (n, k) table, B >= 2.  An
//     interleave kernel first copies x into xT (n, P)
//     (P >= B: a row padded to a power of two below 32 bytes, else to whole
//     sectors, so that a row never straddles more sectors than its values
//     need; scratch the wrapper allocates on every call).  The batch kernel
//     then gives a block R rows for a chunk of bc <= 256 batch entries;
//     lane (r, b) is thread r * bc + b, so one warp request brings a
//     neighbour's bc values in ceil(bc elem / 32) sectors instead of bc.
//     The block stages its table tile (and signs, (n, k) or per-b, and
//     per-b loops) into shared memory with cp.async: rows padded to
//     sr = bc (mod 32) and b-blocks to sb = 1 (mod 32), so that lane t
//     reads bank t + j.  The first 8 gathers are issued before the signs
//     are waited for.  y goes back to (B, n) through shared memory, R
//     contiguous values per b.  Per-b f32 signs with k a multiple of 32
//     (the lift search) take spmv_batch_signed_kernel: 16-byte copies into
//     rotated rows, 16-byte reads.
//   * Row path: x (n,), x (B, n) over a (B, n, k) table stack, and a
//     shared-table batch the batch path cannot plan.  One thread per
//     (b, row), b on grid.y; the
//     block copies its contiguous (rows, k) table tile (and f32 signs) into
//     shared memory with 16-byte cp.async copies (rows padded by 4 entries
//     where k is a multiple of 8, so 16-byte reads do not collide), then
//     each thread issues its row's k gathers back to back (k compiled for
//     3-8, 16, 32; other radices in chunks of 8) before it sums.  Loops,
//     x[i] and y are coalesced.  A tile that does not fit the 48 KB budget
//     at 32 rows (k above ~180) is read from device memory directly.
//
// Arithmetic order, the same on both paths and in K2 (cayley_spmv.cu):
// each output starts from 0, adds its slots one after another in table
// order j = 0..k-1 in the accumulation type (f32 for f32 and bf16, f64 for
// f64), and adds loops[i] * x[i] last.  Lanes never run across slots: the
// lift search's argmin over f32 scores (its best two differ by 3.4e-5 at
// one level) sees the same bits as from the first kernel, f32 equals K2 bit
// for bit, and signed f32 (exact +-1 products) equals a sequential sum.
//
// Small B.  chip_smoke.py's k1_interleave_threshold phase times both paths
// (NVIDIA H100 80GB HBM3, 700 W): the batch path is faster from B = 2 on
// lps(61,5) (9.4 against 10.0 us at B = 2, 10.8 against 16.9 at B = 4) and
// on per-b signs (9.5 against 12.9 at B = 2), slower on hypercube(16) up to
// B = 8 (7.2 against 4.5 at B = 2), whose neighbours share sectors.  The
// wrapper sees B, n, k and the dtype, none of which tells hypercube from an
// expander, so every shared-table batch of B >= 2 takes the batch path.
//
// C interface (bound with ctypes): each launcher returns cudaGetLastError()
// after its launches; the caller raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRowThreads = 256;     // row path: rows (threads) per block, at most
constexpr int kBatchThreads = 256;   // batch path: threads per block, at most
constexpr int kChunk = 8;            // gathers in flight per step of a k loop
constexpr int kSmemBudget = 48 * 1024;

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "n"(BYTES) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// row path
// ---------------------------------------------------------------------------

// Shared-memory row stride, in entries, of a staged (rows, k) tile of 4-byte
// entries: k + 4 where k is a multiple of 8 (read as 16-byte vectors, a
// stride of k entries would put a quarter-warp's lanes on the same banks),
// else k (a contiguous image of the tile).
__host__ __device__ __forceinline__ int row_ld(int k) {
  return k % 8 == 0 ? k + 4 : k;
}

// Bytes of one staged tile: rows * row_ld(k) entries plus the 8 of slack a
// contiguous image needs to start on the global array's 16-byte grid.
__host__ __device__ __forceinline__ int row_tile_bytes(int rows, int k) {
  return (rows * row_ld(k) + 8) * 4;
}

// Copy rows [row0, row0 + rows) of a row-major array of 4-byte entries into
// `sm` with cp.async.  Row 0 of the array starts at entry `base` of `g`
// (16-byte aligned; `total` entries in all).  Returns the entry of `sm` at
// which the tile's first row starts; row r is at that + r * row_ld(k).
template <typename E>
__device__ __forceinline__ int stage_row_tile(E* sm, const E* g, int64_t base,
                                              int64_t row0, int rows, int k,
                                              int64_t total) {
  const int ld = row_ld(k);
  const int64_t e0 = base + row0 * k;
  if (ld == k) {                      // contiguous image, 16-byte copies
    const int64_t c0 = e0 >> 2;
    const int64_t c1 = (e0 + static_cast<int64_t>(rows) * k + 3) >> 2;
    for (int64_t c = c0 + threadIdx.x; c < c1; c += blockDim.x) {
      E* dst = sm + (c - c0) * 4;
      if (4 * c + 4 <= total) {
        cp_async16(dst, g + 4 * c);
      } else {
        for (int u = 0; u < 4; ++u)
          if (4 * c + u < total) cp_async<4>(dst + u, g + 4 * c + u);
      }
    }
    return static_cast<int>(e0 & 3);
  }
  const int q = k >> 2;               // k % 8 == 0: padded rows of 16-byte units
  for (int c = threadIdx.x; c < rows * q; c += blockDim.x) {
    const int r = c / q, u = c - r * q;
    cp_async16(sm + r * ld + 4 * u, g + e0 + static_cast<int64_t>(r) * k + 4 * u);
  }
  return 0;
}

// Load the M entries of a row at p into v: as 16-byte vectors (VEC: p is
// 16-byte aligned, M a multiple of 4, 4-byte entries), or one at a time from
// shared memory (SMEM) or through the read-only path.
template <int M, bool VEC, bool SMEM, typename E>
__device__ __forceinline__ void read_row(E (&v)[M], const E* p) {
  if constexpr (VEC) {
    static_assert(sizeof(E) == 4 && M % 4 == 0, "16-byte rows of 4-byte entries");
    using V4 = typename std::conditional<std::is_same<E, float>::value, float4,
                                         int4>::type;
#pragma unroll
    for (int q = 0; q < M / 4; ++q) {
      const V4 w = reinterpret_cast<const V4*>(p)[q];
      v[4 * q] = w.x; v[4 * q + 1] = w.y; v[4 * q + 2] = w.z; v[4 * q + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < M; ++j) v[j] = SMEM ? p[j] : __ldg(p + j);
  }
}

// K > 0: compiled radix; K == 0: runtime radix k.  STAGED: the table (and
// f32 signs) come from the shared-memory tile, else from device memory.
template <typename T, typename A, int K, bool SIGNED, bool LOOPS, bool STAGED>
__global__ void __launch_bounds__(kRowThreads)
spmv_rows_kernel(const T* __restrict__ x, const int32_t* __restrict__ table,
                 const A* __restrict__ loops, const A* __restrict__ signs,
                 T* __restrict__ y, int64_t n, int k, int64_t tab_bs,
                 int64_t loop_bs, int64_t sign_bs, int64_t tab_total,
                 int64_t sign_total) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kStageSigns = SIGNED && STAGED && sizeof(A) == 4;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * blockDim.x;
  const int64_t b = blockIdx.y;
  const int rows = static_cast<int>(min(static_cast<int64_t>(blockDim.x), n - row0));
  const int ld = row_ld(k);
  int32_t* t_s = reinterpret_cast<int32_t*>(smem);
  A* s_s = reinterpret_cast<A*>(smem + row_tile_bytes(blockDim.x, k));
  int t_off = 0, s_off = 0;
  if (STAGED) {
    t_off = stage_row_tile(t_s, table, b * tab_bs, row0, rows, k, tab_total);
    if (kStageSigns)
      s_off = stage_row_tile(s_s, signs, b * sign_bs, row0, rows, k, sign_total);
    cp_async_commit();
  }
  const bool active = static_cast<int>(threadIdx.x) < rows;
  const int64_t row = row0 + threadIdx.x;
  const T* xb = x + b * n;
  A lw = A(0), xi = A(0);
  if (LOOPS && active) {
    lw = __ldg(loops + b * loop_bs + row);
    xi = load_acc(xb + row);
  }
  if (STAGED) {
    cp_async_wait<0>();
    __syncthreads();
  }
  if (!active) return;
  // a staged row starts on a 16-byte boundary when k % 4 == 0 (t_off == 0)
  const bool vec = STAGED && k % 4 == 0;
  const int32_t* tr = STAGED ? t_s + t_off + threadIdx.x * ld
                             : table + b * tab_bs + row * k;
  const A* sr = kStageSigns ? s_s + s_off + threadIdx.x * ld
                            : signs + b * sign_bs + row * k;
  A acc = A(0);
  if constexpr (K > 0) {
    int32_t idx[K];
    A v[K];
    read_row<K, K % 4 == 0 && STAGED, STAGED>(idx, tr);
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = load_acc(xb + idx[j]);
    if constexpr (SIGNED) {
      A s[K];
      read_row<K, K % 4 == 0 && kStageSigns, kStageSigns>(s, sr);
#pragma unroll
      for (int j = 0; j < K; ++j) acc += s[j] * v[j];
    } else {
#pragma unroll
      for (int j = 0; j < K; ++j) acc += v[j];
    }
  } else {
    for (int j0 = 0; j0 < k; j0 += kChunk) {
      const int m = k - j0 < kChunk ? k - j0 : kChunk;
      int32_t idx[kChunk];
      A v[kChunk];
      if (vec) {
#pragma unroll
        for (int q = 0; q < kChunk / 4; ++q)
          if (4 * q < m) {
            const int4 w = *reinterpret_cast<const int4*>(tr + j0 + 4 * q);
            idx[4 * q] = w.x; idx[4 * q + 1] = w.y;
            idx[4 * q + 2] = w.z; idx[4 * q + 3] = w.w;
          }
      } else {
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          if (j < m) idx[j] = STAGED ? tr[j0 + j] : __ldg(tr + j0 + j);
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (j < m) v[j] = load_acc(xb + idx[j]);
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (j < m) {
          if (SIGNED) acc += (kStageSigns ? sr[j0 + j] : __ldg(sr + j0 + j)) * v[j];
          else acc += v[j];
        }
    }
  }
  if (LOOPS) acc += lw * xi;
  store(y + b * n + row, acc);
}

// ---------------------------------------------------------------------------
// batch path
// ---------------------------------------------------------------------------

// x (B, n) -> xT (n, P), 32 x 32 tiles through shared memory; E is a raw
// storage type of x's element size (the copy moves bits).
template <typename E>
__global__ void __launch_bounds__(256)
spmv_interleave_kernel(const E* __restrict__ x, E* __restrict__ xt, int64_t n,
                       int B, int P) {
  __shared__ E tile[32][33];
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * 32;
  const int b0 = blockIdx.y * 32;
  for (int yy = threadIdx.y; yy < 32; yy += 8) {
    const int b = b0 + yy;
    const int64_t i = i0 + threadIdx.x;
    if (b < B && i < n) tile[yy][threadIdx.x] = x[b * n + i];
  }
  __syncthreads();
  for (int yy = threadIdx.y; yy < 32; yy += 8) {
    const int64_t i = i0 + yy;
    const int b = b0 + threadIdx.x;
    if (b < B && i < n) xt[i * P + b] = tile[threadIdx.x][yy];
  }
}

// The same for rows of xT of at most one sector (P * sizeof(E) <= 32): one
// thread per i, whose B reads are coalesced across the warp; it writes its
// row (zero-padded to P) in one to two stores of up to 16 bytes.
template <typename E>
__global__ void __launch_bounds__(256)
spmv_interleave_rows_kernel(const E* __restrict__ x, E* __restrict__ xt,
                            int64_t n, int B, int P) {
  constexpr int kMax = 32 / sizeof(E);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  union {
    E e[kMax];
    uint4 v[2];
    uint2 v2;
    unsigned v1;
    unsigned short v0;
  } row;
#pragma unroll
  for (int b = 0; b < kMax; ++b) row.e[b] = b < B ? x[b * n + i] : E(0);
  char* dst = reinterpret_cast<char*>(xt + i * P);
  switch (P * static_cast<int>(sizeof(E))) {
    case 32:
      reinterpret_cast<uint4*>(dst)[1] = row.v[1];
      reinterpret_cast<uint4*>(dst)[0] = row.v[0];
      break;
    case 16: *reinterpret_cast<uint4*>(dst) = row.v[0]; break;
    case 8: *reinterpret_cast<uint2*>(dst) = row.v2; break;
    case 4: *reinterpret_cast<unsigned*>(dst) = row.v1; break;
    default: *reinterpret_cast<unsigned short*>(dst) = row.v0; break;
  }
}

__host__ __device__ __forceinline__ int up16(int bytes) { return (bytes + 15) & ~15; }

// The batch block's shared memory: signs, per-b loops, y, table tile.
struct BatchLayout {
  int sign_off, loop_off, y_off, tab_off, bytes;
};

__host__ __device__ __forceinline__ BatchLayout batch_layout(
    int bc, int R, int sr, int sb, int r1, bool signed_, bool per_b_signs,
    bool per_b_loops, int acc_size, int t_size) {
  BatchLayout L;
  int off = 0;
  L.sign_off = off;
  if (signed_) off += up16((per_b_signs ? bc * sb : R * sr) * acc_size);
  L.loop_off = off;
  if (per_b_loops) off += up16(bc * r1 * acc_size);
  L.y_off = off;
  off += up16(bc * r1 * t_size);
  L.tab_off = off;
  off += up16(R * sr * 4);
  L.bytes = off;
  return L;
}

// Copy `nrows` rows of `len` entries (ES bytes each) with cp.async: row q
// from src(q), to dst(q).  The block's warps take rows in turn; a row's
// lanes copy consecutive entries (several short rows per warp when
// len < 32), so each warp request reads contiguous device memory.
// blockDim.x must be a multiple of 32.
template <int ES, typename Src, typename Dst>
__device__ __forceinline__ void stage_rows(int nrows, int len, Src src, Dst dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int rpi = len >= 32 ? 1 : 32 / len;
  const int dr = len >= 32 ? 0 : lane / len;
  const int j0 = len >= 32 ? lane : lane - dr * len;
  if (len <= 0 || dr >= rpi) return;
  for (int q = warp * rpi + dr; q < nrows; q += nwarps * rpi)
    for (int j = j0; j < len; j += 32) cp_async<ES>(dst(q) + j, src(q) + j);
}

// The vector layout's copy (k a multiple of 32, 4-byte entries): nb x rows
// rows of len entries, row (qb, qr) from src + qb * src_b + qr * len to
// dst + qb * dst_b + qr * len, in 16-byte cp.async copies, its chunk u
// stored at chunk (u + (qr * bc) % 8) mod (len / 4).  That rotation (with
// dst_b = 4 mod 32 entries) puts the 16-byte reads of lanes t .. t + 7 of
// the compute loop on eight different bank groups.  The lanes of a warp
// copy consecutive chunks of its rows.  blockDim.x a multiple of 32.
template <typename E>
__device__ __forceinline__ void stage_rows_vec(E* dst, const E* src, int nb,
                                               int rows, int len, int64_t src_b,
                                               int dst_b, int bc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cpr = len >> 2;                     // chunks per row
  const int rpi = cpr >= 32 ? 1 : 32 / cpr;     // rows per warp step
  const int dr = cpr >= 32 ? 0 : lane / cpr;
  const int u0 = cpr >= 32 ? lane : lane - dr * cpr;
  if (dr >= rpi) return;
  const int step = (blockDim.x >> 5) * rpi;
  const int step_b = step / rows, step_r = step - step_b * rows;
  const int q = warp * rpi + dr;
  int qb = q / rows, qr = q - qb * rows;
  while (qb < nb) {
    const int rot = (qr * bc) & 7;
    const E* s = src + qb * src_b + static_cast<int64_t>(qr) * len;
    E* d = dst + qb * dst_b + qr * len;
    for (int u = u0; u < cpr; u += 32) {
      const int c = u + rot < cpr ? u + rot : u + rot - cpr;
      cp_async16(d + 4 * c, s + 4 * u);
    }
    qb += step_b;
    qr += step_r;
    if (qr >= rows) { qr -= rows; ++qb; }
  }
}

// 16-byte chunk u of row r in the vector layout
__device__ __forceinline__ int vec_chunk(int u, int rot, int cpr) {
  return u + rot < cpr ? u + rot : u + rot - cpr;
}

// The batch kernel, scalar layout: rows padded to sr = bc (mod 32),
// b-blocks to sb = 1 (mod 32), so that lane t reads bank t + j; staged one
// entry per lane.
template <typename T, typename A, bool SIGNED, bool LOOPS>
__global__ void __launch_bounds__(kBatchThreads)
spmv_batch_kernel(const T* __restrict__ xt, int P,
                  const int32_t* __restrict__ table, const A* __restrict__ loops,
                  const A* __restrict__ signs, T* __restrict__ y, int64_t n,
                  int k, int B, int bc, int R, int sr, int sb, int r1,
                  int64_t loop_bs, int64_t sign_bs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool per_b_signs = SIGNED && sign_bs != 0;
  const bool per_b_loops = LOOPS && loop_bs != 0;
  const BatchLayout L = batch_layout(bc, R, sr, sb, r1, SIGNED, per_b_signs,
                                     per_b_loops, sizeof(A), sizeof(T));
  A* s_s = reinterpret_cast<A*>(smem + L.sign_off);
  A* l_s = reinterpret_cast<A*>(smem + L.loop_off);
  T* y_s = reinterpret_cast<T*>(smem + L.y_off);
  int32_t* t_s = reinterpret_cast<int32_t*>(smem + L.tab_off);

  const int tid = threadIdx.x;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * R;
  const int b0 = blockIdx.y * bc;
  const int rows = static_cast<int>(min(static_cast<int64_t>(R), n - r0));
  const int bcs = min(bc, B - b0);        // batch entries of this block
  const int r = tid / bc, bl = tid - r * bc;
  const bool active = tid < R * bc && r < rows && bl < bcs;
  const int64_t row = r0 + r;
  const int b = b0 + bl;

  // group 0: the table tile; group 1: signs and per-b loops
  stage_rows<4>(rows, k, [&](int q) { return table + (r0 + q) * k; },
                [&](int q) { return t_s + q * sr; });
  cp_async_commit();
  if (SIGNED) {
    if (per_b_signs) {
      stage_rows<sizeof(A)>(
          bcs * rows, k,
          [&](int q) {
            const int qb = q / rows, qr = q - qb * rows;
            return signs + (b0 + qb) * sign_bs + (r0 + qr) * k;
          },
          [&](int q) {
            const int qb = q / rows, qr = q - qb * rows;
            return s_s + qb * sb + qr * sr;
          });
    } else {
      stage_rows<sizeof(A)>(rows, k, [&](int q) { return signs + (r0 + q) * k; },
                            [&](int q) { return s_s + q * sr; });
    }
  }
  if (per_b_loops)
    stage_rows<sizeof(A)>(bcs, rows,
                          [&](int q) { return loops + (b0 + q) * loop_bs + r0; },
                          [&](int q) { return l_s + q * r1; });
  cp_async_commit();

  A lw = A(0), xi = A(0);
  if (LOOPS && active) {
    if (!per_b_loops) lw = __ldg(loops + row);
    xi = load_acc(xt + row * P + b);
  }
  cp_async_wait<1>();
  __syncthreads();                        // the table tile is in

  const int32_t* tr = t_s + r * sr;
  const A* sv = per_b_signs ? s_s + bl * sb + r * sr : s_s + r * sr;
  const T* xb = xt + b;
  A acc = A(0);
  for (int j0 = 0; j0 < k || j0 == 0; j0 += kChunk) {
    const int m = k - j0 < kChunk ? k - j0 : kChunk;   // 0 only when k == 0
    int32_t idx[kChunk];
    A v[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < m && active) idx[j] = tr[j0 + j];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < m && active) v[j] = load_acc(xb + static_cast<int64_t>(idx[j]) * P);
    if (j0 == 0) {                        // signs and loops are in
      cp_async_wait<0>();
      __syncthreads();
    }
    if (active) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (j < m) {
          if (SIGNED) acc += sv[j0 + j] * v[j];
          else acc += v[j];
        }
    }
  }
  if (LOOPS) {
    if (per_b_loops && active) lw = l_s[bl * r1 + r];
    acc += lw * xi;
  }
  if (active) store(y_s + bl * r1 + r, acc);
  __syncthreads();
  for (int e = tid; e < bcs * rows; e += blockDim.x) {
    const int q = e / rows, qr = e - q * rows;
    y[(b0 + q) * n + r0 + qr] = y_s[q * r1 + qr];
  }
}

// The batch kernel for per-b f32 signs (B, n, k) with k a multiple of 32,
// the lift search's form, whose signs (B n k 4 bytes) are most of the
// device-memory traffic.  The table rows and signs are staged in 16-byte
// copies (stage_rows_vec's rotated rows; a b-block is R k + 4 entries) and
// read as 16-byte vectors, lanes t .. t + 7 on eight different bank
// groups; one entry per lane, as the scalar layout does, took 1.6x as long.
// Loops come from device memory.
template <typename T, bool LOOPS>
__global__ void __launch_bounds__(kBatchThreads)
spmv_batch_signed_kernel(const T* __restrict__ xt, int P,
                         const int32_t* __restrict__ table,
                         const float* __restrict__ loops,
                         const float* __restrict__ signs, T* __restrict__ y,
                         int64_t n, int k, int B, int bc, int R, int r1,
                         int64_t loop_bs, int64_t sign_bs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int sb = R * k + 4;
  float* s_s = reinterpret_cast<float*>(smem);                   // [bc sb]
  int32_t* t_s = reinterpret_cast<int32_t*>(s_s + bc * sb);      // [R k]
  T* y_s = reinterpret_cast<T*>(t_s + R * k);                    // [bc r1]
  const int tid = threadIdx.x;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * R;
  const int b0 = blockIdx.y * bc;
  const int rows = static_cast<int>(min(static_cast<int64_t>(R), n - r0));
  const int bcs = min(bc, B - b0);
  const int r = tid / bc, bl = tid - r * bc;
  const bool active = tid < R * bc && r < rows && bl < bcs;
  const int64_t row = r0 + r;
  const int b = b0 + bl;
  const T* xb = xt + b;

  stage_rows_vec(t_s, table + r0 * k, 1, rows, k, 0, 0, bc);
  cp_async_commit();
  stage_rows_vec(s_s, signs + b0 * sign_bs + r0 * k, bcs, rows, k, sign_bs, sb,
                 bc);
  cp_async_commit();
  float lw = 0.0f, xi = 0.0f;
  if (LOOPS && active) {
    lw = __ldg(loops + b * loop_bs + row);
    xi = load_acc(xb + row * P);
  }
  cp_async_wait<1>();
  __syncthreads();                        // the table rows are in
  const int cpr = k >> 2, rot = (r * bc) & 7;
  const int32_t* tr = t_s + r * k;
  const float* sv = s_s + bl * sb + r * k;
  float acc = 0.0f;
  for (int j0 = 0; j0 < k; j0 += kChunk) {
    int32_t idx[kChunk];
    float v[kChunk], s[kChunk];
    if (active) {
#pragma unroll
      for (int q = 0; q < kChunk / 4; ++q) {
        const int4 w = *reinterpret_cast<const int4*>(
            tr + 4 * vec_chunk((j0 >> 2) + q, rot, cpr));
        idx[4 * q] = w.x; idx[4 * q + 1] = w.y;
        idx[4 * q + 2] = w.z; idx[4 * q + 3] = w.w;
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        v[j] = load_acc(xb + static_cast<int64_t>(idx[j]) * P);
    }
    if (j0 == 0) {                        // the signs are in
      cp_async_wait<0>();
      __syncthreads();
    }
    if (active) {
#pragma unroll
      for (int q = 0; q < kChunk / 4; ++q) {
        const float4 w = *reinterpret_cast<const float4*>(
            sv + 4 * vec_chunk((j0 >> 2) + q, rot, cpr));
        s[4 * q] = w.x; s[4 * q + 1] = w.y;
        s[4 * q + 2] = w.z; s[4 * q + 3] = w.w;
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) acc += s[j] * v[j];
    }
  }
  if (LOOPS) acc += lw * xi;
  if (active) store(y_s + bl * r1 + r, acc);
  __syncthreads();
  for (int e = tid; e < bcs * rows; e += blockDim.x) {
    const int q = e / rows, qr = e - q * rows;
    y[(b0 + q) * n + r0 + qr] = y_s[q * r1 + qr];
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T, typename A, int K, bool S, bool L, bool STAGED>
void launch_rows_k(const void* x, const void* table, const void* loops,
                   const void* signs, void* y, int64_t n, int k, int batch,
                   int64_t tab_bs, int64_t loop_bs, int64_t sign_bs,
                   int64_t tab_total, int64_t sign_total, int rows_per_block,
                   int smem, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + rows_per_block - 1) / rows_per_block),
                  static_cast<unsigned>(batch));
  spmv_rows_kernel<T, A, K, S, L, STAGED><<<grid, rows_per_block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(table),
      static_cast<const A*>(loops), static_cast<const A*>(signs),
      static_cast<T*>(y), n, k, tab_bs, loop_bs, sign_bs, tab_total, sign_total);
}

template <typename T, typename A, int K>
void launch_rows_sl(const void* x, const void* table, const void* loops,
                    const void* signs, void* y, int64_t n, int k, int batch,
                    int64_t tab_bs, int64_t loop_bs, int64_t sign_bs,
                    int64_t tab_total, int64_t sign_total, int rows_per_block,
                    int smem, bool staged, cudaStream_t stream) {
#define SPMV_ROWS(S, L, ST)                                                     \
  launch_rows_k<T, A, K, S, L, ST>(x, table, loops, signs, y, n, k, batch,     \
                                   tab_bs, loop_bs, sign_bs, tab_total,        \
                                   sign_total, rows_per_block, smem, stream)
  if (K > 0 || staged) {              // a compiled radix always fits
    if (signs && loops) SPMV_ROWS(true, true, true);
    else if (signs) SPMV_ROWS(true, false, true);
    else if (loops) SPMV_ROWS(false, true, true);
    else SPMV_ROWS(false, false, true);
  } else if constexpr (K == 0) {
    if (signs && loops) SPMV_ROWS(true, true, false);
    else if (signs) SPMV_ROWS(true, false, false);
    else if (loops) SPMV_ROWS(false, true, false);
    else SPMV_ROWS(false, false, false);
  }
#undef SPMV_ROWS
}

template <typename T, typename A>
void launch_rows(const void* x, const void* table, const void* loops,
                 const void* signs, void* y, int64_t n, int k, int batch,
                 int64_t tab_bs, int64_t loop_bs, int64_t sign_bs,
                 cudaStream_t stream) {
  const bool stage_signs = signs != nullptr && sizeof(A) == 4;
  auto tile_bytes = [&](int rows) {
    return row_tile_bytes(rows, k) * (stage_signs ? 2 : 1);
  };
  int rows_per_block = kRowThreads;
  while (rows_per_block > 32 && tile_bytes(rows_per_block) > kSmemBudget)
    rows_per_block /= 2;
  const bool staged = tile_bytes(rows_per_block) <= kSmemBudget;
  if (!staged) rows_per_block = kRowThreads;
  const int smem = staged ? tile_bytes(rows_per_block) : 0;
  const int64_t tab_total = tab_bs ? tab_bs * batch : n * k;
  const int64_t sign_total = sign_bs ? sign_bs * batch : n * k;
#define SPMV_K(KV)                                                              \
  launch_rows_sl<T, A, KV>(x, table, loops, signs, y, n, k, batch, tab_bs,     \
                           loop_bs, sign_bs, tab_total, sign_total,            \
                           rows_per_block, smem, staged, stream)
  switch (staged ? k : 0) {
    case 3: SPMV_K(3); break;
    case 4: SPMV_K(4); break;
    case 5: SPMV_K(5); break;
    case 6: SPMV_K(6); break;
    case 7: SPMV_K(7); break;
    case 8: SPMV_K(8); break;
    case 16: SPMV_K(16); break;
    case 32: SPMV_K(32); break;
    default: SPMV_K(0); break;
  }
#undef SPMV_K
}

// Plan of the batch path: batch chunk bc, rows per block R, shared-memory
// strides, and whether spmv_batch_signed_kernel takes it.  False when even
// one row of one entry does not fit the budget.
struct BatchPlan {
  int bc, R, sr, sb, r1, nchunks, threads, smem;
  bool signed_kernel;
};

bool plan_batch(int B, int k, int elem, bool signed_, bool per_b_signs,
                bool per_b_loops, int acc_size, BatchPlan* p) {
  const int sector_bc = 32 / elem > 1 ? 32 / elem : 1;   // one sector wide
  const bool sk = per_b_signs && k % 32 == 0 && acc_size == 4;
  int bc_max = kBatchThreads;
  auto mod32 = [](int v) { return ((v % 32) + 32) % 32; };
  for (;;) {
    int nchunks = (B + bc_max - 1) / bc_max;
    int bc = (B + nchunks - 1) / nchunks;
    if (nchunks > 1)                  // chunks start on sector boundaries
      bc = (bc + sector_bc - 1) / sector_bc * sector_bc;
    nchunks = (B + bc - 1) / bc;
    const int sr = sk ? k : k + mod32(bc - k);
    for (int R = kBatchThreads / bc > 0 ? kBatchThreads / bc : 1; R >= 1; --R) {
      const int sb = sk ? R * sr + 4 : R * sr + mod32(1 - R * sr);
      const int r1 = R | 1;
      // sk: spmv_batch_signed_kernel's signs, table rows and y
      const int bytes =
          sk ? bc * sb * 4 + R * k * 4 + up16(bc * r1 * elem)
             : batch_layout(bc, R, sr, sb, r1, signed_, per_b_signs,
                            per_b_loops, acc_size, elem).bytes;
      if (bytes <= kSmemBudget) {
        *p = BatchPlan{bc, R, sr, sb, r1, nchunks, (R * bc + 31) / 32 * 32,
                       bytes, sk};
        return true;
      }
    }
    if (bc_max <= 1) return false;
    bc_max /= 2;
  }
}

template <typename T, typename A, typename E>
int launch_batch(const void* x, const void* table, const void* loops,
                 const void* signs, void* y, int64_t n, int k, int batch,
                 int64_t loop_bs, int64_t sign_bs, void* xt, int P,
                 cudaStream_t stream) {
  BatchPlan p;
  if (!plan_batch(batch, k, sizeof(T), signs != nullptr, sign_bs != 0,
                  loops != nullptr && loop_bs != 0, sizeof(A), &p))
    return 0;                          // caller takes the row path
  if (P * static_cast<int>(sizeof(E)) <= 32) {
    spmv_interleave_rows_kernel<E><<<static_cast<unsigned>((n + 255) / 256), 256,
                                     0, stream>>>(
        static_cast<const E*>(x), static_cast<E*>(xt), n, batch, P);
  } else {
    const dim3 tgrid(static_cast<unsigned>((n + 31) / 32),
                     static_cast<unsigned>((batch + 31) / 32));
    spmv_interleave_kernel<E><<<tgrid, dim3(32, 8), 0, stream>>>(
        static_cast<const E*>(x), static_cast<E*>(xt), n, batch, P);
  }
  const dim3 grid(static_cast<unsigned>((n + p.R - 1) / p.R),
                  static_cast<unsigned>(p.nchunks));
  if constexpr (sizeof(A) == 4) {
    if (p.signed_kernel) {
      auto kern = loops ? spmv_batch_signed_kernel<T, true>
                        : spmv_batch_signed_kernel<T, false>;
      kern<<<grid, p.threads, p.smem, stream>>>(
          static_cast<const T*>(xt), P, static_cast<const int32_t*>(table),
          static_cast<const float*>(loops), static_cast<const float*>(signs),
          static_cast<T*>(y), n, k, batch, p.bc, p.R, p.r1, loop_bs, sign_bs);
      return 1;
    }
  }
#define SPMV_BATCH(S, L)                                                        \
  spmv_batch_kernel<T, A, S, L><<<grid, p.threads, p.smem, stream>>>(           \
      static_cast<const T*>(xt), P, static_cast<const int32_t*>(table),        \
      static_cast<const A*>(loops), static_cast<const A*>(signs),              \
      static_cast<T*>(y), n, k, batch, p.bc, p.R, p.sr, p.sb, p.r1, loop_bs,   \
      sign_bs)
  if (signs && loops) SPMV_BATCH(true, true);
  else if (signs) SPMV_BATCH(true, false);
  else if (loops) SPMV_BATCH(false, true);
  else SPMV_BATCH(false, false);
#undef SPMV_BATCH
  return 1;
}

template <typename T, typename A, typename E>
void launch(const void* x, const void* table, const void* loops,
            const void* signs, void* y, int64_t n, int k, int batch,
            int64_t tab_bs, int64_t loop_bs, int64_t sign_bs, void* xt, int P,
            cudaStream_t stream) {
  if (xt && tab_bs == 0 && batch > 1 &&
      launch_batch<T, A, E>(x, table, loops, signs, y, n, k, batch, loop_bs,
                            sign_bs, xt, P, stream))
    return;
  launch_rows<T, A>(x, table, loops, signs, y, n, k, batch, tab_bs, loop_bs,
                    sign_bs, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64, 2 = bfloat16 (x and y, (batch, n)
// contiguous).  table int32, (n, k) or (batch, n, k); loops / signs may be
// NULL; when given they hold the accumulation type (f64 for f64, else f32).
// A batch stride of 0 shares that operand across the batch.  table, loops
// and signs start on 16-byte boundaries.  xt: scratch of n * xt_stride
// elements of x's type (xt_stride >= batch), or NULL: with it a shared-table
// batch takes the batch path.
int spmv_padded_launch(int dtype, const void* x, const void* table,
                       const void* loops, const void* signs, void* y,
                       long long n, int k, int batch, long long tab_bstride,
                       long long loop_bstride, long long sign_bstride,
                       void* xt, int xt_stride, void* stream) {
  if (n <= 0 || batch <= 0) return static_cast<int>(cudaGetLastError());
  if (k < 0 || batch > 65535 || (xt && xt_stride < batch))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch<float, float, float>(x, table, loops, signs, y, n, k, batch,
                                  tab_bstride, loop_bstride, sign_bstride, xt,
                                  xt_stride, s);
      break;
    case 1:
      launch<double, double, double>(x, table, loops, signs, y, n, k, batch,
                                     tab_bstride, loop_bstride, sign_bstride,
                                     xt, xt_stride, s);
      break;
    case 2:
      launch<__nv_bfloat16, float, unsigned short>(
          x, table, loops, signs, y, n, k, batch, tab_bstride, loop_bstride,
          sign_bstride, xt, xt_stride, s);
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
