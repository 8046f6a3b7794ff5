// Fused RMSNorm for Hopper (sm_90a): kernel K5 of the port.
//
//   y[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * w          (f32 math)
//
// Replaces the Pallas kernel `rmsnorm` of src/repro/kernels/rmsnorm/kernel.py
// (`_rmsnorm_kernel`), which loaded a (block_rows, D) tile into VMEM and did
// the square, mean and scale in one pass on the VPU.
//
// Design (the Hopper redesign, `rmsnorm_rows_kernel`), for rows of 16-byte
// vectors// (D a multiple of 8 bf16 or 4 f32, 16-byte-aligned pointers) of up to
// 2,048 vectors:
//   * Warp slices sized to D: a row is owned by W warps, the least power of
//     two with 256 W >= nvec (nvec = D / vector width; W divides the
//     block's 8 warps), each thread holding NV = ceil(nvec / 32 W)
//     <= 8 of its vectors in registers (vector k of a thread: lane + 32 W k
//     of the row).  D 3584 bf16: 448 vectors, 2 warps of 7 each; D 4096: 2
//     warps of 8.  The row is read once: every load of a row is issued
//     before any reduction, and the next row's loads are issued before this
//     row's reduction and stores (two register buffers), so ~2 rows of
//     bytes a thread are in flight.
//   * Several rows a block (256 threads: 256 / 32 W rows at once), the
//     weight's vectors loaded once per block into registers, a persistent
//     grid of a multiple of the SM count (the occupancy's blocks an SM)
//     walking the row groups: no wave tail.
//   * The row's sum of squares in f32: warp shuffles, then the W warps'
//     partials through shared memory (double-buffered by the group's
//     parity, one __syncthreads a group).
//   * (x * inv) * w in f32, the order of the Pallas body.
// Other widths (or misaligned pointers, or longer rows) take the first
// design, `rmsnorm_block_kernel`: a warp (TPR = 32, eight rows per 256-thread
// block) for D <= 1024, the whole block (TPR = 256) above; pass 1 sums
// the squares (16-byte vectors when D allows, else element by element),
// pass 2 reads the row again from L1/L2 with the weight.  It is also
// exported alone (rmsnorm_launch_block), so that both designs can be
// timed on the same inputs.  Ragged row counts are masked by the row
// index; nothing is padded.
//
// Bound: device-memory bytes.  It reads x and w once and writes y once; it
// does ~4 flops per element.  At the serving path's prefill shape,
// (4096, 4096) bf16, that is 67.1 MB: 20.0 us at 3.35 TB/s.
//
// C interface (bound with ctypes): rmsnorm_launch returns cudaGetLastError()
// after the launch; the caller raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// Elements of T in one 16-byte load or store.
template <typename T> struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

template <typename T, int TPR, bool VECTOR>
__global__ void __launch_bounds__(kThreads)
rmsnorm_block_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ y, int64_t rows, int D, float eps) {
  constexpr int kRowsPerBlock = kThreads / TPR;
  constexpr int VN = Vec<T>::N;
  const int lane = threadIdx.x % TPR;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock
                      + threadIdx.x / TPR;
  // TPR == 256: the row is block-uniform, so this return is too
  if (row >= rows) return;
  const T* xr = x + row * D;
  T* yr = y + row * D;

  float ss = 0.f;
  if (VECTOR) {
    for (int i = lane * VN; i < D; i += TPR * VN) {
      alignas(16) T v[VN];
      *reinterpret_cast<uint4*>(v) = __ldg(reinterpret_cast<const uint4*>(xr + i));
#pragma unroll
      for (int j = 0; j < VN; ++j) {
        const float f = to_f32(v[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = lane; i < D; i += TPR) {
      const float f = to_f32(xr[i]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (TPR > 32) {
    __shared__ float part[kThreads / 32];
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) ss += part[i];
  }
  const float inv = rsqrtf(ss / static_cast<float>(D) + eps);

  if (VECTOR) {
    for (int i = lane * VN; i < D; i += TPR * VN) {
      alignas(16) T v[VN];
      alignas(16) T o[VN];
      *reinterpret_cast<uint4*>(v) = __ldg(reinterpret_cast<const uint4*>(xr + i));
#pragma unroll
      for (int j = 0; j < VN; ++j)
        o[j] = from_f32<T>(to_f32(v[j]) * inv * to_f32(w[i + j]));
      *reinterpret_cast<uint4*>(yr + i) = *reinterpret_cast<const uint4*>(o);
    }
  } else {
    for (int i = lane; i < D; i += TPR)
      yr[i] = from_f32<T>(to_f32(xr[i]) * inv * to_f32(w[i]));
  }
}

// ---- the redesign: warp slices, rows in registers, a persistent grid ----

__device__ __forceinline__ float sum_sq(const uint4& v, float) {
  const float4 f = *reinterpret_cast<const float4*>(&v);
  return f.x * f.x + f.y * f.y + f.z * f.z + f.w * f.w;
}
__device__ __forceinline__ float sum_sq(const uint4& v, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    s += f.x * f.x + f.y * f.y;
  }
  return s;
}

template <typename T>
__device__ __forceinline__ uint4 scale_vec(const uint4& v, const uint4& wv,
                                           float inv) {
  constexpr int VN = Vec<T>::N;
  const T* a = reinterpret_cast<const T*>(&v);
  const T* b = reinterpret_cast<const T*>(&wv);
  alignas(16) T o[VN];
#pragma unroll
  for (int j = 0; j < VN; ++j)
    o[j] = from_f32<T>(to_f32(a[j]) * inv * to_f32(b[j]));
  return *reinterpret_cast<const uint4*>(o);
}

// W warps a row, NV vectors a thread; blockDim 256, 256 / 32 W rows a group
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
rmsnorm_rows_kernel(const T* __restrict__ x, const T* __restrict__ w,
            T* __restrict__ y, int64_t rows, int D, int W, float eps) {
  const int nvec = D / Vec<T>::N;
  const int tpr = 32 * W;
  const int rows_per_group = kThreads / tpr;
  const int slot = threadIdx.x / tpr;          // the row of the group
  const int lane = threadIdx.x % tpr;          // the thread in its row
  const int64_t groups = (rows + rows_per_group - 1) / rows_per_group;
  __shared__ float part[2][kThreads / 32];

  const uint4* wv = reinterpret_cast<const uint4*>(w);
  uint4 wr[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = lane + k * tpr;
    wr[k] = i < nvec ? __ldg(wv + i) : make_uint4(0, 0, 0, 0);
  }

  auto load = [&](uint4 (&buf)[NV], int64_t g) {
    const int64_t row = g * rows_per_group + slot;
    const uint4* xr = reinterpret_cast<const uint4*>(x) + row * nvec;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = lane + k * tpr;
      buf[k] = (row < rows && i < nvec) ? __ldcs(xr + i)
                                        : make_uint4(0, 0, 0, 0);
    }
  };

  uint4 cur[NV], nxt[NV];
  int64_t g = blockIdx.x;
  if (g < groups) load(cur, g);
  for (int parity = 0; g < groups; g += gridDim.x, parity ^= 1) {
    const int64_t g_next = g + gridDim.x;
    if (g_next < groups) load(nxt, g_next);
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) ss += sum_sq(cur[k], T());
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (threadIdx.x % 32 == 0) part[parity][threadIdx.x / 32] = ss;
    __syncthreads();
    ss = 0.f;
    for (int j = 0; j < W; ++j) ss += part[parity][slot * W + j];
    const float inv = rsqrtf(ss / static_cast<float>(D) + eps);
    const int64_t row = g * rows_per_group + slot;
    if (row < rows) {
      uint4* yr = reinterpret_cast<uint4*>(y) + row * nvec;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int i = lane + k * tpr;
        if (i < nvec) __stcs(yr + i, scale_vec<T>(cur[k], wr[k], inv));
      }
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) cur[k] = nxt[k];
  }
}

template <typename T, int NV>
int launch_rows(const T* xp, const T* wp, T* yp, int64_t rows, int D, int W,
                float eps, cudaStream_t stream) {
  static int grid[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (grid[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rmsnorm_rows_kernel<T, NV>, kThreads, 0);
    grid[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int per_group = kThreads / (32 * W);
  const int64_t groups = (rows + per_group - 1) / per_group;
  const unsigned blocks =
      static_cast<unsigned>(groups < grid[dev] ? groups : grid[dev]);
  rmsnorm_rows_kernel<T, NV><<<blocks, kThreads, 0, stream>>>(
      xp, wp, yp, rows, D, W, eps);
  return cudaSuccess;
}

template <typename T>
void launch_block(const void* x, const void* w, void* y, int64_t rows, int D,
                  float eps, cudaStream_t stream) {
  const bool vec = D % Vec<T>::N == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(w) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
#define RMS_LAUNCH(TPR, V)                                                  \
  rmsnorm_block_kernel<T, TPR, V>                                           \
      <<<static_cast<unsigned>((rows + kThreads / TPR - 1) /                \
                               (kThreads / TPR)),                           \
         kThreads, 0, stream>>>(xp, wp, yp, rows, D, eps)
  if (D > 1024) {
    if (vec) RMS_LAUNCH(256, true); else RMS_LAUNCH(256, false);
  } else {
    if (vec) RMS_LAUNCH(32, true); else RMS_LAUNCH(32, false);
  }
#undef RMS_LAUNCH
}

template <typename T>
int launch(const void* x, const void* w, void* y, int64_t rows, int D,
           float eps, cudaStream_t stream) {
  constexpr int VN = Vec<T>::N;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const int nvec = D / VN;
  if (!aligned || D % VN != 0 || nvec > 8 * kThreads) {
    launch_block<T>(x, w, y, rows, D, eps, stream);
    return cudaSuccess;
  }
  int W = 1;                                    // warps a row: 1, 2, 4, 8
  while (32 * 8 * W < nvec) W *= 2;
  const int NV = (nvec + 32 * W - 1) / (32 * W);  // vectors a thread, <= 8
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  switch (NV) {
    case 1: return launch_rows<T, 1>(xp, wp, yp, rows, D, W, eps, stream);
    case 2: return launch_rows<T, 2>(xp, wp, yp, rows, D, W, eps, stream);
    case 3: return launch_rows<T, 3>(xp, wp, yp, rows, D, W, eps, stream);
    case 4: return launch_rows<T, 4>(xp, wp, yp, rows, D, W, eps, stream);
    case 5: return launch_rows<T, 5>(xp, wp, yp, rows, D, W, eps, stream);
    case 6: return launch_rows<T, 6>(xp, wp, yp, rows, D, W, eps, stream);
    case 7: return launch_rows<T, 7>(xp, wp, yp, rows, D, W, eps, stream);
    default: return launch_rows<T, 8>(xp, wp, yp, rows, D, W, eps, stream);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 2 = bfloat16 (x, w and y).
int rmsnorm_launch(int dtype, const void* x, const void* w, void* y,
                   long long rows, int D, float eps, void* stream) {
  if (rows <= 0 || D <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = cudaSuccess;
  if (dtype == 0)
    err = launch<float>(x, w, y, rows, D, eps, s);
  else if (dtype == 2)
    err = launch<__nv_bfloat16>(x, w, y, rows, D, eps, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaGetLastError());
}

// the first design alone (rmsnorm_block_kernel), for timing it beside the
// redesign
int rmsnorm_launch_block(int dtype, const void* x, const void* w, void* y,
                         long long rows, int D, float eps, void* stream) {
  if (rows <= 0 || D <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_block<float>(x, w, y, rows, D, eps, s);
  else if (dtype == 2)
    launch_block<__nv_bfloat16>(x, w, y, rows, D, eps, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
