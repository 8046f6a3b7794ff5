// Fused RMSNorm for Hopper (sm_90a): kernel K5 of the port.
//
//   y[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * w          (f32 math)
//
// Replaces the Pallas kernel `rmsnorm` of src/repro/kernels/rmsnorm/kernel.py
// (`_rmsnorm_kernel`), which loaded a (block_rows, D) tile into VMEM and did
// the square, mean and scale in one pass on the VPU.
//
// Design (simple and right first):
//   * A group of TPR threads owns one row: a warp (TPR = 32, eight rows per
//     256-thread block) when D <= 1024, the whole block (TPR = 256) above.
//     A row of the serving path (D = 4096, bf16) is 8 KB: 256 threads read
//     it in two 16-byte loads each.
//   * Pass 1 reads the row with 16-byte vector loads (8 bf16 or 4 f32) when
//     D is a multiple of the vector width, else element by element, and sums
//     the squares in f32.  The sum is reduced by warp shuffles and, for
//     TPR = 256, across the block's eight warps through shared memory.
//   * Pass 2 reads the row again (from L1/L2: it was just read) with the
//     weight, and writes (x * inv) * w, the order of the Pallas body.
//   * Ragged row counts are masked by the row index; nothing is padded.
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
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
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

template <typename T>
void launch(const void* x, const void* w, void* y, int64_t rows, int D,
            float eps, cudaStream_t stream) {
  const bool vec = D % Vec<T>::N == 0;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
#define RMS_LAUNCH(TPR, V)                                                  \
  rmsnorm_kernel<T, TPR, V>                                                 \
      <<<static_cast<unsigned>((rows + kThreads / TPR - 1) / (kThreads / TPR)), \
         kThreads, 0, stream>>>(xp, wp, yp, rows, D, eps)
  if (D > 1024) {
    if (vec) RMS_LAUNCH(256, true); else RMS_LAUNCH(256, false);
  } else {
    if (vec) RMS_LAUNCH(32, true); else RMS_LAUNCH(32, false);
  }
#undef RMS_LAUNCH
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 2 = bfloat16 (x, w and y).
int rmsnorm_launch(int dtype, const void* x, const void* w, void* y,
                   long long rows, int D, float eps, void* stream) {
  if (rows <= 0 || D <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(x, w, y, rows, D, eps, s);
  else if (dtype == 2)
    launch<__nv_bfloat16>(x, w, y, rows, D, eps, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
