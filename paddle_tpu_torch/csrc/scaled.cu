// Elementwise scale o = x * alpha for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paddle_tpu/utils/extension.py::_scaled_kernel,
// the worked example of the JAX package's custom-op mechanism
// (o_ref[...] = x_ref[...] * alpha over the whole array), whose runnable
// twin is tests/test_custom_op.py's _kernel.
//
//   x      [n]   any shape, read as n contiguous elements; fp32, bf16 or fp16
//   alpha        a float already rounded to x's type by the caller
//   o      [n]   x's type
//
// Rounding follows JAX: `x * alpha` on a bf16 or fp16 x rounds the weakly
// typed alpha to x's type first, then multiplies and rounds once.  The
// caller rounds alpha; here the product of two bf16 or fp16 values is taken
// in fp32, where it is exact, and rounded once to x's type (round to
// nearest even).  So the kernel and its plain twin agree bit for bit.
//
// What bounds it on an H100: the bytes.  One multiply per element against
// each element read once and written once, so n * 2 * sizeof(T) bytes over
// 3.35 TB/s is the floor.  What the design does about it:
//   * 16-byte vector loads and stores (4 fp32 or 8 bf16/fp16 elements
//     each) where both pointers are 16-byte aligned, four of them loaded
//     by a thread before it uses any, so that enough bytes are in flight
//     to cover the memory's latency; the elements past the last whole
//     vector, and the whole array when a pointer is not aligned (a view
//     at an odd storage offset), take scalar accesses;
//   * a grid that covers the array once: a thread's four vectors lie a
//     grid's width apart, so that a warp's loads stay contiguous, and the
//     block scheduler keeps every SM full (a grid of a few blocks a SM
//     that loops over the array was slower).  Indices are int64, and the
//     loop over the grid's width only runs again past 2^31 - 1 blocks, so
//     that any n works.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;        // 16-byte loads in flight a thread
constexpr int64_t kMaxGrid = 0x7fffffff;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

// One 16-byte vector of T.
template <typename T>
struct alignas(16) Pack {
  T v[16 / sizeof(T)];
};

template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
    scaled_kernel(const T* __restrict__ x, T* __restrict__ o, int64_t n,
                  float alpha) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t start =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t scalar_from = 0;
  if (kVector) {
    const int64_t nvec = n / kVec;
    const Pack<T>* xv = reinterpret_cast<const Pack<T>*>(x);
    Pack<T>* ov = reinterpret_cast<Pack<T>*>(o);
    // kUnroll vectors a thread a step, all loaded before any is used
    for (int64_t base = start; base < nvec; base += stride * kUnroll) {
      Pack<T> p[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = base + u * stride;
        if (i < nvec) p[u] = xv[i];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = base + u * stride;
        if (i < nvec) {
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            p[u].v[j] = from_float<T>(to_float(p[u].v[j]) * alpha);
          }
          ov[i] = p[u];
        }
      }
    }
    scalar_from = nvec * kVec;
  }
  for (int64_t i = scalar_from + start; i < n; i += stride) {
    o[i] = from_float<T>(to_float(x[i]) * alpha);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* o, int64_t n, float alpha,
                   cudaStream_t stream) {
  const bool vector = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(o) % 16 == 0;
  const int64_t per_thread = vector ? kUnroll * 16 / sizeof(T) : 1;
  const int64_t per_block = static_cast<int64_t>(kThreads) * per_thread;
  const int64_t want = (n + per_block - 1) / per_block;
  const unsigned grid = static_cast<unsigned>(want < kMaxGrid ? want
                                                              : kMaxGrid);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(o);
  if (vector) {
    scaled_kernel<T, true><<<grid, kThreads, 0, stream>>>(xt, ot, n, alpha);
  } else {
    scaled_kernel<T, false><<<grid, kThreads, 0, stream>>>(xt, ot, n, alpha);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the CUDA error (0 on success).  The
// caller has checked that x and o lie on the current device, are
// contiguous and hold n >= 1 elements of one type (dtype 0: fp32, 1: bf16,
// 2: fp16), and that alpha is exactly representable in that type.
int scaled_launch(const void* x, void* o, int64_t n, float alpha, int dtype,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(x, o, n, alpha, s));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16>(x, o, n, alpha, s));
    case 2:
      return static_cast<int>(launch<__half>(x, o, n, alpha, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* scaled_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
