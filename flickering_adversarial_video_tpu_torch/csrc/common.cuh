// Shared helpers for the port's hand-written Hopper kernels (sm_90a).
//
// Every kernel is exported through a plain C function that takes raw device
// pointers, int64 extents, a dtype code and the caller's CUDA stream, launches
// on that stream and returns cudaGetLastError() so the Python wrapper
// (ops/kernels.py) can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FAV_API extern "C" __attribute__((visibility("default")))

namespace fav {

// dtype codes; must match ops/kernels.py DTYPE_CODE
enum DType : int { kF32 = 0, kBF16 = 1 };

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// max(a, b), NaN if either is NaN (jnp.maximum's rule; fmaxf drops a NaN),
// in one instruction.
__device__ __forceinline__ float fmax_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// One rounding to T and back: `rt<T>(a + b)` is an add carried out in T.
template <typename T>
__device__ __forceinline__ float rt(float v) { return to_f(from_f<T>(v)); }

// Blocks for a grid-stride loop over n elements.
inline unsigned grid_for(int64_t n, int threads = kThreads) {
  int64_t blocks = (n + threads - 1) / threads;
  const int64_t cap = int64_t(1) << 20;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks);
}

__device__ __forceinline__ int64_t global_tid() {
  return int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int64_t grid_stride() {
  return int64_t(gridDim.x) * blockDim.x;
}

// Position of a flat index in a tensor of rows [.., T, row_len] whose
// innermost axis has C channels (row_len % C == 0): the frame t of the row
// and the channel c, advanced one element at a time without divisions.
struct RowCursor {
  int64_t row_len;
  int64_t r;  // offset within the row
  int T, C, t, c;

  __device__ __forceinline__ RowCursor(int64_t i, int64_t row_len_, int T_, int C_)
      : row_len(row_len_), T(T_), C(C_) {
    const int64_t row = i / row_len;
    r = i - row * row_len;
    t = int(row % T);
    c = int(r % C);
  }

  __device__ __forceinline__ void next() {
    if (++c == C) c = 0;
    if (++r == row_len) {
      r = 0;
      c = 0;
      if (++t == T) t = 0;
    }
  }
};

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace fav

FAV_API const char* fav_error_string(int code);
