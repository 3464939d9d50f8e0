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

#include <algorithm>

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

// ---- 16-byte channel vectors: 8 bf16 or 4 f32 channels of one position ----

template <typename T>
constexpr int kVec = 16 / int(sizeof(T));

template <typename T>
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[kVec<T>]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int j = 0; j < kVec<T>; ++j) {
    if constexpr (sizeof(T) == 4)
      f[j] = __uint_as_float(w[j]);
    else
      f[j] = __uint_as_float((j & 1) ? (w[j >> 1] & 0xffff0000u) : (w[j >> 1] << 16));
  }
}

// f holds values of T (maxima of T values, -inf, NaN): packed without rounding
template <typename T>
__device__ __forceinline__ uint4 pack_exact(const float (&f)[kVec<T>]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4)
      w[i] = __float_as_uint(f[i]);
    else
      w[i] = (__float_as_uint(f[2 * i]) >> 16) | (__float_as_uint(f[2 * i + 1]) & 0xffff0000u);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// rounded to nearest even, as the plain version's one cast
template <typename T>
__device__ __forceinline__ uint4 pack_round(const float (&f)[kVec<T>]) {
  if constexpr (sizeof(T) == 4) {
    return pack_exact<T>(f);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&p);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <typename T>
__device__ __forceinline__ uint4 splat(float v) {
  float f[kVec<T>];
#pragma unroll
  for (int j = 0; j < kVec<T>; ++j) f[j] = v;
  return pack_exact<T>(f);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// wait until at most N of this thread's committed cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// max of two packed bf16 pairs, NaN if either is NaN, in one instruction
__device__ __forceinline__ uint32_t max_nan_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// max(max(a, b), d) of three 16-byte channel vectors, channel by channel,
// NaN-propagating: packed pairs for bf16, no unpacking
template <typename T>
__device__ __forceinline__ uint4 max3(const uint4& a, const uint4& b, const uint4& d) {
  const uint32_t av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w},
                 dv[4] = {d.x, d.y, d.z, d.w};
  uint32_t m[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4)
      m[i] = __float_as_uint(fmax_nan(fmax_nan(__uint_as_float(av[i]), __uint_as_float(bv[i])),
                                      __uint_as_float(dv[i])));
    else
      m[i] = max_nan_bf16x2(max_nan_bf16x2(av[i], bv[i]), dv[i]);
  }
  return make_uint4(m[0], m[1], m[2], m[3]);
}

// One channel vector at element offset `off` (channel c0 of a position):
// 16 bytes at once when C is a multiple of the vector (VEC), else channel by
// channel with `fill` past C.
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_vec(const T* __restrict__ src, int64_t off, int c0, int C,
                                          float fill) {
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const uint4*>(src + off));
  } else {
    float f[kVec<T>];
#pragma unroll
    for (int j = 0; j < kVec<T>; ++j) f[j] = c0 + j < C ? fav::to_f(src[off + j]) : fill;
    return pack_exact<T>(f);
  }
}

// The channel vector v (values of T) at element offset `off`: one 16-byte
// store when VEC, else channel by channel up to C.
template <typename T, bool VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ dst, int64_t off, int c0, int C,
                                          const uint4& v) {
  if constexpr (VEC) {
    *reinterpret_cast<uint4*>(dst + off) = v;
  } else {
    float f[kVec<T>];
    unpack<T>(v, f);
#pragma unroll
    for (int j = 0; j < kVec<T>; ++j)
      if (c0 + j < C) dst[off + j] = fav::from_f<T>(f[j]);
  }
}

// Blocks of `kernel` that the card holds at once (one wave), by the
// occupancy calculator for this block size and dynamic shared memory.
template <typename K>
inline int64_t wave_blocks(K kernel, int threads, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  return int64_t(std::max(sms, 1)) * std::max(per_sm, 1);
}

}  // namespace fav

FAV_API const char* fav_error_string(int code);
