// B7: the attack step's input emitter on the space-to-depth packed uint8 clip.
//
// Replaces the Pallas kernel ops/stem_tmajor.py:363 emit_tmajor
// (`_emit_tmajor_kernel` :350, pallas_call :376) of the JAX package.  It
// computes what that kernel computes, not its layout: the TPU kernel's job
// was a [B,T',W,C] -> [W,C,T'B] transpose into the batch-in-lanes view; on
// NDHWC no transpose exists and the kernel is one coalesced pass.
//
//   pre   = u8/128 - 1 + dl[t',k]            f32 (the division is exact)
//   adv   = clip(pre, lo, hi)                rounded once to the output dtype
//   mask2 = 2 * d clip(pre)/d pre  in {0,1,2}, from the f32 pre: 1 at an
//           exact bound (jnp.clip's tie-splitting gradient, 0.5)
//
// u8, adv, mask2 are [B,T',H',W',CH] (CH = 8 C = 24), dl [T',CH] f32 already
// holds flag * pack(delta).  mask2 may be null: the no-grad forwards (eval,
// clean) need no mask, and the kernel then writes none.
//
// Bound on the H100: bytes (1 read + 2 or 4 + 1 written per element).
// Design: a thread takes 16 consecutive elements -- one 16-byte load of u8,
// 32 (bf16) or 64 (f32) bytes of adv and 16 of mask stored as 16-byte
// vectors; CH = 24 divides neither 16 nor 32, so the channel comes from the
// element index (a cursor walked along the 16 elements), not from the lane;
// dl sits in shared memory (T'*CH f32, 3 KB at T' = 32).  The last n % 16
// elements go one a thread after the vectors.  The tensors' bases must be
// 16-byte aligned, as every torch allocation is; otherwise the launch is
// refused (cudaErrorMisalignedAddress).

#include "common.cuh"

namespace {

__device__ __forceinline__ void emit_one(uint8_t u, float d, float lo, float hi, float* adv,
                                         uint8_t* m) {
  const float pre = float(u) * (1.0f / 128.0f) - 1.0f + d;
  *adv = fminf(fmaxf(pre, lo), hi);
  const int two_max = pre > lo ? 2 : (pre == lo ? 1 : 0);
  const int two_min = pre < hi ? 2 : (pre == hi ? 1 : 0);
  *m = uint8_t((two_max * two_min) >> 1);
}

template <typename T>
__global__ void __launch_bounds__(fav::kThreads)
emit_adv_mask_kernel(const uint8_t* __restrict__ u8, const float* __restrict__ dl,
                     T* __restrict__ adv, uint8_t* __restrict__ mask2, int64_t n, int64_t row_len,
                     int Tn, int CH, float lo, float hi) {
  extern __shared__ float sdl[];
  for (int k = threadIdx.x; k < Tn * CH; k += blockDim.x) sdl[k] = dl[k];
  __syncthreads();
  const int64_t n_vec = n / 16;
  for (int64_t v = fav::global_tid(); v < n_vec; v += fav::grid_stride()) {
    const int64_t i0 = v * 16;
    const uint4 raw = *reinterpret_cast<const uint4*>(u8 + i0);
    const uint8_t* ub = reinterpret_cast<const uint8_t*>(&raw);
    fav::RowCursor cur(i0, row_len, Tn, CH);
    alignas(16) T a[16];
    alignas(16) uint8_t m[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float f;
      emit_one(ub[j], sdl[cur.t * CH + cur.c], lo, hi, &f, &m[j]);
      a[j] = fav::from_f<T>(f);
      cur.next();
    }
    uint4* dst = reinterpret_cast<uint4*>(adv + i0);
    const uint4* src = reinterpret_cast<const uint4*>(a);
#pragma unroll
    for (int q = 0; q < int(sizeof(T)); ++q) dst[q] = src[q];
    if (mask2 != nullptr) *reinterpret_cast<uint4*>(mask2 + i0) = *reinterpret_cast<const uint4*>(m);
  }
  // the last n % 16 elements, one a thread
  for (int64_t i = n_vec * 16 + fav::global_tid(); i < n; i += fav::grid_stride()) {
    const fav::RowCursor cur(i, row_len, Tn, CH);
    float f;
    uint8_t m;
    emit_one(u8[i], sdl[cur.t * CH + cur.c], lo, hi, &f, &m);
    adv[i] = fav::from_f<T>(f);
    if (mask2 != nullptr) mask2[i] = m;
  }
}

template <typename T>
int emit_launch(const void* u8, const void* dl, void* adv, void* mask2, int64_t n, int64_t row_len,
                int Tn, int CH, float lo, float hi, cudaStream_t s) {
  const size_t smem = size_t(Tn) * CH * sizeof(float);
  if (smem > 48 * 1024) return int(cudaErrorInvalidValue);
  if (!fav::aligned16(u8) || !fav::aligned16(adv) || !fav::aligned16(mask2))
    return int(cudaErrorMisalignedAddress);
  emit_adv_mask_kernel<T><<<fav::grid_for(n / 16 + 1), fav::kThreads, smem, s>>>(
      static_cast<const uint8_t*>(u8), static_cast<const float*>(dl), static_cast<T*>(adv),
      static_cast<uint8_t*>(mask2), n, row_len, Tn, CH, lo, hi);
  return int(cudaGetLastError());
}

}  // namespace

// u8 [rows of T frames, row_len = H'*W'*CH each], n elements in all; dl [T,CH]
// f32; adv in `dtype`; mask2 uint8 or null.
FAV_API int fav_emit_adv_mask(const void* u8, const void* dl, void* adv, void* mask2, int64_t n,
                              int64_t row_len, int64_t T, int64_t CH, float lo, float hi,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (row_len <= 0 || CH <= 0 || row_len % CH || T <= 0) return int(cudaErrorInvalidValue);
  if (dtype == fav::kBF16)
    return emit_launch<__nv_bfloat16>(u8, dl, adv, mask2, n, row_len, int(T), int(CH), lo, hi, s);
  if (dtype == fav::kF32)
    return emit_launch<float>(u8, dl, adv, mask2, n, row_len, int(T), int(CH), lo, hi, s);
  return int(cudaErrorInvalidValue);
}
