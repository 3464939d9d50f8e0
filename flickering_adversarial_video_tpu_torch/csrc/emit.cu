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
//
// The per-clip form (the vectorized sweep's slots: clip b of the batch has
// its own delta) takes dl [B,T',CH] in the same kernel: grid.y is the clip,
// dl's row stride T'*CH (0 for the shared dl, whose grid has one row over
// the whole tensor), and a block stages only its row of dl, so shared memory
// stays T'*CH f32 (4.3 KB at T' = 45) whatever B is.  A block's vectors lie
// in one clip.  They start on 16-byte boundaries when a clip's T'*H'*W'*CH
// elements are a multiple of 16 (H'*W'*CH % 16 == 0 at even geometries);
// otherwise every element of the clip goes one a thread, so no 16-element
// vector straddles two clips.  The shared dl keeps its vectors whatever n is.

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

// 16 consecutive elements from flat index i0 (16-byte aligned in u8, adv and
// mask2); `cur` holds i0's frame and channel, which index sdl [T',CH]
template <typename T>
__device__ __forceinline__ void emit_vec16(const uint8_t* __restrict__ u8, const float* sdl,
                                           T* __restrict__ adv, uint8_t* __restrict__ mask2,
                                           int64_t i0, fav::RowCursor cur, int CH, float lo,
                                           float hi) {
  const uint4 raw = *reinterpret_cast<const uint4*>(u8 + i0);
  const uint8_t* ub = reinterpret_cast<const uint8_t*>(&raw);
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

// element i (flat), at local index `local` of its run of frames
template <typename T>
__device__ __forceinline__ void emit_scalar(const uint8_t* __restrict__ u8, const float* sdl,
                                            T* __restrict__ adv, uint8_t* __restrict__ mask2,
                                            int64_t i, int64_t local, int64_t row_len, int Tn,
                                            int CH, float lo, float hi) {
  const fav::RowCursor cur(local, row_len, Tn, CH);
  float f;
  uint8_t m;
  emit_one(u8[i], sdl[cur.t * CH + cur.c], lo, hi, &f, &m);
  adv[i] = fav::from_f<T>(f);
  if (mask2 != nullptr) mask2[i] = m;
}

// block (x, b) works in clip b (clip_n elements from b*clip_n; the whole
// tensor when dl is shared) with dl's row b at b*dl_stride
template <typename T>
__global__ void __launch_bounds__(fav::kThreads)
emit_adv_mask_kernel(const uint8_t* __restrict__ u8, const float* __restrict__ dl,
                     T* __restrict__ adv, uint8_t* __restrict__ mask2, int64_t clip_n,
                     int64_t dl_stride, int64_t row_len, int Tn, int CH, float lo, float hi) {
  extern __shared__ float sdl[];
  const int64_t b = blockIdx.y;
  const float* dl_b = dl + b * dl_stride;
  for (int k = threadIdx.x; k < Tn * CH; k += blockDim.x) sdl[k] = dl_b[k];
  __syncthreads();
  const int64_t base = b * clip_n;
  // vectors only where every clip starts on a 16-byte boundary
  const int64_t n_vec = dl_stride == 0 || clip_n % 16 == 0 ? clip_n / 16 : 0;
  for (int64_t v = fav::global_tid(); v < n_vec; v += fav::grid_stride())
    emit_vec16<T>(u8, sdl, adv, mask2, base + v * 16, fav::RowCursor(v * 16, row_len, Tn, CH), CH,
                  lo, hi);
  // the rest (the last clip_n % 16 elements, or a clip's all), one a thread
  for (int64_t i = n_vec * 16 + fav::global_tid(); i < clip_n; i += fav::grid_stride())
    emit_scalar<T>(u8, sdl, adv, mask2, base + i, i, row_len, Tn, CH, lo, hi);
}

template <typename T>
int emit_launch(const void* u8, const void* dl, void* adv, void* mask2, int64_t clips,
                int64_t clip_n, int64_t dl_stride, int64_t row_len, int Tn, int CH, float lo,
                float hi, cudaStream_t s) {
  const size_t smem = size_t(Tn) * CH * sizeof(float);
  if (smem > 48 * 1024 || clips > 65535) return int(cudaErrorInvalidValue);
  if (!fav::aligned16(u8) || !fav::aligned16(adv) || !fav::aligned16(mask2))
    return int(cudaErrorMisalignedAddress);
  const dim3 grid(fav::grid_for(clip_n / 16 + 1), unsigned(clips));
  emit_adv_mask_kernel<T><<<grid, fav::kThreads, smem, s>>>(
      static_cast<const uint8_t*>(u8), static_cast<const float*>(dl), static_cast<T*>(adv),
      static_cast<uint8_t*>(mask2), clip_n, dl_stride, row_len, Tn, CH, lo, hi);
  return int(cudaGetLastError());
}

}  // namespace

// u8 [rows of T frames, row_len = H'*W'*CH each], n elements in all; dl
// [T,CH] f32 shared by every row (clips = 0), or [clips,T,CH], one a clip of
// n / clips = T*row_len elements; adv in `dtype`; mask2 uint8 or null.
FAV_API int fav_emit_adv_mask(const void* u8, const void* dl, void* adv, void* mask2, int64_t n,
                              int64_t row_len, int64_t T, int64_t CH, int64_t clips, float lo,
                              float hi, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (row_len <= 0 || CH <= 0 || row_len % CH || T <= 0 || clips < 0)
    return int(cudaErrorInvalidValue);
  if (clips > 0 && n != clips * T * row_len) return int(cudaErrorInvalidValue);
  const int64_t rows = clips > 0 ? clips : 1, clip_n = clips > 0 ? T * row_len : n;
  const int64_t dl_stride = clips > 0 ? T * CH : 0;
  if (dtype == fav::kBF16)
    return emit_launch<__nv_bfloat16>(u8, dl, adv, mask2, rows, clip_n, dl_stride, row_len, int(T),
                                      int(CH), lo, hi, s);
  if (dtype == fav::kF32)
    return emit_launch<float>(u8, dl, adv, mask2, rows, clip_n, dl_stride, row_len, int(T),
                              int(CH), lo, hi, s);
  return int(cudaErrorInvalidValue);
}
