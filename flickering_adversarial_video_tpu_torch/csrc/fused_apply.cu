// B8: fused uint8 decode + normalize + flicker apply + clip, and its backward.
//
// Replaces the Pallas kernels of ops/fused_apply.py of the JAX package:
// forward `_fwd_kernel` :68 (fused_normalize_perturb :132, pallas_call :144),
// backward `_bwd_kernel` :86 (`_bwd` :172, pallas_call :184).
//
//   forward:  out[b,t,h,w,c] = clip(u8/128 - 1 + flag*delta[t,c], -1, 1)   f32
//   backward: dd[t,c] = flag * sum_{b,h,w} g[b,t,h,w,c] * m(pre)            f32
//             m = 1 inside (-1, 1), 0 outside, and on a bound 0 or 1/2 (`strict`)
//
// The bounds are the literals -1 and 1.  The backward's rule at an exact
// bound is a launch argument, `strict`, since the JAX function's gradient
// depends on its geometry: where its `_supported` holds (H*W*C % 128 == 0,
// B*T % 8 == 0, Mosaic's block constraints) the Pallas backward masks
// strictly, 0 at a bound; elsewhere it runs jnp.clip, whose gradient there is
// g/2 (as the emitter B7's mask gives).  u8 value 0 under delta 0 sits exactly
// on -1.  g/2 is exact in f32, so the rule changes no rounding.  This kernel
// runs at every geometry; the wrapper picks the rule (ops/fused_apply.py).
//
// Both are bound by bytes on the H100 (forward: 1 read + 4 written per
// element; backward: 5 read).
//
// Forward design: as B7 -- 16 consecutive elements per thread (one 16-byte
// load, four 16-byte stores), the channel and frame from a cursor over the
// element index, flag*delta [T,C] in shared memory (the product is rounded on
// its own, then added: the arithmetic of `x + flag*delta`, with no fused
// multiply-add).  The last n % 16 elements go one a thread after the vectors.
// The tensors' bases must be 16-byte aligned, as every torch allocation is;
// otherwise the launch is refused (cudaErrorMisalignedAddress).
//
// Backward design: deterministic, no float atomics.  A row (b,t) of H*W*C
// elements is contiguous, so a block takes a slice of ONE row: t is a block
// constant, c is the element index mod C, and every thread keeps kMaxC f32
// accumulators.  The block reduces them in a fixed order (warp shuffles, then
// the warps in order) and writes C partials; a second small kernel sums the
// partials of each (t,c) over (b, slice) in a fixed order and applies the
// flag.  The same input therefore gives the same bits on every run.
//
// B8c, a delta a clip (the vectorized sweep's slots: clip b of the batch has
// its own delta [B,T,C]; the JAX sweep vmaps fused_normalize_perturb over the
// slots, so the rule is that of one clip's geometry):
// the same kernel bodies with a delta clip stride, T*C, where the shared
// delta's is 0.  The forward's grid.y is the clip, whose block stages only
// its own flag*delta row (T*C f32 of shared memory whatever B is); its
// vectors lie in one clip, so they start on 16-byte boundaries when a clip's
// T*H*W*C elements are a multiple of 16, and otherwise every element of the
// clip goes one a thread.  The backward's partial kernel reads delta row b
// for row (b,t); its final kernel sums each clip's partials apart, over the
// slices only, to dd [B,T,C].  A clip's forward and d(delta) are therefore
// bit for bit those of the shared-delta launch on that clip alone (the same
// per-element arithmetic; the same partials, summed in the same order).
// B8c has launchers and __global__ names of its own, so that a profiler
// counts its launches apart from B8's.

#include "common.cuh"

namespace {

constexpr int kMaxC = 4;            // accumulators per thread in the backward
constexpr int kSlice = 16 * fav::kThreads * 4;  // elements of a row per block

__device__ __forceinline__ float fwd_one(uint8_t u, float fd) {
  const float pre = __fadd_rn(float(u) * (1.0f / 128.0f) - 1.0f, fd);
  return fminf(fmaxf(pre, -1.0f), 1.0f);
}

// block (x, b) works in clip b: clip_n elements from b*clip_n, flag*delta
// from row b at b*d_stride (the shared delta: one clip, the whole tensor,
// d_stride 0); sfd holds T*C f32
__device__ __forceinline__ void fwd_body(const uint8_t* __restrict__ u8,
                                         const float* __restrict__ delta,
                                         const float* __restrict__ flag, float* __restrict__ out,
                                         int64_t clip_n, int64_t d_stride, int64_t row_len,
                                         int Tn, int C, float* sfd) {
  const int64_t b = blockIdx.y;
  const float f = *flag;
  const float* d = delta + b * d_stride;
  for (int k = threadIdx.x; k < Tn * C; k += blockDim.x) sfd[k] = __fmul_rn(f, d[k]);
  __syncthreads();
  const uint8_t* u = u8 + b * clip_n;
  float* o = out + b * clip_n;
  // vectors only where every clip starts on a 16-byte boundary
  const int64_t n_vec = d_stride == 0 || clip_n % 16 == 0 ? clip_n / 16 : 0;
  for (int64_t v = fav::global_tid(); v < n_vec; v += fav::grid_stride()) {
    const int64_t i0 = v * 16;
    const uint4 raw = *reinterpret_cast<const uint4*>(u + i0);
    const uint8_t* ub = reinterpret_cast<const uint8_t*>(&raw);
    fav::RowCursor cur(i0, row_len, Tn, C);
    alignas(16) float a[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      a[j] = fwd_one(ub[j], sfd[cur.t * C + cur.c]);
      cur.next();
    }
    float4* dst = reinterpret_cast<float4*>(o + i0);
    const float4* src = reinterpret_cast<const float4*>(a);
#pragma unroll
    for (int q = 0; q < 4; ++q) dst[q] = src[q];
  }
  // the rest (the last clip_n % 16 elements, or a clip's all), one a thread
  for (int64_t i = n_vec * 16 + fav::global_tid(); i < clip_n; i += fav::grid_stride()) {
    const fav::RowCursor cur(i, row_len, Tn, C);
    o[i] = fwd_one(u[i], sfd[cur.t * C + cur.c]);
  }
}

__global__ void __launch_bounds__(fav::kThreads)
fused_apply_fwd_kernel(const uint8_t* __restrict__ u8, const float* __restrict__ delta,
                       const float* __restrict__ flag, float* __restrict__ out, int64_t n,
                       int64_t row_len, int Tn, int C) {
  extern __shared__ float sfd[];
  fwd_body(u8, delta, flag, out, n, 0, row_len, Tn, C, sfd);
}

// B8c forward: grid.y the clip, delta [clips,T,C]
__global__ void __launch_bounds__(fav::kThreads)
fused_apply_clips_fwd_kernel(const uint8_t* __restrict__ u8, const float* __restrict__ delta,
                             const float* __restrict__ flag, float* __restrict__ out,
                             int64_t clip_n, int64_t row_len, int Tn, int C) {
  extern __shared__ float sfd[];
  fwd_body(u8, delta, flag, out, clip_n, int64_t(Tn) * C, row_len, Tn, C, sfd);
}

// g inside (-1, 1); on a bound exactly 0 (strict) or g/2 (jnp.clip's); 0 outside
__device__ __forceinline__ void bwd_accumulate(float (&acc)[kMaxC], uint8_t u, float g, int c,
                                               const float (&fd)[kMaxC], bool strict) {
  float d = fd[0];
#pragma unroll
  for (int k = 1; k < kMaxC; ++k) d = c == k ? fd[k] : d;
  const float pre = __fadd_rn(float(u) * (1.0f / 128.0f) - 1.0f, d);
  const float edge = (!strict && (pre == 1.0f || pre == -1.0f)) ? 0.5f * g : 0.0f;
  const float v = (pre < 1.0f && pre > -1.0f) ? g : edge;
#pragma unroll
  for (int k = 0; k < kMaxC; ++k) acc[k] += c == k ? v : 0.0f;
}

// grid: rows * slices blocks; block (row, s) reduces elements
// [s*kSlice, min((s+1)*kSlice, row_len)) of its row (b,t) into
// partial[row, s, 0..C), with delta row b at b*d_stride (0: shared)
__device__ __forceinline__ void bwd_partial_body(const uint8_t* __restrict__ u8,
                                                 const float* __restrict__ delta,
                                                 const float* __restrict__ flag,
                                                 const float* __restrict__ g,
                                                 float* __restrict__ partial, int64_t row_len,
                                                 int slices, int Tn, int C, int64_t d_stride,
                                                 bool strict) {
  const int64_t row = blockIdx.x / slices;
  const int s = int(blockIdx.x % slices);
  const int t = int(row % Tn);
  const float* d = delta + (row / Tn) * d_stride;
  const float f = *flag;
  float fd[kMaxC], acc[kMaxC];
#pragma unroll
  for (int k = 0; k < kMaxC; ++k) {
    fd[k] = k < C ? __fmul_rn(f, d[t * C + k]) : 0.0f;
    acc[k] = 0.0f;
  }
  const int64_t lo = int64_t(s) * kSlice;
  const int64_t hi = (lo + kSlice < row_len) ? lo + kSlice : row_len;
  const uint8_t* urow = u8 + row * row_len;
  const float* grow = g + row * row_len;
  // rows of whole 16-element vectors start 16-byte aligned and are read as
  // such; any other row length is read element by element
  const int64_t vec_hi = row_len % 16 == 0 ? hi : lo;
  for (int64_t i0 = lo + int64_t(threadIdx.x) * 16; i0 < vec_hi; i0 += int64_t(blockDim.x) * 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(urow + i0);
    const uint8_t* ub = reinterpret_cast<const uint8_t*>(&raw);
    alignas(16) float gv[16];
    const float4* gsrc = reinterpret_cast<const float4*>(grow + i0);
#pragma unroll
    for (int q = 0; q < 4; ++q) reinterpret_cast<float4*>(gv)[q] = gsrc[q];
    int c = int(i0 % C);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      bwd_accumulate(acc, ub[j], gv[j], c, fd, strict);
      if (++c == C) c = 0;
    }
  }
  for (int64_t i = vec_hi + threadIdx.x; i < hi; i += blockDim.x)
    bwd_accumulate(acc, urow[i], grow[i], int(i % C), fd, strict);
  // fixed-order block reduction: shuffle tree within a warp, then warp 0..7
  __shared__ float warp_sum[fav::kThreads / 32][kMaxC];
#pragma unroll
  for (int k = 0; k < kMaxC; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < C) {
    float v = 0.0f;
    for (int w = 0; w < fav::kThreads / 32; ++w) v += warp_sum[w][threadIdx.x];
    partial[(row * slices + s) * C + threadIdx.x] = v;
  }
}

__global__ void __launch_bounds__(fav::kThreads)
fused_apply_bwd_partial_kernel(const uint8_t* __restrict__ u8, const float* __restrict__ delta,
                               const float* __restrict__ flag, const float* __restrict__ g,
                               float* __restrict__ partial, int64_t row_len, int slices, int Tn,
                               int C, int strict) {
  bwd_partial_body(u8, delta, flag, g, partial, row_len, slices, Tn, C, 0, strict != 0);
}

// B8c: delta [B,T,C], row (b,t) reads delta row b
__global__ void __launch_bounds__(fav::kThreads)
fused_apply_clips_bwd_partial_kernel(const uint8_t* __restrict__ u8,
                                     const float* __restrict__ delta,
                                     const float* __restrict__ flag, const float* __restrict__ g,
                                     float* __restrict__ partial, int64_t row_len, int slices,
                                     int Tn, int C, int strict) {
  bwd_partial_body(u8, delta, flag, g, partial, row_len, slices, Tn, C, int64_t(Tn) * C,
                   strict != 0);
}

// flag * the partials of (t,c) summed over clips [b0, b1), then slices, in order
__device__ __forceinline__ float final_sum(const float* __restrict__ partial, float flag,
                                           int64_t b0, int64_t b1, int slices, int Tn, int C,
                                           int t, int c) {
  float v = 0.0f;
  for (int64_t b = b0; b < b1; ++b) {
    const float* p = partial + ((b * Tn + t) * slices) * C + c;
    for (int s = 0; s < slices; ++s) v += p[int64_t(s) * C];
  }
  return __fmul_rn(flag, v);
}

// One thread per (t,c): dd[t,c] = flag * sum over b, then slices, in order.
__global__ void __launch_bounds__(fav::kThreads)
fused_apply_bwd_final_kernel(const float* __restrict__ partial, const float* __restrict__ flag,
                             float* __restrict__ dd, int64_t B, int slices, int Tn, int C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Tn * C) return;
  dd[i] = final_sum(partial, *flag, 0, B, slices, Tn, C, i / C, i % C);
}

// B8c: one thread per (b,t,c): dd[b,t,c] = flag * the sum of clip b's
// partials over the slices, in order
__global__ void __launch_bounds__(fav::kThreads)
fused_apply_clips_bwd_final_kernel(const float* __restrict__ partial,
                                   const float* __restrict__ flag, float* __restrict__ dd,
                                   int64_t B, int slices, int Tn, int C) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= B * Tn * C) return;
  const int64_t b = i / (int64_t(Tn) * C);
  const int r = int(i - b * Tn * C);
  dd[i] = final_sum(partial, *flag, b, b + 1, slices, Tn, C, r / C, r % C);
}

int fwd_launch(const void* u8, const void* delta, const void* flag, void* out, int64_t B,
               int64_t T, int64_t row_len, int64_t C, bool per_clip, cudaStream_t s) {
  const int64_t n = B * T * row_len;
  if (n == 0) return 0;
  const size_t smem = size_t(T) * C * sizeof(float);
  if (C <= 0 || T <= 0 || row_len % C || smem > 48 * 1024 || (per_clip && B > 65535))
    return int(cudaErrorInvalidValue);
  if (!fav::aligned16(u8) || !fav::aligned16(out)) return int(cudaErrorMisalignedAddress);
  const uint8_t* u = static_cast<const uint8_t*>(u8);
  const float* d = static_cast<const float*>(delta);
  const float* f = static_cast<const float*>(flag);
  float* o = static_cast<float*>(out);
  if (per_clip) {
    const int64_t clip_n = T * row_len;
    const dim3 grid(fav::grid_for(clip_n / 16 + 1), unsigned(B));
    fused_apply_clips_fwd_kernel<<<grid, fav::kThreads, smem, s>>>(u, d, f, o, clip_n, row_len,
                                                                    int(T), int(C));
  } else {
    fused_apply_fwd_kernel<<<fav::grid_for(n / 16 + 1), fav::kThreads, smem, s>>>(
        u, d, f, o, n, row_len, int(T), int(C));
  }
  return int(cudaGetLastError());
}

int bwd_launch(const void* u8, const void* delta, const void* flag, const void* g,
               void* partial, void* dd, int64_t B, int64_t T, int64_t row_len, int64_t C,
               int64_t slices, int64_t strict, bool per_clip, cudaStream_t s) {
  if (C <= 0 || C > kMaxC || row_len % C || T <= 0 || B <= 0 || row_len <= 0)
    return int(cudaErrorInvalidValue);
  if (slices != (row_len + kSlice - 1) / kSlice || (strict != 0 && strict != 1))
    return int(cudaErrorInvalidValue);
  const int64_t blocks = B * T * slices;
  if (blocks > (int64_t(1) << 31) - 1) return int(cudaErrorInvalidValue);
  if (!fav::aligned16(u8) || !fav::aligned16(g)) return int(cudaErrorMisalignedAddress);
  const uint8_t* u = static_cast<const uint8_t*>(u8);
  const float* d = static_cast<const float*>(delta);
  const float* f = static_cast<const float*>(flag);
  const float* gp = static_cast<const float*>(g);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(dd);
  if (per_clip)
    fused_apply_clips_bwd_partial_kernel<<<unsigned(blocks), fav::kThreads, 0, s>>>(
        u, d, f, gp, p, row_len, int(slices), int(T), int(C), int(strict));
  else
    fused_apply_bwd_partial_kernel<<<unsigned(blocks), fav::kThreads, 0, s>>>(
        u, d, f, gp, p, row_len, int(slices), int(T), int(C), int(strict));
  int code = int(cudaGetLastError());
  if (code) return code;
  const int64_t n_out = (per_clip ? B : 1) * T * C;
  const unsigned grid = unsigned((n_out + fav::kThreads - 1) / fav::kThreads);
  if (per_clip)
    fused_apply_clips_bwd_final_kernel<<<grid, fav::kThreads, 0, s>>>(p, f, o, B, int(slices),
                                                                       int(T), int(C));
  else
    fused_apply_bwd_final_kernel<<<grid, fav::kThreads, 0, s>>>(p, f, o, B, int(slices), int(T),
                                                                 int(C));
  return int(cudaGetLastError());
}

}  // namespace

// u8 [B,T,row_len] (row_len = H*W*C), delta [T,C] f32, flag [1] f32 on the
// device, out f32 like u8.
FAV_API int fav_fused_apply_fwd(const void* u8, const void* delta, const void* flag, void* out,
                                int64_t B, int64_t T, int64_t row_len, int64_t C, void* stream) {
  return fwd_launch(u8, delta, flag, out, B, T, row_len, C, false,
                    static_cast<cudaStream_t>(stream));
}

// g f32 like u8; partial [B*T, slices, C] f32 scratch, slices =
// ceil(row_len / kSlice) (the wrapper's SLICE must equal kSlice); dd [T,C] f32;
// strict 1: 0 at an exact bound (the Pallas mask), 0: g/2 (jnp.clip's).
FAV_API int fav_fused_apply_bwd(const void* u8, const void* delta, const void* flag, const void* g,
                                void* partial, void* dd, int64_t B, int64_t T, int64_t row_len,
                                int64_t C, int64_t slices, int64_t strict, void* stream) {
  return bwd_launch(u8, delta, flag, g, partial, dd, B, T, row_len, C, slices, strict, false,
                    static_cast<cudaStream_t>(stream));
}

// B8c: as fav_fused_apply_fwd with delta [B,T,C], a row a clip.
FAV_API int fav_fused_apply_clips_fwd(const void* u8, const void* delta, const void* flag,
                                      void* out, int64_t B, int64_t T, int64_t row_len, int64_t C,
                                      void* stream) {
  return fwd_launch(u8, delta, flag, out, B, T, row_len, C, true,
                    static_cast<cudaStream_t>(stream));
}

// B8c: as fav_fused_apply_bwd with delta [B,T,C] and dd [B,T,C].
FAV_API int fav_fused_apply_clips_bwd(const void* u8, const void* delta, const void* flag,
                                      const void* g, void* partial, void* dd, int64_t B, int64_t T,
                                      int64_t row_len, int64_t C, int64_t slices, int64_t strict,
                                      void* stream) {
  return bwd_launch(u8, delta, flag, g, partial, dd, B, T, row_len, C, slices, strict, true,
                    static_cast<cudaStream_t>(stream));
}
