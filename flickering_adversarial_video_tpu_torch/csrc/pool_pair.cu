// B9: the (1,3,3)/(1,2,2) SAME spatial max pool, pads (0,1), as a PAIR: the
// forward also stores each window's first-match argmax index, and the
// backward routes dy by that index alone, without reading x.  NDHWC
// [B,T,H,W,C] with even H and W (MaxPool3d_2a, MaxPool3d_3a).
//
// Replaces the Pallas pair ops/pallas_pool.py:474 `strided_spatial_pool_pair`:
// `_pair_fwd_kernel` :397 (pallas_call :504) and `_pair_bwd_kernel` :429
// (pallas_call :544).
//
// Forward:
//   y[n,a,b,c]   = max_k cand_k,  cand_k = x[n, 2a + k/3, 2b + k%3, c] for
//                  k = 0..8 in row-major window order, -inf outside the frame;
//                  a NaN candidate makes y NaN (jnp.maximum's rule)
//   idx[n,a,b,c] = the smallest k with cand_k == y compared in f32 (XLA's GE
//                  select rule), 9 where none matches (y is NaN)
// The TPU kernel stored idx as bf16 because Mosaic lacks sub-word compares;
// here it is one byte.  A null idx pointer (a forward that needs no gradient)
// writes values only.  Bound on the H100: bytes (read x, write y = x/4 and one
// byte an output).  Design: B5's H-marching full-width strip
// (csrc/pool_s2_strip.cuh): two x rows a step staged by cp.async, separable
// maxima on 16-byte channel vectors; then each of the thread's 8 (bf16) or 4
// (f32) channels compares its 9 staged taps in f32 with y, and the thread
// stores their index bytes as one 8- or 4-byte store.  W <= 1024.
//
// Backward:
//   dx[n,h,w,c] = sum over the <=4 windows (a,b) that hold the cell of
//                 dy[n,a,b,c] * [idx[n,a,b,c] == (h-2a)*3 + (w-2b)]
// Window a-1 of row 0 and b-1 of column 0 do not exist.  Bound by bytes (read
// dy and idx, write dx = 4 dy): no x, no argmax recompute, no shared memory.
// Design: a gather, no atomics and no scatter: one thread owns the 2x2 cell
// block (2a..2a+1, 2b..2b+1) of one channel, reads the four windows (a,b),
// (a,b-1), (a-1,b), (a-1,b-1) that can reach it and writes each of its four
// cells exactly once (0 where no window chose the cell).  The <=4 terms of a
// cell are summed in f32 in ascending k and rounded once; the TPU kernel adds
// in the cotangent dtype (:454-457).  Exact on f32 integer grids.

#include "pool_s2_strip.cuh"

namespace {

template <typename T, bool VEC, bool IDX>
__global__ void __launch_bounds__(fav::strip::kMaxThreads)
pool_pair_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, unsigned char* __restrict__ idx,
                     int H, int W, int C, int nv, int groups, int rows, int runs) {
  fav::strip::fwd<T, VEC, IDX>(x, y, idx, H, W, C, nv, groups, rows, runs);
}

template <typename T, bool VEC, bool IDX>
int launch_fwd(const void* x, void* y, void* idx, int64_t N, int64_t H, int64_t W, int64_t C,
               cudaStream_t s) {
  if (N == 0 || H == 0 || C == 0) return 0;
  const auto p = fav::strip::fwd_plan<pool_pair_fwd_kernel<T, VEC, IDX>, T>(N, H, W, C);
  pool_pair_fwd_kernel<T, VEC, IDX><<<unsigned(p.blocks), p.threads, p.smem, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<unsigned char*>(idx), int(H),
      int(W), int(C), p.nv, int(p.groups), int(p.rows), int(p.runs));
  return int(cudaGetLastError());
}

template <typename T>
int launch_fwd(const void* x, void* y, void* idx, int64_t N, int64_t H, int64_t W, int64_t C,
               cudaStream_t s) {
  const bool vec = C % fav::kVec<T> == 0 && fav::aligned16(x) && fav::aligned16(y) &&
                   (idx == nullptr || fav::aligned16(idx));
  if (idx == nullptr)
    return vec ? launch_fwd<T, true, false>(x, y, idx, N, H, W, C, s)
               : launch_fwd<T, false, false>(x, y, idx, N, H, W, C, s);
  return vec ? launch_fwd<T, true, true>(x, y, idx, N, H, W, C, s)
             : launch_fwd<T, false, true>(x, y, idx, N, H, W, C, s);
}

template <typename T>
__global__ void __launch_bounds__(fav::kThreads)
pool_pair_bwd_kernel(const unsigned char* __restrict__ idx, const T* __restrict__ dy,
                     T* __restrict__ dx, int64_t n_out, int Ho, int Wo, int C) {
  const int W = 2 * Wo;
  for (int64_t i = fav::global_tid(); i < n_out; i += fav::grid_stride()) {
    const int c = int(i % C);
    int64_t r = i / C;
    const int b = int(r % Wo);
    r /= Wo;
    const int a = int(r % Ho);
    const int64_t nt = r / Ho;
    const bool up = a > 0, left = b > 0;
    const int64_t row = int64_t(Wo) * C;
    // windows (a,b), (a,b-1), (a-1,b), (a-1,b-1); 255 matches no tap
    const int k_c = idx[i];
    const float g_c = fav::to_f(dy[i]);
    const int k_l = left ? idx[i - C] : 255;
    const float g_l = left ? fav::to_f(dy[i - C]) : 0.f;
    const int k_u = up ? idx[i - row] : 255;
    const float g_u = up ? fav::to_f(dy[i - row]) : 0.f;
    const int k_ul = (up && left) ? idx[i - row - C] : 255;
    const float g_ul = (up && left) ? fav::to_f(dy[i - row - C]) : 0.f;
    float ee = 0.f, eo = 0.f, oe = 0.f, oo = 0.f;  // ascending k within a cell
    ee += k_c == 0 ? g_c : 0.f;
    ee += k_l == 2 ? g_l : 0.f;
    ee += k_u == 6 ? g_u : 0.f;
    ee += k_ul == 8 ? g_ul : 0.f;
    eo += k_c == 1 ? g_c : 0.f;
    eo += k_u == 7 ? g_u : 0.f;
    oe += k_c == 3 ? g_c : 0.f;
    oe += k_l == 5 ? g_l : 0.f;
    oo += k_c == 4 ? g_c : 0.f;
    T* cell = dx + ((nt * (2 * Ho) + 2 * a) * int64_t(W) + 2 * b) * C + c;
    cell[0] = fav::from_f<T>(ee);
    cell[C] = fav::from_f<T>(eo);
    cell[int64_t(W) * C] = fav::from_f<T>(oe);
    cell[int64_t(W) * C + C] = fav::from_f<T>(oo);
  }
}

}  // namespace

FAV_API int fav_pool_pair_fwd(const void* x, void* y, void* idx, int64_t N, int64_t H, int64_t W,
                              int64_t C, int dtype, void* stream) {
  if ((H % 2) || (W % 2) || W / 2 > fav::strip::kMaxThreads) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fav::kBF16) return launch_fwd<__nv_bfloat16>(x, y, idx, N, H, W, C, s);
  if (dtype == fav::kF32) return launch_fwd<float>(x, y, idx, N, H, W, C, s);
  return int(cudaErrorInvalidValue);
}

// idx, dy [N,Ho,Wo,C] -> dx [N,2Ho,2Wo,C]
FAV_API int fav_pool_pair_bwd(const void* idx, const void* dy, void* dx, int64_t N, int64_t Ho,
                              int64_t Wo, int64_t C, int dtype, void* stream) {
  const int64_t n = N * Ho * Wo * C;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned char* ix = static_cast<const unsigned char*>(idx);
  if (dtype == fav::kBF16) {
    pool_pair_bwd_kernel<__nv_bfloat16><<<fav::grid_for(n), fav::kThreads, 0, s>>>(
        ix, static_cast<const __nv_bfloat16*>(dy), static_cast<__nv_bfloat16*>(dx), n, int(Ho),
        int(Wo), int(C));
  } else if (dtype == fav::kF32) {
    pool_pair_bwd_kernel<float><<<fav::grid_for(n), fav::kThreads, 0, s>>>(
        ix, static_cast<const float*>(dy), static_cast<float*>(dx), n, int(Ho), int(Wo), int(C));
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
