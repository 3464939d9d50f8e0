// B5: the (1,3,3)/(1,2,2) SAME spatial max pool forward, pads (0,1), on
// NDHWC [B,T,H,W,C] with even H and W (MaxPool3d_2a, 3a and the spatial half
// of 4a).
//
// Replaces the Pallas kernel ops/pallas_pool.py:206 `_strided_fwd_kernel` as
// ops/stem_tmajor.py:718 `strided_pool_view` launches it (pallas_call :754).
// The same function is B5b (ops/pallas_pool.py:263 strided_spatial_pool_conv)
// and B11 (:742 spatial_pool_132) in other TPU layouts.
//
//   y[n,ho,wo,c] = max_{r in 2ho..2ho+2, s in 2wo..2wo+2, in range} x[n,r,s,c]
//
// Bound on the H100: bytes (read x once, write y = x/4).  Design: one thread
// per output, channels fastest; the 9 loads of a warp are coalesced rows and
// the overlapping row/column is shared through L1.
//
// B6: the same pool's first-match backward, one pass.  Replaces the Pallas
// kernel ops/pool_s2_view_pallas.py:246 s2_pool_view_bwd_pallas (`_bwd_kernel`
// :71), which the JAX package keeps gated off (its default is XLA's
// select-and-scatter); the port runs it on the main path.  A window's
// cotangent goes to its first maximal element in H-then-W raster order; a
// cell, in up to 2x2 windows, sums their contributions in f32 and rounds once
// (the TPU kernel adds in the cotangent dtype): exact on integer grids in
// f32, within bf16 rounding otherwise.  Bound by bytes (read x and dy, write
// dx).  Design: a block owns an 8x8-cell spatial tile of one frame and 32
// channels (threadIdx.x = channel), stages the 11x11 x positions its 5x5
// windows read in shared memory, computes each window's argmax once, then
// each cell gathers from the windows that chose it.

#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(fav::kThreads)
pool_s2_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n_out, int H, int W,
                   int C) {
  const int Ho = H / 2, Wo = W / 2;
  for (int64_t i = fav::global_tid(); i < n_out; i += fav::grid_stride()) {
    const int c = int(i % C);
    int64_t r = i / C;
    const int wo = int(r % Wo);
    r /= Wo;
    const int ho = int(r % Ho);
    const int64_t nt = r / Ho;
    const T* base = x + nt * H * int64_t(W) * C + c;
    float m = -INFINITY;
#pragma unroll
    for (int dr = 0; dr < 3; ++dr) {
      const int rr = 2 * ho + dr;
      if (rr >= H) continue;  // the (0,1) pad
#pragma unroll
      for (int ds = 0; ds < 3; ++ds) {
        const int ss = 2 * wo + ds;
        if (ss < W) m = fmaxf(m, fav::to_f(base[(int64_t(rr) * W + ss) * C]));
      }
    }
    y[i] = fav::from_f<T>(m);
  }
}

constexpr int BT = 8, BC = 32, BROWS = 8;     // cell tile, channels, threadIdx.y
constexpr int NX = BT + 3, NWIN = BT / 2 + 1;  // staged x positions, windows per axis

template <typename T>
__global__ void __launch_bounds__(BC * BROWS)
pool_s2_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                   int H, int W, int C) {
  __shared__ T xs[NX * NX * BC];
  __shared__ unsigned char am[NWIN * NWIN * BC];
  const int Ho = H / 2, Wo = W / 2;
  const int n_c = (C + BC - 1) / BC, n_w = (W + BT - 1) / BT, n_h = (H + BT - 1) / BT;
  int64_t blk = blockIdx.x;
  const int c = int(blk % n_c) * BC + threadIdx.x;
  blk /= n_c;
  const int w0 = int(blk % n_w) * BT;
  blk /= n_w;
  const int h0 = int(blk % n_h) * BT;
  const int64_t nt = blk / n_h;  // (b, t)
  const bool c_ok = c < C;
  const int lane = threadIdx.x;
  const T* xb = x + nt * H * int64_t(W) * C + c;
  // staged (i, j) is cell (h0-2+i, w0-2+j); -inf outside the frame
  for (int pos = threadIdx.y; pos < NX * NX; pos += BROWS) {
    const int h = h0 - 2 + pos / NX, w = w0 - 2 + pos % NX;
    T v = fav::from_f<T>(-INFINITY);
    if (c_ok && h >= 0 && h < H && w >= 0 && w < W) v = xb[(int64_t(h) * W + w) * C];
    xs[pos * BC + lane] = v;
  }
  __syncthreads();
  // window (i, j) is output (h0/2-1+i, w0/2-1+j): staged rows 2i..2i+2, cols 2j..2j+2
  for (int pos = threadIdx.y; pos < NWIN * NWIN; pos += BROWS) {
    const int i = pos / NWIN, j = pos % NWIN;
    float best = -INFINITY;
    int arg = 255;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const float u = fav::to_f(xs[((2 * i + k / 3) * NX + 2 * j + k % 3) * BC + lane]);
      if (u > best) {  // strict: the earliest maximum keeps the window
        best = u;
        arg = k;
      }
    }
    am[pos * BC + lane] = static_cast<unsigned char>(arg);
  }
  __syncthreads();
  if (!c_ok) return;
  const T* dyb = dy + nt * Ho * int64_t(Wo) * C + c;
  T* dxb = dx + nt * H * int64_t(W) * C + c;
  for (int pos = threadIdx.y; pos < BT * BT; pos += BROWS) {
    const int p = pos / BT + 2, q = pos % BT + 2;  // staged coordinates of the cell
    const int h = h0 + p - 2, w = w0 + q - 2;
    if (h >= H || w >= W) continue;
    float acc = 0.f;
#pragma unroll
    for (int di = 0; di < 2; ++di) {
      const int i = p / 2 - 1 + di;  // windows with 2i <= p <= 2i+2
      const int ho = h0 / 2 - 1 + i;
      if (i < 0 || ho < 0 || ho >= Ho) continue;
#pragma unroll
      for (int dj = 0; dj < 2; ++dj) {
        const int j = q / 2 - 1 + dj;
        const int wo = w0 / 2 - 1 + j;
        if (j < 0 || wo < 0 || wo >= Wo) continue;
        const int k = (p - 2 * i) * 3 + (q - 2 * j);
        if (p - 2 * i > 2 || q - 2 * j > 2) continue;
        if (am[(i * NWIN + j) * BC + lane] == k) acc += fav::to_f(dyb[(int64_t(ho) * Wo + wo) * C]);
      }
    }
    dxb[(int64_t(h) * W + w) * C] = fav::from_f<T>(acc);
  }
}

}  // namespace

FAV_API int fav_pool_s2_fwd(const void* x, void* y, int64_t N, int64_t H, int64_t W, int64_t C,
                            int dtype, void* stream) {
  if ((H % 2) || (W % 2)) return int(cudaErrorInvalidValue);
  const int64_t n = N * (H / 2) * (W / 2) * C;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fav::kBF16) {
    pool_s2_fwd_kernel<__nv_bfloat16><<<fav::grid_for(n), fav::kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), n, int(H), int(W),
        int(C));
  } else if (dtype == fav::kF32) {
    pool_s2_fwd_kernel<float><<<fav::grid_for(n), fav::kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n, int(H), int(W), int(C));
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

FAV_API int fav_pool_s2_bwd(const void* x, const void* dy, void* dx, int64_t N, int64_t H,
                            int64_t W, int64_t C, int dtype, void* stream) {
  if ((H % 2) || (W % 2)) return int(cudaErrorInvalidValue);
  const int64_t blocks = N * ((H + BT - 1) / BT) * ((W + BT - 1) / BT) * ((C + BC - 1) / BC);
  const dim3 threads(BC, BROWS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fav::kBF16) {
    pool_s2_bwd_kernel<__nv_bfloat16><<<unsigned(blocks), threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
        static_cast<__nv_bfloat16*>(dx), int(H), int(W), int(C));
  } else if (dtype == fav::kF32) {
    pool_s2_bwd_kernel<float><<<unsigned(blocks), threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), static_cast<float*>(dx),
        int(H), int(W), int(C));
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
