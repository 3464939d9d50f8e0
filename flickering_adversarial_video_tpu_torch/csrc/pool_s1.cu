// B3 and B4: the stride-1 3x3x3 SAME max pool (the Inception branch_3 pool),
// forward and first-match backward, on NDHWC [B,T,H,W,C].
//
// Replace the Pallas kernels ops/pool_s1_view_pallas.py:331 `_fwd_impl`
// (`_fwd_kernel` :140) and :370 `_bwd_impl` (`_bwd_kernel` :166), the two
// halves of the public VJP `s1_pool333_view_pallas` (:427).
//
// Forward: y = max over the 27 neighbours in range (-inf SAME pads).
// Backward: dx[c] = sum of dy[o] over the <=27 windows o that contain cell c
// and whose first maximal element in raster (t, h, w) order is c -- the cell
// that routing T, then H, then W first-match selects.  The residual is x only.
// Sums run in f32 over the windows in a fixed order and are rounded once:
// exact on integer grids in f32, within bf16 rounding of the staged
// cotangent-dtype adds of the TPU kernel otherwise.
//
// Bound on the H100: bytes (forward: read x, write y; backward: read x and
// dy, write dx).  Design: shared-memory tiles (below); each cell's 27
// neighbours and each window's argmax are read from the staged tile, and the
// argmax of a window is computed once per tile, so no thread rescans windows
// (a per-cell rescan from global memory diverges within warps).

#include "common.cuh"

namespace {

// Both kernels tile the volume the same way: a block owns TT x TH x TW cells
// of one batch element and CT channels (threadIdx.x = channel, so every
// global access is a coalesced run of channels) and stages the x it needs,
// with a halo, in shared memory in x's own dtype (-inf outside the volume).
constexpr int TT = 2, TH = 4, TW = 8, CT = 32, ROWS = 8;

struct Tile {
  int t0, h0, w0, c;
  int64_t b;
  bool c_ok;
};

__device__ __forceinline__ Tile tile_of(int T_, int H, int W, int C) {
  const int n_ct = (C + CT - 1) / CT, n_tw = (W + TW - 1) / TW, n_th = (H + TH - 1) / TH;
  const int n_tt = (T_ + TT - 1) / TT;
  int64_t blk = blockIdx.x;
  Tile tl;
  tl.c = int(blk % n_ct) * CT + threadIdx.x;
  blk /= n_ct;
  tl.w0 = int(blk % n_tw) * TW;
  blk /= n_tw;
  tl.h0 = int(blk % n_th) * TH;
  blk /= n_th;
  tl.t0 = int(blk % n_tt) * TT;
  tl.b = blk / n_tt;
  tl.c_ok = tl.c < C;
  return tl;
}

__device__ __forceinline__ int64_t offset(const Tile& tl, int t, int h, int w, int T_, int H,
                                          int W, int C) {
  return (((tl.b * T_ + t) * H + h) * int64_t(W) + w) * C + tl.c;
}

// xs[(a*SH + p)*SW + q][lane] = x at cell (t0-HALO+a, h0-HALO+p, w0-HALO+q)
template <int HALO, typename T>
__device__ __forceinline__ void stage(T* xs, const T* __restrict__ x, const Tile& tl, int T_,
                                      int H, int W, int C) {
  constexpr int ST = TT + 2 * HALO, SH = TH + 2 * HALO, SW = TW + 2 * HALO;
  constexpr int N = ST * SH * SW;
  static_assert(N % ROWS == 0, "staging rows must divide the tile");
  const T neg = fav::from_f<T>(-INFINITY);
#pragma unroll 6
  for (int pos = threadIdx.y; pos < N; pos += ROWS) {
    const int q = pos % SW, p = (pos / SW) % SH, a = pos / (SW * SH);
    const int t = tl.t0 - HALO + a, h = tl.h0 - HALO + p, w = tl.w0 - HALO + q;
    T v = neg;
    if (tl.c_ok && t >= 0 && t < T_ && h >= 0 && h < H && w >= 0 && w < W)
      v = x[offset(tl, t, h, w, T_, H, W, C)];
    xs[pos * CT + threadIdx.x] = v;
  }
}

template <typename T>
constexpr size_t fwd_smem() {
  return size_t(TT + 2) * (TH + 2) * (TW + 2) * CT * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(CT * ROWS)
pool_s1_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int T_, int H, int W, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  constexpr int SH = TH + 2, SW = TW + 2;
  const Tile tl = tile_of(T_, H, W, C);
  stage<1>(xs, x, tl, T_, H, W, C);
  __syncthreads();
  if (!tl.c_ok) return;
  for (int pos = threadIdx.y; pos < TT * TH * TW; pos += ROWS) {
    const int q = pos % TW, p = (pos / TW) % TH, a = pos / (TW * TH);
    const int t = tl.t0 + a, h = tl.h0 + p, w = tl.w0 + q;
    if (t >= T_ || h >= H || w >= W) continue;
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < 27; ++k)
      m = fmaxf(m, fav::to_f(xs[(((a + k / 9) * SH + p + (k / 3) % 3) * SW + q + k % 3) * CT +
                                threadIdx.x]));
    y[offset(tl, t, h, w, T_, H, W, C)] = fav::from_f<T>(m);
  }
}

// Backward: x staged with a halo of 2; the first-match argmax (0..26, raster
// order) of every output window whose centre lies within 1 of the tile goes
// to shared memory once; then each cell sums dy over the windows whose argmax
// is that cell.
constexpr int OT = TT + 2, OH = TH + 2, OW = TW + 2;  // output windows

template <typename T>
constexpr size_t bwd_smem() {
  return size_t(TT + 4) * (TH + 4) * (TW + 4) * CT * sizeof(T) + size_t(OT) * OH * OW * CT;
}

template <typename T>
__global__ void __launch_bounds__(CT * ROWS)
pool_s1_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                   int T_, int H, int W, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int XH = TH + 4, XW = TW + 4;
  T* xs = reinterpret_cast<T*>(smem);
  unsigned char* am = smem + size_t(TT + 4) * XH * XW * CT * sizeof(T);  // [OT][OH][OW][CT]
  const Tile tl = tile_of(T_, H, W, C);
  const int lane = threadIdx.x;
  stage<2>(xs, x, tl, T_, H, W, C);
  __syncthreads();
  // argmax of the window centred at output (t0-1+a, h0-1+p, w0-1+q)
  for (int pos = threadIdx.y; pos < OT * OH * OW; pos += ROWS) {
    const int q = pos % OW, p = (pos / OW) % OH, a = pos / (OW * OH);
    float best = -INFINITY;
    int arg = 255;
#pragma unroll
    for (int k = 0; k < 27; ++k) {
      const float u =
          fav::to_f(xs[(((a + k / 9) * XH + p + (k / 3) % 3) * XW + q + k % 3) * CT + lane]);
      if (u > best) {  // strict: the earliest maximum keeps the window
        best = u;
        arg = k;
      }
    }
    am[pos * CT + lane] = static_cast<unsigned char>(arg);
  }
  __syncthreads();
  if (!tl.c_ok) return;
  for (int pos = threadIdx.y; pos < TT * TH * TW; pos += ROWS) {
    const int q = pos % TW, p = (pos / TW) % TH, a = pos / (TW * TH);
    const int t = tl.t0 + a, h = tl.h0 + p, w = tl.w0 + q;
    if (t >= T_ || h >= H || w >= W) continue;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 27; ++k) {  // output o = cell + (1,1,1) - offset(k)
      const int ot = t + 1 - k / 9, oh = h + 1 - (k / 3) % 3, ow = w + 1 - k % 3;
      if (ot < 0 || ot >= T_ || oh < 0 || oh >= H || ow < 0 || ow >= W) continue;
      const int wpos = ((ot - tl.t0 + 1) * OH + (oh - tl.h0 + 1)) * OW + (ow - tl.w0 + 1);
      if (am[wpos * CT + lane] == k) acc += fav::to_f(dy[offset(tl, ot, oh, ow, T_, H, W, C)]);
    }
    dx[offset(tl, t, h, w, T_, H, W, C)] = fav::from_f<T>(acc);
  }
}

int64_t n_tiles(int64_t B, int64_t T, int64_t H, int64_t W, int64_t C) {
  return B * ((T + TT - 1) / TT) * ((H + TH - 1) / TH) * ((W + TW - 1) / TW) * ((C + CT - 1) / CT);
}

template <typename T>
int launch_fwd(const void* x, void* y, int64_t B, int64_t T_, int64_t H, int64_t W, int64_t C,
               cudaStream_t s) {
  pool_s1_fwd_kernel<T><<<unsigned(n_tiles(B, T_, H, W, C)), dim3(CT, ROWS), fwd_smem<T>(), s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), int(T_), int(H), int(W), int(C));
  return int(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* dy, void* dx, int64_t B, int64_t T_, int64_t H,
               int64_t W, int64_t C, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(pool_s1_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(bwd_smem<T>()));
  if (err != cudaSuccess) return int(err);
  pool_s1_bwd_kernel<T><<<unsigned(n_tiles(B, T_, H, W, C)), dim3(CT, ROWS), bwd_smem<T>(), s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx), int(T_), int(H),
      int(W), int(C));
  return int(cudaGetLastError());
}

}  // namespace

FAV_API int fav_pool_s1_fwd(const void* x, void* y, int64_t B, int64_t T, int64_t H, int64_t W,
                            int64_t C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fav::kBF16) return launch_fwd<__nv_bfloat16>(x, y, B, T, H, W, C, s);
  if (dtype == fav::kF32) return launch_fwd<float>(x, y, B, T, H, W, C, s);
  return int(cudaErrorInvalidValue);
}

FAV_API int fav_pool_s1_bwd(const void* x, const void* dy, void* dx, int64_t B, int64_t T,
                            int64_t H, int64_t W, int64_t C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fav::kBF16) return launch_bwd<__nv_bfloat16>(x, dy, dx, B, T, H, W, C, s);
  if (dtype == fav::kF32) return launch_bwd<float>(x, dy, dx, B, T, H, W, C, s);
  return int(cudaErrorInvalidValue);
}
