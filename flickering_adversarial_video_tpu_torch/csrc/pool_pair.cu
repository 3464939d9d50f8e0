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
// dy and idx, write dx = 4 dy; dx is 73% of them): no x, no argmax
// recompute.  The <=4 terms of a cell are summed in f32 in ascending k and
// rounded once; the TPU kernel adds in the cotangent dtype (:454-457).  Exact
// on f32 integer grids.  Design: the strip's launch geometry without x
// (below): every dy and index byte is read once from DRAM, every dx byte
// written once in 16-byte vectors that fill whole 32-byte sectors.

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

// ---- the backward ----------------------------------------------------------
//
// A block owns one frame n, one group of nv 16-byte channel vectors and a run
// of window rows [a0, a1) over the frame's full width: thread (cv, b) =
// (tid % nv, tid / nv) owns window column b and vector cv (8 bf16 or 4 f32
// channels, and their 8 or 4 index bytes).  The block marches down H one
// window row a step.  At step a a thread holds window (a,b) (loaded at step
// a-1: one 16-byte dy load and one 8- or 4-byte index load) and window
// (a-1,b) from the step before; it takes window (a,b-1) from its neighbour
// through a 2-slot shared-memory ring (one barrier a step), and (a-1,b-1) is
// the neighbour's window of the step before.  It then writes its four cells
// (2a..2a+1, 2b..2b+1) as four 16-byte streaming stores (st.global.cs: dx is
// never read back here).  A run after the first loads window row a0-1 first
// (its halo, a quarter of a step's bytes).  Runs minimise waves of resident
// blocks x steps a block, as the strip's forward does.
namespace b9 {

using namespace fav;  // the 16-byte channel vectors of common.cuh

using strip::kMaxThreads;

// One window's dy vector and its index bytes (a byte a channel: 8 for bf16,
// 4 for f32, the rest 255).  A missing window: dy 0, every index 255, which
// matches no tap.
struct Win {
  uint4 g;
  uint2 k;
};

__device__ __forceinline__ Win no_window() {
  return {make_uint4(0, 0, 0, 0), make_uint2(~0u, ~0u)};
}

__device__ __forceinline__ unsigned tap_of(const uint2& k, int j) {
  return ((j < 4 ? k.x : k.y) >> (8 * (j & 3))) & 255u;
}

template <typename T, bool VEC>
__device__ __forceinline__ Win load_win(const unsigned char* __restrict__ idx,
                                        const T* __restrict__ dy, int64_t off, int c0, int C) {
  Win w;
  if constexpr (VEC) {
    w.g = __ldcs(reinterpret_cast<const uint4*>(dy + off));
    if constexpr (kVec<T> == 8)
      w.k = __ldcs(reinterpret_cast<const uint2*>(idx + off));
    else
      w.k = make_uint2(__ldcs(reinterpret_cast<const unsigned*>(idx + off)), ~0u);
  } else {
    w.g = load_vec<T, false>(dy, off, c0, C, 0.f);
    uint32_t k[2] = {~0u, ~0u};
#pragma unroll
    for (int j = 0; j < kVec<T>; ++j) {
      const int sh = 8 * (j % 4);
      if (c0 + j < C) k[j / 4] = (k[j / 4] & ~(255u << sh)) | (uint32_t(idx[off + j]) << sh);
    }
    w.k = make_uint2(k[0], k[1]);
  }
  return w;
}

// s[j] += window w's dy where its index is tap k, channel by channel, in f32
template <typename T>
__device__ __forceinline__ void add_tap(float (&s)[kVec<T>], const Win& w, unsigned k) {
  float g[kVec<T>];
  unpack<T>(w.g, g);
#pragma unroll
  for (int j = 0; j < kVec<T>; ++j)
    if (tap_of(w.k, j) == k) s[j] += g[j];
}

// a cell's sum, rounded once: one 16-byte streaming store, or channel by
// channel up to C
template <typename T, bool VEC>
__device__ __forceinline__ void store_cell(T* __restrict__ out, int c0, int C,
                                           const float (&s)[kVec<T>]) {
  if constexpr (VEC) {
    __stcs(reinterpret_cast<uint4*>(out), pack_round<T>(s));
  } else {
#pragma unroll
    for (int j = 0; j < kVec<T>; ++j)
      if (c0 + j < C) out[j] = from_f<T>(s[j]);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
pool_pair_bwd_kernel(const unsigned char* __restrict__ idx, const T* __restrict__ dy,
                     T* __restrict__ dx, int Ho, int Wo, int C, int nv, int groups, int rows,
                     int runs) {
  constexpr int N = kVec<T>;
  // window (a, b) of every thread, by step parity: dy vectors and index bytes
  __shared__ uint4 ring_g[2][kMaxThreads];
  __shared__ uint2 ring_k[2][kMaxThreads];

  int64_t blk = blockIdx.x;
  const int g = int(blk % groups);
  blk /= groups;
  const int run = int(blk % runs);
  const int64_t n = blk / runs;
  const int a0 = run * rows, a1 = min(a0 + rows, Ho);
  const int tid = threadIdx.x, cv = tid % nv, b = tid / nv;
  const int c0 = (g * nv + cv) * N;
  const bool live = c0 < C;  // the vector holds channels
  const int W = 2 * Wo;
  const int64_t wrow = int64_t(Wo) * C;  // a window row, in elements
  const int64_t win0 = (n * Ho * int64_t(Wo) + b) * C + c0;
  T* dxn = dx + (n * (2 * int64_t(Ho)) * W + 2 * b) * C + c0;
  const int64_t down = int64_t(W) * C;

  auto load = [&](int a) {
    return live ? load_win<T, VEC>(idx, dy, win0 + a * wrow, c0, C) : no_window();
  };
  // window (a, b-1): the neighbour's entry of this step's slot
  auto left_of = [&](int slot) {
    return b > 0 ? Win{ring_g[slot][tid - nv], ring_k[slot][tid - nv]} : no_window();
  };
  auto publish = [&](int slot, const Win& w) {
    ring_g[slot][tid] = w.g;
    ring_k[slot][tid] = w.k;
  };

  Win up = no_window(), up_left = no_window();  // windows (a-1, b), (a-1, b-1)
  int slot = 0;
  if (a0 > 0) {  // the halo: window row a0-1
    up = load(a0 - 1);
    publish(slot, up);
    __syncthreads();
    up_left = left_of(slot);
    slot ^= 1;
  }
  Win cur = a0 < a1 ? load(a0) : no_window();
  for (int a = a0; a < a1; ++a, slot ^= 1) {
    const Win next = a + 1 < a1 ? load(a + 1) : no_window();
    // a thread rewrites this slot two steps on, after the barrier between
    // that every reader of it has passed
    publish(slot, cur);
    __syncthreads();
    const Win left = left_of(slot);
    if (live) {
      // each cell's terms from 0 in ascending k: (2a, 2b) k = 0 of (a,b), 2 of
      // (a,b-1), 6 of (a-1,b), 8 of (a-1,b-1); (2a, 2b+1) k = 1, 7; (2a+1, 2b)
      // k = 3, 5; (2a+1, 2b+1) k = 4
      T* out = dxn + 2 * int64_t(a) * down;
      {
        float s00[N] = {};
        add_tap<T>(s00, cur, 0);
        add_tap<T>(s00, left, 2);
        add_tap<T>(s00, up, 6);
        add_tap<T>(s00, up_left, 8);
        store_cell<T, VEC>(out, c0, C, s00);
      }
      {
        float s01[N] = {};
        add_tap<T>(s01, cur, 1);
        add_tap<T>(s01, up, 7);
        store_cell<T, VEC>(out + C, c0, C, s01);
      }
      {
        float s10[N] = {};
        add_tap<T>(s10, cur, 3);
        add_tap<T>(s10, left, 5);
        store_cell<T, VEC>(out + down, c0, C, s10);
      }
      float s11[N] = {};
      add_tap<T>(s11, cur, 4);
      store_cell<T, VEC>(out + down + C, c0, C, s11);
    }
    up_left = left;
    up = cur;
    cur = next;
  }
}

template <typename T, bool VEC>
int launch(const void* idx, const void* dy, void* dx, int64_t N, int64_t Ho, int64_t Wo, int64_t C,
           cudaStream_t s) {
  if (N == 0 || Ho == 0 || C == 0) return 0;
  const strip::Groups gr = strip::channel_groups(C, kVec<T>, Wo);
  const int threads = gr.nv * int(Wo);
  const int64_t tiles = N * gr.groups;
  const int64_t per_wave = strip::wave<pool_pair_bwd_kernel<T, VEC>>(threads, 0, 0);
  // a later run loads its halo row first: a quarter of a step's bytes
  int64_t rows, runs;
  strip::choose_runs(tiles, Ho, per_wave, 1, &rows, &runs);
  pool_pair_bwd_kernel<T, VEC><<<unsigned(tiles * runs), threads, 0, s>>>(
      static_cast<const unsigned char*>(idx), static_cast<const T*>(dy), static_cast<T*>(dx),
      int(Ho), int(Wo), int(C), gr.nv, int(gr.groups), int(rows), int(runs));
  return int(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* idx, const void* dy, void* dx, int64_t N, int64_t Ho, int64_t Wo,
               int64_t C, cudaStream_t s) {
  const bool vec = C % kVec<T> == 0 && aligned16(idx) && aligned16(dy) && aligned16(dx);
  return vec ? launch<T, true>(idx, dy, dx, N, Ho, Wo, C, s)
             : launch<T, false>(idx, dy, dx, N, Ho, Wo, C, s);
}

}  // namespace b9

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
  if (Wo > fav::strip::kMaxThreads) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fav::kBF16) return b9::launch_bwd<__nv_bfloat16>(idx, dy, dx, N, Ho, Wo, C, s);
  if (dtype == fav::kF32) return b9::launch_bwd<float>(idx, dy, dx, N, Ho, Wo, C, s);
  return int(cudaErrorInvalidValue);
}
