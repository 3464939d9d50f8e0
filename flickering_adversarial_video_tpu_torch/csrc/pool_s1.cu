// B3 and B4: the stride-1 3x3x3 SAME max pool (the Inception branch_3 pool),
// forward and first-match backward, on NDHWC [B,T,H,W,C].
//
// Replace the Pallas kernels ops/pool_s1_view_pallas.py:331 `_fwd_impl`
// (`_fwd_kernel` :140) and :370 `_bwd_impl` (`_bwd_kernel` :166), the two
// halves of the public VJP `s1_pool333_view_pallas` (:427).  The forward is
// also the function of ops/pallas_pool.py:664 `overlap_pool_333` in its three
// TPU blockings on b-major NDHWC (`_overlap_fwd_kernel` :132,
// `_overlap_fwd_kernel_blocked` :148, `_conv_fwd_kernel` :593), which this
// layout makes one.
//
// Forward: y = max over the 27 neighbours in range (-inf SAME pads); a NaN
// in the window gives NaN, as jnp.maximum does.
// Backward: the separable first match of the TPU kernel and of the plain
// version (ops/maxpool.py `max_pool_route_plain`).  With m_w the max of 3
// along W, m_hw the max of 3 m_w along H and y the max of 3 m_hw along T
// (NaN-propagating, -inf SAME pads), each window of each stage has a code:
// the first of its 3 taps equal to its maximum, or none when that is NaN.
// The cotangent goes back T, then H, then W: a position of each stage sums,
// for k = 0, 1, 2 in turn, the cotangent of the window at offset 1 - k whose
// code is k, in f32 from 0.  That is the plain version's arithmetic, so the
// kernel is bit-equal to it (for finite dy), in f32 and after the one
// rounding to bf16.  An all -inf window routes to its tap 0, dropped when
// that is a pad.  The residual is x only.
//
// Bound on the H100: bytes (forward: read x, write y; backward: read x and
// dy, write dx).  The forward stages x tiles with a halo in shared memory
// (below).  The backward's design follows its own section.

#include <algorithm>

#include "common.cuh"

namespace {

// The forward tiles the volume: a block owns TT x TH x TW cells
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
      m = fav::fmax_nan(m, fav::to_f(xs[(((a + k / 9) * SH + p + (k / 3) % 3) * SW + q + k % 3) *
                                            CT + threadIdx.x]));
    y[offset(tl, t, h, w, T_, H, W, C)] = fav::from_f<T>(m);
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

// ---- B4: the backward ------------------------------------------------------
//
// A block owns a TS x TS tile of (h, w) cells of one batch element, one
// channel vector (16 bytes: 8 bf16 or 4 f32 channels) and a run of frames
// [t0, t1), and marches along T, one x plane an iteration.  Its threads own
// the (TS+2) x (TS+2) positions of the tile with a halo of 1, one position
// each, for the whole march.  Iteration p:
//   (a) loads x plane p+1 into the other half of a 2-plane ring (cp.async;
//       pads stay -inf) and dy plane p into registers;
//   (b) m_w of plane p over rows -2..TS+1 (shared memory) and the W codes;
//   (c) dx of plane p-3 (the W stage, from (e) of the last iteration);
//   (d) m_hw of plane p and its H codes; the T code of window p-1 from the
//       owner's registers m_hw(p-2), m_hw(p-1), m_hw(p); then the T stage of
//       plane p-2 in registers: g1 = sum over k of dy(p-1-k) of code k;
//   (e) the H stage of plane p-2: g2 from the g1 and H codes of the
//       position's column neighbours (shared memory).
// So each x plane is read once a block (halo 2 in H and W: 1.65x at TS=14),
// each dy plane once (halo 1), a window's first match takes 6 compares
// shared with its neighbours, and a run of frames recomputes 4 planes.
// Shared memory stays under 48 KB, so no attribute is set.
namespace b4 {

using namespace fav;  // the 16-byte channel vectors of common.cuh

constexpr unsigned kNone = 3;         // the code of a window that routes nothing
constexpr int kMaxThreads = 256;      // (14 + 2)^2 positions
// A launch with fewer tiles than one wave of resident blocks (3 of 256
// threads at 80 registers on each of the H100's 132 SMs) splits T into runs
// of at least kMinFrames frames, each recomputing 4 planes: at B=1, T'=45
// this took B4 from 0.115 to 0.073 ms, while at B=8 any split cost 5-7%.
constexpr int64_t kTargetBlocks = 3 * 132;
constexpr int kMinFrames = 8;

template <typename T>
constexpr unsigned kNoneAll = kVec<T> == 8 ? 0xffffu : 0xffu;  // kNone in every channel

// The window (a, b, d) in tap order: m = its NaN-propagating maximum, and
// per channel the first tap equal to m (kNone when m is NaN), 2 bits each.
template <typename T>
__device__ __forceinline__ unsigned pool3(const uint4& ra, const uint4& rb, const uint4& rd,
                                          uint4& m_out) {
  float a[kVec<T>], b[kVec<T>], d[kVec<T>], m[kVec<T>];
  unpack<T>(ra, a);
  unpack<T>(rb, b);
  unpack<T>(rd, d);
  unsigned code = 0;
#pragma unroll
  for (int j = 0; j < kVec<T>; ++j) {
    m[j] = fav::fmax_nan(fav::fmax_nan(a[j], b[j]), d[j]);
    const unsigned k = a[j] == m[j] ? 0u : b[j] == m[j] ? 1u : d[j] == m[j] ? 2u : kNone;
    code |= k << (2 * j);
  }
  m_out = pack_exact<T>(m);
  return code;
}

// acc += g in the channels whose code is k
template <int N>
__device__ __forceinline__ void route_add(float (&acc)[N], const float (&g)[N], unsigned code,
                                          unsigned k) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (((code >> (2 * j)) & 3u) == k) acc[j] += g[j];
}

template <int N>
__device__ __forceinline__ void load_f(float (&f)[N], const float* src) {
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(src + j);
    f[j] = v.x, f[j + 1] = v.y, f[j + 2] = v.z, f[j + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void store_f(float* dst, const float (&f)[N]) {
#pragma unroll
  for (int j = 0; j < N; j += 4)
    *reinterpret_cast<float4*>(dst + j) = make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
}

template <typename T, int TS>
constexpr size_t smem_bytes() {
  constexpr int S = TS + 2, XS = TS + 4;
  return size_t(2 * XS * XS + XS * S) * 16                     // x ring, m_w
         + size_t(S * S + TS * S) * (kVec<T> * 4 + 4);         // g1, g2 and their codes
}

template <typename T, int TS, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
pool_s1_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                   int T_, int H, int W, int C, int frames) {
  constexpr int N = kVec<T>, S = TS + 2, XS = TS + 4, MP = S * S, XP = XS * XS;
  constexpr unsigned NONE = kNoneAll<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* xs = reinterpret_cast<uint4*>(smem);         // [2][XS*XS]: rows, cols -2..TS+1
  uint4* mws = xs + 2 * XP;                            // [XS][S]: rows -2..TS+1, cols -1..TS
  float* g1s = reinterpret_cast<float*>(mws + XS * S); // [S*S][N]: g1 of the plane in flight
  float* g2s = g1s + MP * N;                           // [TS][S][N]: its g2
  unsigned* hcs = reinterpret_cast<unsigned*>(g2s + TS * S * N);  // [S*S]: H codes beside g1
  unsigned* wcs = hcs + MP;                            // [TS][S]: W codes beside g2

  const int n_cg = (C + N - 1) / N, n_tw = (W + TS - 1) / TS, n_th = (H + TS - 1) / TS;
  const int n_tc = (T_ + frames - 1) / frames;
  int64_t blk = blockIdx.x;
  const int c0 = int(blk % n_cg) * N;
  blk /= n_cg;
  const int w0 = int(blk % n_tw) * TS;
  blk /= n_tw;
  const int h0 = int(blk % n_th) * TS;
  blk /= n_th;
  const int t0 = int(blk % n_tc) * frames, t1 = min(t0 + frames, T_);
  const int64_t b = blk / n_tc;

  const int tid = threadIdx.x;
  const bool active = tid < MP;
  const int r = tid / S - 1, c = tid % S - 1;  // the owned position, relative to (h0, w0)
  const int h = h0 + r, w = w0 + c;
  const bool inside = active && h >= 0 && h < H && w >= 0 && w < W;
  const bool cell = inside && r < TS && c < TS && r >= 0 && c >= 0;  // a dx of this tile
  const int64_t plane = int64_t(H) * W * C;
  const int64_t base = b * T_ * plane + c0;
  const int64_t here = (int64_t(h) * W + w) * C;
  const uint4 neg = splat<T>(-INFINITY), zero = make_uint4(0, 0, 0, 0);

  auto stage_x = [&](int p, uint4* dst) {  // x plane p, pads left at -inf
    for (int i = tid; i < XP; i += blockDim.x) {
      const int hh = h0 - 2 + i / XS, ww = w0 - 2 + i % XS;
      if (hh < 0 || hh >= H || ww < 0 || ww >= W) continue;
      const int64_t off = base + p * plane + (int64_t(hh) * W + ww) * C;
      if constexpr (VEC)
        cp_async16(dst + i, x + off);
      else
        dst[i] = load_vec<T, VEC>(x, off, c0, C, -INFINITY);
    }
    if constexpr (VEC) asm volatile("cp.async.commit_group;\n" ::);
  };

  auto write_dx = [&](int s) {  // the W stage of plane s
    if (!cell) return;
    float acc[N] = {}, g[N];
#pragma unroll
    for (int k = 0; k < 3; ++k) {  // g2 at column c + 1 - k
      const int q = r * S + c + 2 - k;
      load_f(g, g2s + q * N);
      route_add(acc, g, wcs[q], unsigned(k));
    }
    const int64_t off = base + s * plane + here;
    if constexpr (VEC) {
      *reinterpret_cast<uint4*>(dx + off) = pack_round<T>(acc);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (c0 + j < C) dx[off + j] = fav::from_f<T>(acc[j]);
    }
  };

  for (int i = tid; i < 2 * XP; i += blockDim.x) xs[i] = neg;
  __syncthreads();

  // the owner's rings: m_hw(p-2), m_hw(p-1); dy(p-3), dy(p-2), dy(p-1), dy(p)
  // in flight; T codes of windows p-3, p-2; H and W codes of planes p-2, p-1
  uint4 mh0 = neg, mh1 = neg, d0 = zero, d1 = zero, d2 = zero, dnext = zero;
  unsigned tc0 = NONE, tc1 = NONE, ha = NONE, hb = NONE, wa = NONE, wb = NONE;
  const int pbeg = t0 - 2, pend = t1 + 1;
  if (pbeg >= 0) stage_x(pbeg, xs);
  cp_async_wait_all();
  __syncthreads();
  for (int p = pbeg; p <= pend; ++p) {
    const int ring = (p - pbeg) & 1;
    const uint4* xcur = xs + ring * XP;
    const bool have = p >= 0 && p < T_;  // plane p lies in the volume
    // (a)
    if (p + 1 <= pend && p + 1 >= 0 && p + 1 < T_) stage_x(p + 1, xs + (ring ^ 1) * XP);
    d0 = d1, d1 = d2, d2 = dnext;
    dnext = inside && have ? load_vec<T, VEC>(dy, base + p * plane + here, c0, C, 0.f) : zero;
    // (b)
    unsigned wcur = NONE;
    if (have && active) {
      uint4 m;
      const uint4* row = xcur + (r + 2) * XS + c + 1;
      wcur = pool3<T>(row[0], row[1], row[2], m);
      mws[(r + 2) * S + c + 1] = m;
      if (r == -1 || r == TS) {  // rows -2 and TS+1, for the H windows of rows -1 and TS
        const int xr = r == -1 ? 0 : TS + 3;
        const uint4* row2 = xcur + xr * XS + c + 1;
        pool3<T>(row2[0], row2[1], row2[2], m);
        mws[xr * S + c + 1] = m;
      }
      if (!inside) wcur = NONE;
    }
    // (c)
    if (p - 3 >= t0) write_dx(p - 3);
    __syncthreads();
    // (d)
    if (active) {
      uint4 mh2 = neg, y;
      unsigned hcur = NONE;
      if (have) {
        const uint4* col = mws + (r + 1) * S + c + 1;
        hcur = pool3<T>(col[0], col[S], col[2 * S], mh2);
        if (!inside) hcur = NONE;
      }
      unsigned tc2 = pool3<T>(mh0, mh1, mh2, y);  // the window centred on plane p-1
      if (!inside || p - 1 < 0 || p - 1 >= T_) tc2 = NONE;
      if (p - 2 >= t0) {
        float acc[N] = {}, g[N];
        unpack<T>(d2, g);
        route_add(acc, g, tc2, 0u);
        unpack<T>(d1, g);
        route_add(acc, g, tc1, 1u);
        unpack<T>(d0, g);
        route_add(acc, g, tc0, 2u);
        store_f(g1s + tid * N, acc);
        hcs[tid] = ha;
      }
      mh0 = mh1, mh1 = mh2, tc0 = tc1, tc1 = tc2, ha = hb, hb = hcur;
    }
    __syncthreads();
    // (e)
    if (p - 2 >= t0 && active && r >= 0 && r < TS) {
      float acc[N] = {}, g[N];
#pragma unroll
      for (int k = 0; k < 3; ++k) {  // g1 at row r + 1 - k
        const int q = tid + (1 - k) * S;
        load_f(g, g1s + q * N);
        route_add(acc, g, hcs[q], unsigned(k));
      }
      store_f(g2s + (r * S + c + 1) * N, acc);
      wcs[r * S + c + 1] = wa;
    }
    wa = wb, wb = wcur;
    cp_async_wait_all();
    __syncthreads();
  }
  write_dx(t1 - 1);
}

template <typename T, int TS, bool VEC>
int launch(const void* x, const void* dy, void* dx, int64_t B, int64_t T_, int64_t H, int64_t W,
           int64_t C, cudaStream_t s) {
  const int64_t tiles = B * ((H + TS - 1) / TS) * ((W + TS - 1) / TS) * ((C + kVec<T> - 1) / kVec<T>);
  if (tiles == 0 || T_ == 0) return 0;
  int64_t runs = (kTargetBlocks + tiles - 1) / tiles;
  runs = std::max<int64_t>(1, std::min<int64_t>(runs, T_ / kMinFrames));
  const int64_t frames = (T_ + runs - 1) / runs;
  runs = (T_ + frames - 1) / frames;
  constexpr int threads = ((TS + 2) * (TS + 2) + 31) / 32 * 32;
  static_assert(threads <= kMaxThreads, "one thread a position");
  pool_s1_bwd_kernel<T, TS, VEC><<<unsigned(tiles * runs), threads, smem_bytes<T, TS>(), s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx), int(T_), int(H),
      int(W), int(C), int(frames));
  return int(cudaGetLastError());
}

// TS = 14: Mixed_3b/3c's 28x28 in 4 tiles and Mixed_4x's 14x14 in one;
// TS = 7: Mixed_5x's 7x7 in one.
template <typename T>
int launch_bwd(const void* x, const void* dy, void* dx, int64_t B, int64_t T_, int64_t H,
               int64_t W, int64_t C, cudaStream_t s) {
  const bool vec = C % kVec<T> == 0 && fav::aligned16(x) && fav::aligned16(dy) && fav::aligned16(dx);
  if (H <= 7 && W <= 7)
    return vec ? launch<T, 7, true>(x, dy, dx, B, T_, H, W, C, s)
               : launch<T, 7, false>(x, dy, dx, B, T_, H, W, C, s);
  return vec ? launch<T, 14, true>(x, dy, dx, B, T_, H, W, C, s)
             : launch<T, 14, false>(x, dy, dx, B, T_, H, W, C, s);
}

}  // namespace b4

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
  if (dtype == fav::kBF16) return b4::launch_bwd<__nv_bfloat16>(x, dy, dx, B, T, H, W, C, s);
  if (dtype == fav::kF32) return b4::launch_bwd<float>(x, dy, dx, B, T, H, W, C, s);
  return int(cudaErrorInvalidValue);
}
