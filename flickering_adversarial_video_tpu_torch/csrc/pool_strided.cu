// B5: the (1,3,3)/(1,2,2) SAME spatial max pool forward, pads (0,1), on
// NDHWC [B,T,H,W,C] with even H and W (MaxPool3d_2a, 3a and the spatial half
// of 4a).
//
// Replaces the Pallas kernel ops/pallas_pool.py:206 `_strided_fwd_kernel` as
// ops/stem_tmajor.py:718 `strided_pool_view` launches it (pallas_call :754).
// The same function in other TPU layouts, which NDHWC makes one: B5b
// (ops/pallas_pool.py:263 `strided_spatial_pool_conv`, pallas_call :306, the
// same kernel body :206) and B11 (:742 `spatial_pool_132`,
// `_spatial_fwd_kernel` :50, pallas_call :94); their backward is XLA's
// select-and-scatter, whose rule B6 below implements.  The index pair B9 of
// this pool is csrc/pool_pair.cu.
//
//   y[n,ho,wo,c] = max_{r in 2ho..2ho+2, s in 2wo..2wo+2, in range} x[n,r,s,c]
//   (NaN if any of them is NaN, as jnp.maximum)
//
// Bound on the H100: bytes (read x once, write y = x/4).  Design: the
// H-marching full-width strip of csrc/pool_s2_strip.cuh (B9's forward runs
// the same body): a block stages two x rows a step into a cp.async ring,
// takes three-row then three-column maxima of 16-byte channel vectors with
// max.NaN and stores one vector of y a thread and step.  W <= 1024.
//
// B6: the same pool's first-match backward, one pass.  Replaces the Pallas
// kernel ops/pool_s2_view_pallas.py:246 s2_pool_view_bwd_pallas (`_bwd_kernel`
// :71), which the JAX package keeps gated off (its default is XLA's
// select-and-scatter); the port runs it on the main path.  A window's
// cotangent goes where XLA's select-and-scatter (GE) sends it: its first
// maximal element in H-then-W raster order, and after a NaN the scan's next
// pick (below; the gated-off TPU kernel routes nothing from such a window).
// A cell, in up to 2x2 windows, sums their contributions in f32 in ascending
// tap order and rounds once (the TPU kernel adds in the cotangent dtype):
// bit-equal to the plain version, within bf16 rounding of the TPU kernel.
// Bound by bytes (read x and dy, write dx).  Design: its own section below,
// on the strip's launch geometry.

#include <algorithm>

#include "pool_s2_strip.cuh"

namespace {

template <typename T, bool VEC>
__global__ void __launch_bounds__(fav::strip::kMaxThreads)
pool_s2_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int H, int W, int C, int nv,
                   int groups, int rows, int runs) {
  fav::strip::fwd<T, VEC, false>(x, y, nullptr, H, W, C, nv, groups, rows, runs);
}

template <typename T, bool VEC>
int launch_fwd(const void* x, void* y, int64_t N, int64_t H, int64_t W, int64_t C,
               cudaStream_t s) {
  if (N == 0 || H == 0 || C == 0) return 0;
  const auto p = fav::strip::fwd_plan<pool_s2_fwd_kernel<T, VEC>, T>(N, H, W, C);
  pool_s2_fwd_kernel<T, VEC><<<unsigned(p.blocks), p.threads, p.smem, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), int(H), int(W), int(C), p.nv,
      int(p.groups), int(p.rows), int(p.runs));
  return int(cudaGetLastError());
}

template <typename T>
int launch_fwd(const void* x, void* y, int64_t N, int64_t H, int64_t W, int64_t C,
               cudaStream_t s) {
  const bool vec = C % fav::kVec<T> == 0 && fav::aligned16(x) && fav::aligned16(y);
  return vec ? launch_fwd<T, true>(x, y, N, H, W, C, s) : launch_fwd<T, false>(x, y, N, H, W, C, s);
}

// ---- B6: the backward -------------------------------------------------------
//
// A block owns one frame n = b*T + t, one group of nv channel vectors (16
// bytes: 8 bf16 or 4 f32 channels) and a run of window rows [ho0, ho1) over
// the full width: thread (cv, wo) = (tid % nv, tid / nv) owns window column wo
// and vector cv, so a warp's loads and stores are runs of whole vectors.  The
// block marches down H one window row a step.  Step ho:
//   (a) prefetches step ho+1's x rows 2ho+3, 2ho+4 and dy row ho+1 into a
//       3-slot shared-memory ring (cp.async; slot i holds x rows 2p+1, 2p+2,
//       dy row p and the codes of window row p);
//   (b) scans window (ho, wo)'s 9 taps: row 2ho is the last slot's second x
//       row, column 2wo+2 the neighbour's, and the (0,1) pads are -inf; the
//       tap taken per channel is a 4-bit code, shared through the ring;
//   (c) after a barrier, sums each of its 2x2 cells' terms in ascending tap
//       order from 0 in f32: for the even-row, even-column cell k=0 of its own
//       window, k=2 of the left one (its code and dy from the ring), then k=6
//       and k=8 of window row ho-1 (the last slot's codes and dy), and rounds
//       once: rows 2ho and 2ho+1, columns 2wo and 2wo+1 of dx.
// So x, dy and dx move once, in 16-byte vectors, and each window's argmax is
// computed once.  A run starts one window row early (x rows 2ho0-2, 2ho0-1,
// dy row ho0-1) so that the terms from window row ho0-1 exist.  The split
// into runs minimises waves of resident blocks x steps a block: none at B=8,
// 8 runs a frame at B=1, T'=45 at MaxPool3d_2a.  Registers are not capped for a
// second block an SM: at MaxPool3d_2a on an H100 one 448-thread block an SM
// (83-93 registers) took 0.331 ms against 0.367 for two (64, or 72, registers).
namespace b6 {

using namespace fav;  // the 16-byte channel vectors of common.cuh

using strip::kMaxThreads;

constexpr int kSlots = 3;

// code 15, no window, in every channel
template <typename T>
constexpr unsigned kNoneAll = kVec<T> == 8 ? 0xffffffffu : 0xffffu;

// slot: x rows A and B (W*nv vectors each), dy row (Wo*nv); then the codes
inline size_t smem_bytes(int W, int nv) {
  const int Wo = W / 2;
  return size_t(kSlots) * ((2 * W + Wo) * nv * 16 + Wo * nv * 4);
}

// The first tap a select-and-scatter (GE) scan keeps over the 9 taps of a
// window in raster order, per channel, 4 bits each.
template <typename T>
__device__ __forceinline__ unsigned scan9(const uint4 (&tap)[9]) {
  constexpr int N = kVec<T>;
  float f[9][N];
#pragma unroll
  for (int k = 0; k < 9; ++k) unpack<T>(tap[k], f[k]);
  unsigned code = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float kept = f[0][j];
    unsigned k_kept = 0;
#pragma unroll
    for (int k = 1; k < 9; ++k) {
      if (!(kept >= f[k][j])) {
        kept = f[k][j];
        k_kept = k;
      }
    }
    code |= k_kept << (4 * j);
  }
  return code;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kMaxThreads, 1)
pool_s2_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx, int H,
                   int W, int C, int nv, int groups, int rows, int runs) {
  constexpr int N = kVec<T>;
  const int Ho = H / 2, Wo = W / 2;
  const int xrow = W * nv, slot = 2 * xrow + Wo * nv, lanes = Wo * nv;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);                         // [kSlots][slot]
  unsigned* codes = reinterpret_cast<unsigned*>(ring + kSlots * slot);  // [kSlots][lanes]

  int64_t blk = blockIdx.x;
  const int g = int(blk % groups);
  blk /= groups;
  const int run = int(blk % runs);
  const int64_t n = blk / runs;
  const int ho0 = run * rows, ho1 = min(ho0 + rows, Ho), s0 = max(ho0 - 1, 0);
  const int tid = threadIdx.x, cv = tid % nv, wo = tid / nv;
  const int c0 = (g * nv + cv) * N;
  const bool live = c0 < C;  // the vector holds channels
  const T* xn = x + n * H * int64_t(W) * C + c0;
  const T* dyn = dy + n * Ho * int64_t(Wo) * C + c0;
  T* dxn = dx + n * H * int64_t(W) * C + c0;
  const uint4 neg = splat<T>(-INFINITY);

  // thread (cv, wo) stages vector cv of columns wo and wo + Wo of an x row
  auto stage_row = [&](int r, uint4* dst) {
    if (!live) return;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = wo + half * Wo;
      const int64_t off = (int64_t(r) * W + col) * C;
      if constexpr (VEC)
        cp_async16(dst + col * nv + cv, xn + off);
      else
        dst[col * nv + cv] = load_vec<T, false>(xn, off, c0, C, -INFINITY);
    }
  };
  auto stage_step = [&](int p, uint4* dst) {  // x rows 2p+1, 2p+2 (if inside), dy row p
    stage_row(2 * p + 1, dst);
    if (2 * p + 2 < H) stage_row(2 * p + 2, dst + xrow);
    if (live) {
      const int64_t off = (int64_t(p) * Wo + wo) * C;
      if constexpr (VEC)
        cp_async16(dst + 2 * xrow + tid, dyn + off);
      else
        dst[2 * xrow + tid] = load_vec<T, false>(dyn, off, c0, C, 0.f);
    }
    if constexpr (VEC) asm volatile("cp.async.commit_group;\n" ::);
  };

  // slot 0 stands for window row s0-1: its second x row is row 2*s0, its
  // codes none, its dy 0; slot 1 holds step s0
  codes[tid] = kNoneAll<T>;
  ring[2 * xrow + tid] = make_uint4(0, 0, 0, 0);
  stage_row(2 * s0, ring + xrow);
  stage_step(s0, ring + slot);
  cp_async_wait_all();
  __syncthreads();

  for (int ho = s0, i = 0; ho < ho1; ++ho, ++i) {
    const int cur = (i + 1) % kSlots, prev = i % kSlots;
    if (ho + 1 < ho1) stage_step(ho + 1, ring + ((i + 2) % kSlots) * slot);
    const uint4* sc = ring + cur * slot;
    const uint4* sp = ring + prev * slot;
    // (b) the taps of window (ho, wo): rows 2ho (sp's B), 2ho+1 (sc's A), 2ho+2 (sc's B)
    uint4 tap[9];
    const bool right = wo + 1 < Wo, bottom = 2 * ho + 2 < H;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const uint4* row = (kh == 0 ? sp + xrow : sc + (kh - 1) * xrow) + 2 * wo * nv + cv;
      const bool in = kh < 2 || bottom;
      tap[3 * kh] = in ? row[0] : neg;
      tap[3 * kh + 1] = in ? row[nv] : neg;
      tap[3 * kh + 2] = in && right ? row[2 * nv] : neg;
    }
    const unsigned code = scan9<T>(tap);
    codes[cur * lanes + tid] = code;
    __syncthreads();
    // (c) the 2x2 cells of (ho, wo)
    if (ho >= ho0 && live) {
      const bool left = wo > 0;
      const unsigned cl = left ? codes[cur * lanes + tid - nv] : kNoneAll<T>;
      const unsigned cp = codes[prev * lanes + tid];
      const unsigned clp = left ? codes[prev * lanes + tid - nv] : kNoneAll<T>;
      const uint4* dyc = sc + 2 * xrow + tid;
      const uint4* dyp = sp + 2 * xrow + tid;
      float d[N], dl[N], dp[N], dlp[N];
      unpack<T>(dyc[0], d);
      unpack<T>(dyp[0], dp);
      unpack<T>(left ? dyc[-nv] : make_uint4(0, 0, 0, 0), dl);
      unpack<T>(left ? dyp[-nv] : make_uint4(0, 0, 0, 0), dlp);
      float a00[N], a01[N], a10[N], a11[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const unsigned k = (code >> (4 * j)) & 15u, kl = (cl >> (4 * j)) & 15u;
        const unsigned kp = (cp >> (4 * j)) & 15u, klp = (clp >> (4 * j)) & 15u;
        float s = 0.f;  // cell (2ho, 2wo): k = 0, 2, 6, 8
        if (k == 0) s += d[j];
        if (kl == 2) s += dl[j];
        if (kp == 6) s += dp[j];
        if (klp == 8) s += dlp[j];
        a00[j] = s;
        s = 0.f;  // (2ho, 2wo+1): k = 1, 7
        if (k == 1) s += d[j];
        if (kp == 7) s += dp[j];
        a01[j] = s;
        s = 0.f;  // (2ho+1, 2wo): k = 3, 5
        if (k == 3) s += d[j];
        if (kl == 5) s += dl[j];
        a10[j] = s;
        s = 0.f;  // (2ho+1, 2wo+1): k = 4
        if (k == 4) s += d[j];
        a11[j] = s;
      }
      T* out = dxn + (int64_t(2 * ho) * W + 2 * wo) * C;
      const int64_t down = int64_t(W) * C;
      if constexpr (VEC) {
        *reinterpret_cast<uint4*>(out) = pack_round<T>(a00);
        *reinterpret_cast<uint4*>(out + C) = pack_round<T>(a01);
        *reinterpret_cast<uint4*>(out + down) = pack_round<T>(a10);
        *reinterpret_cast<uint4*>(out + down + C) = pack_round<T>(a11);
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          if (c0 + j >= C) break;
          out[j] = fav::from_f<T>(a00[j]);
          out[C + j] = fav::from_f<T>(a01[j]);
          out[down + j] = fav::from_f<T>(a10[j]);
          out[down + C + j] = fav::from_f<T>(a11[j]);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }
}

template <typename T, bool VEC>
int launch(const void* x, const void* dy, void* dx, int64_t N_, int64_t H, int64_t W, int64_t C,
           cudaStream_t s) {
  const int64_t Ho = H / 2, Wo = W / 2;
  if (N_ == 0 || Ho == 0 || C == 0) return 0;
  const strip::Groups gr = strip::channel_groups(C, kVec<T>, Wo);
  const int threads = gr.nv * int(Wo);
  const size_t smem = smem_bytes(int(W), gr.nv);
  const int64_t tiles = N_ * gr.groups;
  const int64_t per_wave =
      strip::wave<pool_s2_bwd_kernel<T, VEC>>(threads, smem, smem_bytes(2 * kMaxThreads, 1));
  // a later run starts one window row early: one step more
  int64_t rows, runs;
  strip::choose_runs(tiles, Ho, per_wave, 2, &rows, &runs);
  pool_s2_bwd_kernel<T, VEC><<<unsigned(tiles * runs), threads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx), int(H), int(W),
      int(C), gr.nv, int(gr.groups), int(rows), int(runs));
  return int(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* dy, void* dx, int64_t N_, int64_t H, int64_t W,
               int64_t C, cudaStream_t s) {
  const bool vec = C % kVec<T> == 0 && fav::aligned16(x) && fav::aligned16(dy) && fav::aligned16(dx);
  return vec ? launch<T, true>(x, dy, dx, N_, H, W, C, s) : launch<T, false>(x, dy, dx, N_, H, W, C, s);
}

}  // namespace b6

}  // namespace

FAV_API int fav_pool_s2_fwd(const void* x, void* y, int64_t N, int64_t H, int64_t W, int64_t C,
                            int dtype, void* stream) {
  if ((H % 2) || (W % 2) || W / 2 > fav::strip::kMaxThreads) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fav::kBF16) return launch_fwd<__nv_bfloat16>(x, y, N, H, W, C, s);
  if (dtype == fav::kF32) return launch_fwd<float>(x, y, N, H, W, C, s);
  return int(cudaErrorInvalidValue);
}

FAV_API int fav_pool_s2_bwd(const void* x, const void* dy, void* dx, int64_t N, int64_t H,
                            int64_t W, int64_t C, int dtype, void* stream) {
  if ((H % 2) || (W % 2) || W / 2 > b6::kMaxThreads) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fav::kBF16) return b6::launch_bwd<__nv_bfloat16>(x, dy, dx, N, H, W, C, s);
  if (dtype == fav::kF32) return b6::launch_bwd<float>(x, dy, dx, N, H, W, C, s);
  return int(cudaErrorInvalidValue);
}
