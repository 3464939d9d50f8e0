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
// dy, write dx).  Both kernels march a tile of 16-byte channel vectors along
// T; the designs follow their sections.

#include "common.cuh"

namespace {

// ---- B3: the forward -------------------------------------------------------
//
// The TPU kernel's separable maxima (`_fwd_kernel` :140): m_w = max of 3
// along W, m_hw = max of 3 m_w along H, y = max of 3 m_hw along T.  A block
// owns a TS x TS tile of (h, w) cells of one batch element, a group of NV
// consecutive channel vectors (16 bytes each: 8 bf16 or 4 f32 channels, so a
// position's group is one contiguous NV*16-byte run) and a run of frames
// [t0, t1), and marches along T, one x plane an iteration.  Positions of the
// halo outside the volume are clamped to its edge, as the TPU kernel's halo
// specs clamp (:142-147): a clamped position repeats one that is already in
// every window it joins, and max(x, x) = x, NaN included, so no load is
// predicated and no pad is written.  Iteration p:
//   (a) waits for x plane p, and starts plane p + kStages - 1 into the slot
//       of plane p - 1 (a kStages-slot cp.async ring);
//   (b) m_w of plane p at rows -1..TS, columns 0..TS-1, into shared memory;
//   (c) each cell's owner: m_hw of plane p, and y(p-1) = max(m_hw(p-2),
//       m_hw(p-1), m_hw(p)) from its registers, one 16-byte store.
// A thread owns one vector of one halo position, vector fastest.  Two
// barriers a plane and 8 max instructions a stage (4 on packed bf16 pairs).
// A max with NaN propagation is associative, so this order gives the 27-tap
// maximum of the plain version bit for bit.  Each x plane is read once a
// block (1.31x through the halo at TS = 14), each y plane written once.
// One vector a block took 0.162 ms at [8,32,28,28,192] bf16, groups of 2
// and 4 vectors 0.069 and 0.065 (device time, scripts/torch_pool_s1_bench.py,
// H100 80GB HBM3 at 700 W): single 16-byte loads at a position's stride
// used half of each 32-byte sector.
namespace b3 {

using namespace fav;  // the 16-byte channel vectors of common.cuh

constexpr int kStages = 4;  // ring slots: the plane in use and 3 in flight

template <int TS, int NV>
constexpr int threads() { return ((TS + 2) * (TS + 2) * NV + 31) / 32 * 32; }
constexpr int kMaxThreads = threads<14, 4>();

template <int TS, int NV>
constexpr size_t smem_bytes() { return size_t(kStages * (TS + 2) + TS) * (TS + 2) * NV * 16; }

template <typename T, int TS, int NV, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
pool_s1_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int T_, int H, int W, int C,
                   int frames) {
  constexpr int N = kVec<T>, XS = TS + 2, XP = XS * XS;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* xs = reinterpret_cast<uint4*>(smem);  // [kStages][XS*XS][NV]: rows, cols -1..TS
  uint4* mws = xs + kStages * XP * NV;         // [XS][TS][NV]: rows -1..TS, cols 0..TS-1

  const int n_vec = (C + N - 1) / N, n_cg = (n_vec + NV - 1) / NV;
  const int n_tw = (W + TS - 1) / TS, n_th = (H + TS - 1) / TS;
  const int n_tc = (T_ + frames - 1) / frames;
  int64_t blk = blockIdx.x;
  const int cg = int(blk % n_cg);
  blk /= n_cg;
  const int w0 = int(blk % n_tw) * TS;
  blk /= n_tw;
  const int h0 = int(blk % n_th) * TS;
  blk /= n_th;
  const int t0 = int(blk % n_tc) * frames, t1 = min(t0 + frames, T_);
  const int64_t b = blk / n_tc;

  const int tid = threadIdx.x, q = tid / NV;  // q: the position, tid % NV: the vector
  const int vi = cg * NV + tid % NV, c0 = vi * N;
  const bool vec_ok = vi < n_vec;
  const int64_t plane = int64_t(H) * W * C;
  const int64_t base = b * T_ * plane + c0;
  // the halo position this thread stages, clamped into the volume
  const int hs = min(max(h0 - 1 + q / XS, 0), H - 1), ws = min(max(w0 - 1 + q % XS, 0), W - 1);
  const int64_t src = (int64_t(hs) * W + ws) * C;
  // the cell it owns (q < TS*TS), and its m_w: row q / TS - 1, column q % TS
  const int r = q / TS, c = q % TS;
  const bool owner = q < TS * TS && h0 + r < H && w0 + c < W && vec_ok;
  const int64_t dst = (int64_t(h0 + r) * W + w0 + c) * C;

  const int pbeg = t0 - 1, pend = t1;  // planes t0-1 .. t1, clamped into [0, T)
  auto stage = [&](int p) {
    if (p <= pend && q < XP && vec_ok) {
      const int64_t off = base + min(max(p, 0), T_ - 1) * plane + src;
      uint4* d = xs + (p - pbeg) % kStages * XP * NV + tid;
      if constexpr (VEC)
        cp_async16(d, x + off);
      else
        *d = load_vec<T, VEC>(x, off, c0, C, 0.f);
    }
    cp_async_commit();  // one group a plane, empty past the run
  };

  for (int i = 0; i < kStages - 1; ++i) stage(pbeg + i);
  uint4 mh0 = make_uint4(0, 0, 0, 0), mh1 = mh0;  // m_hw(p-2), m_hw(p-1)
  for (int p = pbeg; p <= pend; ++p) {
    // (a)
    cp_async_wait<kStages - 2>();
    __syncthreads();
    stage(p + kStages - 1);
    // (b)
    if (q < XS * TS) {
      const uint4* row = xs + ((p - pbeg) % kStages * XP + r * XS + c) * NV + tid % NV;
      mws[tid] = max3<T>(row[0], row[NV], row[2 * NV]);
    }
    __syncthreads();
    // (c)
    if (q < TS * TS) {
      const uint4 mh2 = max3<T>(mws[tid], mws[tid + TS * NV], mws[tid + 2 * TS * NV]);
      if (p > t0 && owner)
        store_vec<T, VEC>(y, base + int64_t(p - 1) * plane + dst, c0, C, max3<T>(mh0, mh1, mh2));
      mh0 = mh1, mh1 = mh2;
    }
  }
}

// Frames a run.  Blocks run in waves of `wave`; a block's time is about its
// planes (frames + 2), so pick the runs with the least waves x planes (the
// fewest runs on a tie).
inline int run_frames(int64_t tiles, int64_t T_, int64_t wave) {
  int64_t best = T_, cost = -1;
  for (int64_t runs = 1; runs <= T_; ++runs) {
    const int64_t frames = (T_ + runs - 1) / runs;
    if ((T_ + frames - 1) / frames != runs) continue;  // the same as fewer runs
    const int64_t c = (tiles * runs + wave - 1) / wave * (frames + 2);
    if (cost < 0 || c < cost) best = frames, cost = c;
  }
  return int(best);
}

template <typename T, int TS, int NV, bool VEC>
int launch(const void* x, void* y, int64_t B, int64_t T_, int64_t H, int64_t W, int64_t C,
           cudaStream_t s) {
  const int64_t n_cg = ((C + kVec<T> - 1) / kVec<T> + NV - 1) / NV;
  const int64_t tiles = B * ((H + TS - 1) / TS) * ((W + TS - 1) / TS) * n_cg;
  if (tiles == 0 || T_ == 0) return 0;
  constexpr size_t smem = smem_bytes<TS, NV>();
  static const int64_t wave = [] {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(pool_s1_fwd_kernel<T, TS, NV, VEC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    return wave_blocks(pool_s1_fwd_kernel<T, TS, NV, VEC>, threads<TS, NV>(), smem);
  }();
  const int frames = run_frames(tiles, T_, wave);
  const int64_t runs = (T_ + frames - 1) / frames;
  pool_s1_fwd_kernel<T, TS, NV, VEC><<<unsigned(tiles * runs), threads<TS, NV>(), smem, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), int(T_), int(H), int(W), int(C), frames);
  return int(cudaGetLastError());
}

// TS = 14: Mixed_3b/3c's 28x28 in 4 tiles and Mixed_4x's 14x14 in one;
// TS = 7: Mixed_5x's 7x7 in one.  NV = 4 (1024 threads, one block an SM by
// registers) where the vectors fill whole groups of 4, else NV = 2 (512
// threads, two blocks an SM): Mixed_4f's 66 vectors in groups of 4 made 136
// blocks on 132 SMs, a second wave almost empty (0.033 against 0.025 ms).
// A register cap for two 1024-thread blocks an SM (32, with spills) took
// the nine pools of a B=8 step from 0.273 to 0.411 ms.
template <typename T, int TS, bool VEC>
int launch_tile(const void* x, void* y, int64_t B, int64_t T_, int64_t H, int64_t W, int64_t C,
                cudaStream_t s) {
  if ((C + kVec<T> - 1) / kVec<T> % 4 == 0) return launch<T, TS, 4, VEC>(x, y, B, T_, H, W, C, s);
  return launch<T, TS, 2, VEC>(x, y, B, T_, H, W, C, s);
}

template <typename T>
int launch_fwd(const void* x, void* y, int64_t B, int64_t T_, int64_t H, int64_t W, int64_t C,
               cudaStream_t s) {
  const bool vec = C % kVec<T> == 0 && fav::aligned16(x) && fav::aligned16(y);
  if (H <= 7 && W <= 7)
    return vec ? launch_tile<T, 7, true>(x, y, B, T_, H, W, C, s)
               : launch_tile<T, 7, false>(x, y, B, T_, H, W, C, s);
  return vec ? launch_tile<T, 14, true>(x, y, B, T_, H, W, C, s)
             : launch_tile<T, 14, false>(x, y, B, T_, H, W, C, s);
}

}  // namespace b3

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
    if constexpr (VEC) cp_async_commit();
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
  if (dtype == fav::kBF16) return b3::launch_fwd<__nv_bfloat16>(x, y, B, T, H, W, C, s);
  if (dtype == fav::kF32) return b3::launch_fwd<float>(x, y, B, T, H, W, C, s);
  return int(cudaErrorInvalidValue);
}

FAV_API int fav_pool_s1_bwd(const void* x, const void* dy, void* dx, int64_t B, int64_t T,
                            int64_t H, int64_t W, int64_t C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fav::kBF16) return b4::launch_bwd<__nv_bfloat16>(x, dy, dx, B, T, H, W, C, s);
  if (dtype == fav::kF32) return b4::launch_bwd<float>(x, dy, dx, B, T, H, W, C, s);
  return int(cudaErrorInvalidValue);
}
