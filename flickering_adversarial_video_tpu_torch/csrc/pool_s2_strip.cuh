// The H-marching full-width strip of the (1,3,3)/(1,2,2) SAME max pool, pads
// (0,1), on NDHWC [N = B*T, H, W, C] with even H and W: the launch geometry
// that B5, B6 (csrc/pool_strided.cu) and B9 (csrc/pool_pair.cu) share, and
// the forward body of B5 and B9.
//
// A block owns one frame n, one group of nv consecutive 16-byte channel
// vectors (8 bf16 or 4 f32 channels) and a run of window rows [ho0, ho1) over
// the frame's full width: thread (cv, wo) = (tid % nv, tid / nv) owns window
// column wo and vector cv, so a warp's loads and stores are runs of whole
// vectors, and a group of nv vectors covers whole 32-byte sectors.  Groups
// split a frame's vectors evenly into as few as kMaxThreads threads hold
// (W/2 * nv <= kMaxThreads, so W <= 1024); runs minimise waves of resident
// blocks x steps a block.
//
// The forward marches down H one window row a step.  Step ho stages x rows
// 2ho+3 and 2ho+4 (step ho+1) into a kSlots-slot cp.async ring while it reads
// rows 2ho (the second row of the step before), 2ho+1 and 2ho+2; a run's
// first step stages row 2ho0 itself.  For each of columns 2wo, 2wo+1 and
// 2wo+2 it takes the three-row maximum, then the three-column maximum of
// those (max.NaN on packed bf16 pairs, or f32), and stores one 16-byte vector
// of y.  The (0,1) pads are -inf: the bottom row 2ho+2 = H and the right
// column 2wo+2 = W are never read.  A max with NaN propagation is
// associative, so this order gives the plain version's 9-tap maximum bit for
// bit.  With IDX the thread also scans each channel's 9 taps in f32 for the
// first k = kh*3+kw equal to y (9 where none is: y is NaN) and stores its 8
// (bf16) or 4 (f32) index bytes at once.  One barrier a step; x is read once,
// y (and the index) written once.
#pragma once

#include <mutex>
#include <utility>
#include <vector>

#include "common.cuh"

namespace fav {
namespace strip {

constexpr int kMaxThreads = 512;  // wo x cv; full width needs W/2 <= kMaxThreads
constexpr int kMinRows = 4;       // the fewest window rows of a run
constexpr int kDepth = 1;         // forward steps in flight
constexpr int kSlots = kDepth + 2;  // + the step in use and the one before it

// The split of a frame's channel vectors into groups of nv.
struct Groups {
  int nv;
  int64_t groups;
};

inline Groups channel_groups(int64_t C, int vec, int64_t Wo) {
  const int64_t n_cv = (C + vec - 1) / vec, nv_max = kMaxThreads / Wo;
  const int64_t groups = (n_cv + nv_max - 1) / nv_max;
  return {int((n_cv + groups - 1) / groups), groups};
}

// The runs of window rows a frame is cut into, minimising waves x steps a
// block, where a run after the first costs `start` half-steps more: (rows a
// run, runs).
inline void choose_runs(int64_t tiles, int64_t Ho, int64_t per_wave, int start, int64_t* rows,
                        int64_t* runs) {
  int64_t best = INT64_MAX;
  *runs = 1, *rows = Ho;
  for (int64_t r = 1; r <= std::max<int64_t>(1, Ho / kMinRows); ++r) {
    const int64_t rr = (Ho + r - 1) / r, n_runs = (Ho + rr - 1) / rr;
    const int64_t cost = (tiles * n_runs + per_wave - 1) / per_wave * (2 * rr + start * (n_runs > 1));
    if (cost < best) best = cost, *runs = n_runs, *rows = rr;
  }
}

// Resident blocks of `Kernel` on the whole card at this block size and
// dynamic shared memory; the first call lets it use up to `smem_max` bytes.
// Each (threads, smem) is asked of the occupancy calculator once, at its first
// launch: a warm-up before a CUDA graph's capture, so that the launches the
// capture records and their replays make no runtime call but the launch.
template <auto Kernel>
int64_t wave(int threads, size_t smem, size_t smem_max) {
  static std::mutex mu;
  static int sms = 0;
  static std::vector<std::pair<std::pair<int, size_t>, int>> per_sm;  // (threads, smem) -> blocks
  const std::lock_guard<std::mutex> lock(mu);
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_max));
  }
  const std::pair<int, size_t> key{threads, smem};
  for (const auto& [k, n] : per_sm)
    if (k == key) return int64_t(n) * sms;
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, Kernel, threads, smem);
  per_sm.emplace_back(key, std::max(n, 1));
  return int64_t(std::max(n, 1)) * sms;
}

// ---- the forward ------------------------------------------------------------

// slot: x rows 2p+1 and 2p+2 of step p, W * nv vectors each
inline size_t fwd_smem_bytes(int64_t W, int nv) { return size_t(kSlots) * 2 * W * nv * 16; }

template <typename T, bool VEC, bool IDX>
__device__ __forceinline__ void fwd(const T* __restrict__ x, T* __restrict__ y,
                                    unsigned char* __restrict__ idx, int H, int W, int C, int nv,
                                    int groups, int rows, int runs) {
  constexpr int N = kVec<T>;
  const int Ho = H / 2, Wo = W / 2;
  const int xrow = W * nv, slot = 2 * xrow;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);  // [kSlots][2][W][nv]

  int64_t blk = blockIdx.x;
  const int g = int(blk % groups);
  blk /= groups;
  const int run = int(blk % runs);
  const int64_t n = blk / runs;
  const int ho0 = run * rows, ho1 = min(ho0 + rows, Ho);
  const int tid = threadIdx.x, cv = tid % nv, wo = tid / nv;
  const int c0 = (g * nv + cv) * N;
  const bool live = c0 < C;  // the vector holds channels
  const T* xn = x + n * H * int64_t(W) * C + c0;
  const int64_t yn = (n * Ho * int64_t(Wo) + wo) * C + c0;
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
  // one cp.async group a step, empty past the run
  auto stage_step = [&](int p, uint4* dst) {
    if (p < ho1) {
      stage_row(2 * p + 1, dst);
      if (2 * p + 2 < H) stage_row(2 * p + 2, dst + xrow);
    }
    cp_async_commit();
  };

  // step s lives in slot (s - ho0 + 1) % kSlots; slot 0's second row is x row 2*ho0
  stage_row(2 * ho0, ring + xrow);
  for (int d = 0; d < kDepth; ++d) stage_step(ho0 + d, ring + (d + 1) * slot);

  for (int ho = ho0, i = 0; ho < ho1; ++ho, ++i) {
    cp_async_wait<kDepth - 1>();  // step ho has landed
    __syncthreads();              // ... for every thread, and step ho-2's slot is free
    stage_step(ho + kDepth, ring + (i + 1 + kDepth) % kSlots * slot);
    if (!live) continue;
    const uint4* r0 = ring + i % kSlots * slot + xrow + 2 * wo * nv + cv;  // row 2ho
    const uint4* r1 = ring + (i + 1) % kSlots * slot + 2 * wo * nv + cv;  // row 2ho+1
    const uint4* r2 = r1 + xrow;                                          // row 2ho+2
    const bool right = wo + 1 < Wo, bottom = 2 * ho + 2 < H;
    uint4 tap[9];
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      const bool in = kw < 2 || right;
      tap[kw] = in ? r0[kw * nv] : neg;
      tap[3 + kw] = in ? r1[kw * nv] : neg;
      tap[6 + kw] = in && bottom ? r2[kw * nv] : neg;
    }
    const uint4 m = max3<T>(max3<T>(tap[0], tap[3], tap[6]), max3<T>(tap[1], tap[4], tap[7]),
                            max3<T>(tap[2], tap[5], tap[8]));
    const int64_t off = yn + int64_t(ho) * Wo * C;
    store_vec<T, VEC>(y, off, c0, C, m);
    if constexpr (IDX) {
      float fm[N];
      unpack<T>(m, fm);
      unsigned char k_of[N];
#pragma unroll
      for (int j = 0; j < N; ++j) k_of[j] = 9;
#pragma unroll
      for (int k = 8; k >= 0; --k) {  // descending: the smallest matching k wins
        float f[N];
        unpack<T>(tap[k], f);
#pragma unroll
        for (int j = 0; j < N; ++j)
          if (f[j] == fm[j]) k_of[j] = k;
      }
      if constexpr (VEC) {
        uint32_t w[2] = {0, 0};
#pragma unroll
        for (int j = 0; j < N; ++j) w[j / 4] |= uint32_t(k_of[j]) << (8 * (j % 4));
        if constexpr (N == 8)
          *reinterpret_cast<uint2*>(idx + off) = make_uint2(w[0], w[1]);
        else
          *reinterpret_cast<uint32_t*>(idx + off) = w[0];
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j)
          if (c0 + j < C) idx[off + j] = k_of[j];
      }
    }
  }
}

// The forward's launch: groups of channel vectors, runs of window rows
// (a later run stages one x row more, half a step), the ring's shared memory.
struct FwdPlan {
  int nv, threads;
  int64_t groups, blocks, rows, runs;
  size_t smem;
};

template <auto Kernel, typename T>
FwdPlan fwd_plan(int64_t N, int64_t H, int64_t W, int64_t C) {
  const int64_t Ho = H / 2, Wo = W / 2;
  const Groups gr = channel_groups(C, kVec<T>, Wo);
  FwdPlan p;
  p.nv = gr.nv;
  p.groups = gr.groups;
  p.threads = gr.nv * int(Wo);
  p.smem = fwd_smem_bytes(W, gr.nv);
  const int64_t tiles = N * gr.groups;
  const int64_t per_wave = wave<Kernel>(p.threads, p.smem, fwd_smem_bytes(2 * kMaxThreads, 1));
  choose_runs(tiles, Ho, per_wave, 1, &p.rows, &p.runs);
  p.blocks = tiles * p.runs;
  return p;
}

}  // namespace strip
}  // namespace fav
