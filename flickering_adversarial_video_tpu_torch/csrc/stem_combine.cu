// B2: the temporal combine after a KT>=2 conv's wide input-gradient conv.
//
// Replaces the Pallas kernel ops/stem_combine_pallas.py:74
// catbwd_lane_combine_pallas (kernel `_kernel` :63) of the JAX package.
//
//   dx[b,t,s,c] = sum_{m=0}^{KT-1} part[b, t + t_plo - m, s, m*Cin + c]
//
// with zero past the temporal edges, added in the tensor dtype in ascending m
// (one rounding per add, the association of the JAX chain).  part is
// [B,T,S,KT*Cin] (S = H*W, NDHWC), dx [B,T,S,Cin].
//
// Bound on the H100: bytes (part read once, dx written once; one add per
// element).  Design: a thread owns one 16-byte channel vector of dx (8 bf16
// or 4 f32 channels) at one (b, s) position and a run of frames.
// Consecutive threads take consecutive vectors, then consecutive s, so every
// load and store of a warp is a coalesced run of 16-byte accesses.  The
// index arithmetic is done once a thread; per frame the KT loads (frames
// t + t_plo - m, channel block m) are issued together, then added.  KT is a
// template argument for the path's 3 (Conv3d_2c and every Mixed conv) and 4
// (the packed stem); a generic instance serves the rest.  A launch with fewer
// vectors than four waves of threads splits T into runs.  A Cin that is no
// multiple of the vector takes the scalar tail (channel by channel).

#include "common.cuh"

namespace {

using namespace fav;  // the 16-byte channel vectors of common.cuh

// acc = v (first) or acc + v rounded to T, channel by channel
template <typename T>
__device__ __forceinline__ void add_rt(float (&acc)[kVec<T>], const uint4& v, bool first) {
  float f[kVec<T>];
  unpack<T>(v, f);
#pragma unroll
  for (int j = 0; j < kVec<T>; ++j) acc[j] = first ? f[j] : rt<T>(acc[j] + f[j]);
}

template <typename T, int KT, bool VEC>
__global__ void __launch_bounds__(kThreads)
temporal_combine_kernel(const T* __restrict__ part, T* __restrict__ out, int64_t n_vec, int T_,
                        int64_t S, int cin, int n_taps, int t_plo, int frames) {
  constexpr int N = kVec<T>;
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_vec) return;
  const int nv = (cin + N - 1) / N;
  const int c0 = int(i % nv) * N;
  const int64_t bs = i / nv;  // b * S + s
  const int64_t b = bs / S, s = bs - b * S;
  const int taps = KT > 0 ? KT : n_taps;
  const int64_t ktc = int64_t(taps) * cin;
  const int64_t pframe = S * ktc, oframe = S * int64_t(cin);  // one frame of part, of dx
  const T* src = part + b * T_ * pframe + s * ktc + c0;
  T* dst = out + b * T_ * oframe + s * cin + c0;
  const int t0 = int(blockIdx.y) * frames, t1 = min(t0 + frames, T_);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int t = t0; t < t1; ++t) {
    float acc[N];
    if constexpr (KT > 0) {
      uint4 v[KT];
#pragma unroll
      for (int m = 0; m < KT; ++m) {
        const int ts = t + t_plo - m;
        v[m] = ts >= 0 && ts < T_ ? load_vec<T, VEC>(src, ts * pframe + m * cin, c0, cin, 0.f)
                                  : zero;
      }
#pragma unroll
      for (int m = 0; m < KT; ++m) add_rt<T>(acc, v[m], m == 0);
    } else {
      for (int m = 0; m < taps; ++m) {
        const int ts = t + t_plo - m;
        const uint4 v = ts >= 0 && ts < T_
                            ? load_vec<T, VEC>(src, ts * pframe + m * cin, c0, cin, 0.f)
                            : zero;
        add_rt<T>(acc, v, m == 0);
      }
    }
    store_vec<T, VEC>(dst, t * oframe, c0, cin, pack_exact<T>(acc));
  }
}

template <typename T, int KT, bool VEC>
int launch(const void* part, void* out, int64_t B, int64_t T_, int64_t S, int64_t cin,
           int64_t n_taps, int64_t t_plo, cudaStream_t s) {
  const int64_t n_vec = B * S * ((cin + kVec<T> - 1) / kVec<T>);
  if (n_vec == 0 || T_ == 0) return 0;
  // runs for about 4 waves of threads: against 1 wave, the single-video
  // stem's 0.0754 ms became 0.0565, the B=8 stem stayed at 0.400, the 19
  // launches of a B=8 step went from 0.337 to 0.333 (device time,
  // scripts/torch_stem_combine_bench.py, H100 80GB HBM3 at 700 W)
  static const int64_t wave =
      wave_blocks(temporal_combine_kernel<T, KT, VEC>, kThreads, 0) * kThreads;
  const int64_t runs =
      std::min<int64_t>(std::max<int64_t>((4 * wave + n_vec - 1) / n_vec, 1), T_);
  const int64_t frames = (T_ + runs - 1) / runs;
  const dim3 grid(unsigned((n_vec + kThreads - 1) / kThreads), unsigned((T_ + frames - 1) / frames));
  temporal_combine_kernel<T, KT, VEC><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(part), static_cast<T*>(out), n_vec, int(T_), S, int(cin), int(n_taps),
      int(t_plo), int(frames));
  return int(cudaGetLastError());
}

template <typename T>
int launch_combine(const void* part, void* out, int64_t B, int64_t T_, int64_t S, int64_t cin,
                   int64_t n_taps, int64_t t_plo, cudaStream_t s) {
  if (cin % kVec<T> == 0 && aligned16(part) && aligned16(out)) {
    if (n_taps == 3) return launch<T, 3, true>(part, out, B, T_, S, cin, n_taps, t_plo, s);
    if (n_taps == 4) return launch<T, 4, true>(part, out, B, T_, S, cin, n_taps, t_plo, s);
    return launch<T, 0, true>(part, out, B, T_, S, cin, n_taps, t_plo, s);
  }
  return launch<T, 0, false>(part, out, B, T_, S, cin, n_taps, t_plo, s);
}

}  // namespace

FAV_API int fav_temporal_combine(const void* part, void* out, int64_t B, int64_t T, int64_t S,
                                 int64_t cin, int64_t n_taps, int64_t t_plo, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fav::kBF16)
    return launch_combine<__nv_bfloat16>(part, out, B, T, S, cin, n_taps, t_plo, s);
  if (dtype == fav::kF32) return launch_combine<float>(part, out, B, T, S, cin, n_taps, t_plo, s);
  return int(cudaErrorInvalidValue);
}
