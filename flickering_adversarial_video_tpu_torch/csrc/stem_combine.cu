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
// Bound on the H100: bytes (KT+1 tensor traversals, one add per element).
// Design: one thread per output element, channels fastest, so every one of
// the KT loads and the store is coalesced; part is read exactly once overall.

#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(fav::kThreads)
temporal_combine_kernel(const T* __restrict__ part, T* __restrict__ out, int64_t n_out, int T_,
                        int64_t S, int cin, int n_taps, int t_plo) {
  const int64_t ktc = int64_t(n_taps) * cin;
  for (int64_t i = fav::global_tid(); i < n_out; i += fav::grid_stride()) {
    const int c = int(i % cin);
    const int64_t r = i / cin;
    const int64_t s = r % S;
    const int64_t bt = r / S;
    const int t = int(bt % T_);
    const int64_t b = bt / T_;
    float acc = 0.f;
    for (int m = 0; m < n_taps; ++m) {
      const int ts = t + t_plo - m;
      float v = 0.f;
      if (ts >= 0 && ts < T_) v = fav::to_f(part[((b * T_ + ts) * S + s) * ktc + int64_t(m) * cin + c]);
      acc = (m == 0) ? v : fav::rt<T>(acc + v);
    }
    out[i] = fav::from_f<T>(acc);
  }
}

}  // namespace

FAV_API int fav_temporal_combine(const void* part, void* out, int64_t B, int64_t T, int64_t S,
                                 int64_t cin, int64_t n_taps, int64_t t_plo, int dtype,
                                 void* stream) {
  const int64_t n = B * T * S * cin;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fav::kBF16) {
    temporal_combine_kernel<__nv_bfloat16><<<fav::grid_for(n), fav::kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(part), static_cast<__nv_bfloat16*>(out), n, int(T), S,
        int(cin), int(n_taps), int(t_plo));
  } else if (dtype == fav::kF32) {
    temporal_combine_kernel<float><<<fav::grid_for(n), fav::kThreads, 0, s>>>(
        static_cast<const float*>(part), static_cast<float*>(out), n, int(T), S, int(cin),
        int(n_taps), int(t_plo));
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
