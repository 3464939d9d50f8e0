// B12: the frozen batch-norm epilogue of the video ResNets, forward and backward.
//
// Replaces no Pallas kernel: the JAX package leaves flax's inference
// BatchNorm and the ReLU and residual add after it to XLA, which fuses them.
// In the port that chain was about six PyTorch elementwise kernels each way
// (f32 broadcast passes over a bf16 activation, casts, a separate ReLU, the
// residual add), some 56 bytes an element of both passes.
//
// Forward, x [.., C] contiguous (NDHWC) in T (bf16 or f32), the f32 tables
// mean, mul (rsqrt(var + eps) * weight, computed by the caller) and bias [C]:
//
//   y = act(T(((x - mean) * mul) + bias) [+ residual])
//
// in f32 without contraction, one round to nearest even to T (flax's
// inference BatchNorm in its op order, ops/bn_epilogue.py); the residual (T)
// added in f32 and rounded once to T, as PyTorch adds two T tensors; act =
// ReLU as ATen's clamp_min(v, 0): a NaN passes, else fmaxf(v, 0).  A residual
// is added only before a ReLU (a BasicBlock's end).
// Backward from the upstream g and the saved y:
//
//   g' = (y <= 0) ? 0 : g  (ATen's threshold_backward, where ReLU ran)
//   dx = T(f32(g') * mul),  dres = g'  (where a residual was added)
//
// Bound on the H100: bytes (the forward reads x [and the residual] and
// writes y; the backward reads g [and y] and writes dx [and dres]).  Design:
// 16-byte vectors (8 bf16 or 4 f32 elements).  Thread i takes vectors i,
// i + S, i + 2S, ... where S, the threads that take part (about one wave),
// is a multiple of the channel period L = C / gcd(C, N) vectors: every
// vector of a thread then starts at the same channel, so the thread reads
// its N channels' table entries once into registers, and C need not divide
// a vector (45, 230, 460, 921).  A thread loads kUnroll vectors before it
// computes any.  The n % N elements past the last whole vector are taken,
// element by element, by the thread whose next vector that would be.
// Pointers that are not 16-byte aligned take the same loops with element
// loads and stores.

#include <numeric>

#include "common.cuh"

namespace {

using namespace fav;

constexpr int kUnroll = 4;

// ATen's relu, clamp_min(v, 0): NaN passes through
__device__ __forceinline__ float relu_f(float v) { return isnan(v) ? v : fmaxf(v, 0.f); }

// a value of T held in a float, back to T bit for bit (a NaN keeps its
// payload, as g' keeps g's; from_f would make it the canonical NaN)
template <typename T>
__device__ __forceinline__ T exact(float v) {
  if constexpr (sizeof(T) == 4)
    return v;
  else
    return __ushort_as_bfloat16(static_cast<unsigned short>(__float_as_uint(v) >> 16));
}

template <typename T, bool VEC>
__device__ __forceinline__ uint4 ld(const T* __restrict__ p, int64_t e) {
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const uint4*>(p + e));
  } else {
    float f[kVec<T>];
#pragma unroll
    for (int j = 0; j < kVec<T>; ++j) f[j] = to_f(p[e + j]);
    return pack_exact<T>(f);
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void st(T* __restrict__ p, int64_t e, const float (&f)[kVec<T>]) {
  if constexpr (VEC) {
    *reinterpret_cast<uint4*>(p + e) = pack_exact<T>(f);
  } else {
#pragma unroll
    for (int j = 0; j < kVec<T>; ++j) p[e + j] = exact<T>(f[j]);
  }
}

// one element of the forward; the result is a value of T
template <typename T, bool RES, bool RELU>
__device__ __forceinline__ float fwd1(float x, float r, float m, float k, float b) {
  float v = rt<T>(__fadd_rn(__fmul_rn(__fsub_rn(x, m), k), b));
  if constexpr (RES) v = rt<T>(__fadd_rn(v, r));
  if constexpr (RELU) v = relu_f(v);
  return v;
}

// the channel of this thread's first element: (i * N) mod C
template <typename T>
__device__ __forceinline__ int first_channel(int64_t i, int C) {
  return int((i * kVec<T>) % C);
}

template <typename T, bool VEC, bool RES, bool RELU>
__global__ void __launch_bounds__(kThreads)
bn_epilogue_fwd_kernel(const T* __restrict__ x, const T* __restrict__ res,
                       const float* __restrict__ mean, const float* __restrict__ mul,
                       const float* __restrict__ bias, T* __restrict__ y, int64_t n, int C,
                       int64_t S) {
  constexpr int N = kVec<T>;
  const int64_t i = global_tid();
  if (i >= S) return;
  float m[N], k[N], b[N];
  int c = first_channel<T>(i, C);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    m[j] = __ldg(mean + c);
    k[j] = __ldg(mul + c);
    b[j] = __ldg(bias + c);
    if (++c == C) c = 0;
  }
  const int64_t full = n / N;
  int64_t v = i;
  for (; v + (kUnroll - 1) * S < full; v += kUnroll * S) {
    uint4 xr[kUnroll], rr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      xr[u] = ld<T, VEC>(x, (v + u * S) * N);
      if constexpr (RES) rr[u] = ld<T, VEC>(res, (v + u * S) * N);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float xf[N], rf[N], out[N];
      unpack<T>(xr[u], xf);
      if constexpr (RES) unpack<T>(rr[u], rf);
#pragma unroll
      for (int j = 0; j < N; ++j)
        out[j] = fwd1<T, RES, RELU>(xf[j], RES ? rf[j] : 0.f, m[j], k[j], b[j]);
      st<T, VEC>(y, (v + u * S) * N, out);
    }
  }
  for (; v < full; v += S) {
    float xf[N], rf[N], out[N];
    unpack<T>(ld<T, VEC>(x, v * N), xf);
    if constexpr (RES) unpack<T>(ld<T, VEC>(res, v * N), rf);
#pragma unroll
    for (int j = 0; j < N; ++j)
      out[j] = fwd1<T, RES, RELU>(xf[j], RES ? rf[j] : 0.f, m[j], k[j], b[j]);
    st<T, VEC>(y, v * N, out);
  }
  if (v == full) {  // the elements past the last whole vector, if any
    const int64_t e = full * N;
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (e + j < n)
        y[e + j] = exact<T>(fwd1<T, RES, RELU>(to_f(x[e + j]), RES ? to_f(res[e + j]) : 0.f,
                                                m[j], k[j], b[j]));
  }
}

// one element of the backward: dx, and g' (dres) in `gp`
template <typename T, bool RELU>
__device__ __forceinline__ float bwd1(float g, float yv, float k, float& gp) {
  gp = RELU && yv <= 0.f ? 0.f : g;
  return rt<T>(__fmul_rn(gp, k));
}

template <typename T, bool VEC, bool RES, bool RELU>
__global__ void __launch_bounds__(kThreads)
bn_epilogue_bwd_kernel(const T* __restrict__ g, const T* __restrict__ y,
                       const float* __restrict__ mul, T* __restrict__ dx, T* __restrict__ dres,
                       int64_t n, int C, int64_t S) {
  constexpr int N = kVec<T>;
  const int64_t i = global_tid();
  if (i >= S) return;
  float k[N];
  int c = first_channel<T>(i, C);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    k[j] = __ldg(mul + c);
    if (++c == C) c = 0;
  }
  const int64_t full = n / N;
  int64_t v = i;
  for (; v + (kUnroll - 1) * S < full; v += kUnroll * S) {
    uint4 gr[kUnroll], yr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      gr[u] = ld<T, VEC>(g, (v + u * S) * N);
      if constexpr (RELU) yr[u] = ld<T, VEC>(y, (v + u * S) * N);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float gf[N], yf[N], d[N], gp[N];
      unpack<T>(gr[u], gf);
      if constexpr (RELU) unpack<T>(yr[u], yf);
#pragma unroll
      for (int j = 0; j < N; ++j) d[j] = bwd1<T, RELU>(gf[j], RELU ? yf[j] : 1.f, k[j], gp[j]);
      st<T, VEC>(dx, (v + u * S) * N, d);
      if constexpr (RES) st<T, VEC>(dres, (v + u * S) * N, gp);
    }
  }
  for (; v < full; v += S) {
    float gf[N], yf[N], d[N], gp[N];
    unpack<T>(ld<T, VEC>(g, v * N), gf);
    if constexpr (RELU) unpack<T>(ld<T, VEC>(y, v * N), yf);
#pragma unroll
    for (int j = 0; j < N; ++j) d[j] = bwd1<T, RELU>(gf[j], RELU ? yf[j] : 1.f, k[j], gp[j]);
    st<T, VEC>(dx, v * N, d);
    if constexpr (RES) st<T, VEC>(dres, v * N, gp);
  }
  if (v == full) {  // the elements past the last whole vector, if any
    const int64_t e = full * N;
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (e + j < n) {
        float gp;
        dx[e + j] = exact<T>(bwd1<T, RELU>(to_f(g[e + j]), RELU ? to_f(y[e + j]) : 1.f, k[j], gp));
        if constexpr (RES) dres[e + j] = exact<T>(gp);
      }
  }
}

// S: the threads that take part, a multiple of the channel period, about
// one wave of resident threads and no more than the vectors need
template <typename T>
int64_t spread(int64_t n, int64_t C, int64_t wave_threads) {
  const int64_t period = C / std::gcd(C, int64_t(kVec<T>));
  const int64_t vecs = (n + kVec<T> - 1) / kVec<T>;
  const int64_t k = std::min(wave_threads / period, (vecs + period - 1) / period);
  return std::max<int64_t>(k, 1) * period;
}

template <typename T, bool RES, bool RELU>
int launch_fwd(const void* x, const void* res, const void* mean, const void* mul,
               const void* bias, void* y, int64_t n, int64_t C, bool vec, cudaStream_t s) {
  const auto kernel = vec ? bn_epilogue_fwd_kernel<T, true, RES, RELU>
                          : bn_epilogue_fwd_kernel<T, false, RES, RELU>;
  // taken at the first launch (the warm-up before a graph's capture)
  static const int64_t wave =
      wave_blocks(bn_epilogue_fwd_kernel<T, true, RES, RELU>, kThreads, 0) * kThreads;
  const int64_t S = spread<T>(n, C, wave);
  kernel<<<unsigned((S + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const float*>(mean),
      static_cast<const float*>(mul), static_cast<const float*>(bias), static_cast<T*>(y), n,
      int(C), S);
  return int(cudaGetLastError());
}

template <typename T, bool RES, bool RELU>
int launch_bwd(const void* g, const void* y, const void* mul, void* dx, void* dres, int64_t n,
               int64_t C, bool vec, cudaStream_t s) {
  const auto kernel = vec ? bn_epilogue_bwd_kernel<T, true, RES, RELU>
                          : bn_epilogue_bwd_kernel<T, false, RES, RELU>;
  static const int64_t wave =
      wave_blocks(bn_epilogue_bwd_kernel<T, true, RES, RELU>, kThreads, 0) * kThreads;
  const int64_t S = spread<T>(n, C, wave);
  kernel<<<unsigned((S + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(y), static_cast<const float*>(mul),
      static_cast<T*>(dx), static_cast<T*>(dres), n, int(C), S);
  return int(cudaGetLastError());
}

template <typename T>
int fwd_typed(const void* x, const void* res, const void* mean, const void* mul, const void* bias,
              void* y, int64_t n, int64_t C, bool relu, cudaStream_t s) {
  const bool vec = aligned16(x) && aligned16(y) && (res == nullptr || aligned16(res));
  if (res) return launch_fwd<T, true, true>(x, res, mean, mul, bias, y, n, C, vec, s);
  return relu ? launch_fwd<T, false, true>(x, res, mean, mul, bias, y, n, C, vec, s)
              : launch_fwd<T, false, false>(x, res, mean, mul, bias, y, n, C, vec, s);
}

// dres only with y: a residual is added only before a ReLU
template <typename T>
int bwd_typed(const void* g, const void* y, const void* mul, void* dx, void* dres, int64_t n,
              int64_t C, cudaStream_t s) {
  const bool vec = aligned16(g) && aligned16(dx) && (y == nullptr || aligned16(y)) &&
                   (dres == nullptr || aligned16(dres));
  if (dres) return launch_bwd<T, true, true>(g, y, mul, dx, dres, n, C, vec, s);
  return y ? launch_bwd<T, false, true>(g, y, mul, dx, dres, n, C, vec, s)
           : launch_bwd<T, false, false>(g, y, mul, dx, dres, n, C, vec, s);
}

}  // namespace

// x, res (or null; then relu is 1), mean, mul, bias [C] f32, y; n elements, C channels;
// relu 0/1
FAV_API int fav_bn_epilogue_fwd(const void* x, const void* res, const void* mean, const void* mul,
                                const void* bias, void* y, int64_t n, int64_t C, int relu,
                                int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || C <= 0) return n == 0 ? 0 : int(cudaErrorInvalidValue);
  if (res != nullptr && relu == 0) return int(cudaErrorInvalidValue);
  if (dtype == fav::kBF16)
    return fwd_typed<__nv_bfloat16>(x, res, mean, mul, bias, y, n, C, relu != 0, s);
  if (dtype == fav::kF32) return fwd_typed<float>(x, res, mean, mul, bias, y, n, C, relu != 0, s);
  return int(cudaErrorInvalidValue);
}

// g, y (or null: no ReLU), mul [C] f32, dx, dres (or null: no residual; else y too); n, C
FAV_API int fav_bn_epilogue_bwd(const void* g, const void* y, const void* mul, void* dx,
                                void* dres, int64_t n, int64_t C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || C <= 0) return n == 0 ? 0 : int(cudaErrorInvalidValue);
  if (dres != nullptr && y == nullptr) return int(cudaErrorInvalidValue);
  if (dtype == fav::kBF16) return bwd_typed<__nv_bfloat16>(g, y, mul, dx, dres, n, C, s);
  if (dtype == fav::kF32) return bwd_typed<float>(g, y, mul, dx, dres, n, C, s);
  return int(cudaErrorInvalidValue);
}
