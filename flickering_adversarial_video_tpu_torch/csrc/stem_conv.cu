// B1: the packed I3D stem conv + frozen BN + relu, one pass.
//
// Replaces the Pallas kernel ops/stem_conv_pallas.py:152
// stem_conv_bn_relu_view_pallas (kernel `_kernel` :82) of the JAX package.
//
//   y[b,t,h,w,co] = relu(bn(sum_{m,kh,kw,ci} x[b,t+m-1,h+kh-1,w+kw-1,ci]
//                                           * k[m,kh,kw,ci,co]))
//
// x [B,T,H,W,24] is the space-to-depth packed clip (NDHWC), k [4,4,4,24,64]
// the packed 7x7x7/s2 stem kernel, SAME pads (1,2) on T, H and W.  All 64 taps
// accumulate in one f32 contraction; the sum is rounded to the tensor dtype and
// BN ((y-mean)*rsqrt(var+eps)+bias) and relu follow in that dtype, one rounding
// per op, in the Pallas kernel's order.
//
// Bound on the H100: operations.  At B=8, T=64, 224^2 the call does about
// 631 GFLOP over ~205 MB of input and output, ~3000 FLOP per byte, far above
// the card's ~295 FLOP/byte ridge in bf16.  Design: an implicit GEMM on the
// tensor cores through warp-level mma (wmma 16x16x16 bf16, f32 accumulate).
// One block owns two output rows (b,t,h..h+1); each of its 8 warps owns
// M = W positions of one row x 16 of the 64 channels.  The contraction is
// walked as 16 (m,kh) slices of K=96, and each slice's A operand is a plain
// strided view of one staged input row (4 neighbouring positions x 24
// channels are 96 contiguous values), so no im2col buffer exists.  The
// weight is staged one temporal tap at a time (49 KB, shared by both rows)
// beside the five input rows of that tap, copied in 16-byte vectors.
// wgmma/TMA pipelining is later work.
//
// The f32 variant (used only to compare against the plain version) runs the
// same staging, one output row per block, on the CUDA cores.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int CIN = 24, COUT = 64, KT = 4, KH = 4, KW = 4;
constexpr int KROW = KW * CIN;        // 96: one (m, kh) slice of the contraction
constexpr int MAX_W = 128;            // widest output row one block owns
constexpr int NPOS = MAX_W + 8;       // staged input positions per row (>= MAX_W + 3)
constexpr int XROW = NPOS * CIN;      // elements of one staged input row
constexpr int WTAP = KH * KROW * COUT;  // elements of one temporal tap of k
constexpr int MT = MAX_W / 16;        // M tiles per row

// Stage temporal tap m of the weight and input rows h-1 .. h+NROWS-2 of frame
// ti (the rows that NROWS-KH+1 consecutive output rows from h read).
template <int NROWS, typename T>
__device__ void stage_tap(T* ws, T* xs, const T* __restrict__ x, const T* __restrict__ k,
                          int b, int ti, int m, int h, int T_, int H, int W) {
  // weights of temporal tap m: contiguous, 16-byte vector copies
  const uint4* src = reinterpret_cast<const uint4*>(k + int64_t(m) * WTAP);
  uint4* dst = reinterpret_cast<uint4*>(ws);
  constexpr int NV = WTAP * int(sizeof(T)) / 16;
  for (int i = threadIdx.x; i < NV; i += blockDim.x) dst[i] = src[i];
  // zero-padded rows: xs[j][p][ci] = x[b, ti, h+j-1, p-1, ci].
  // A position's CIN channels are VPP 16-byte vectors; a row of x is
  // contiguous, so the copy is vectorized along the row.
  constexpr int VPP = CIN * int(sizeof(T)) / 16;
  constexpr int ROWV = NPOS * VPP;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  uint4* xv = reinterpret_cast<uint4*>(xs);
  for (int i = threadIdx.x; i < NROWS * ROWV; i += blockDim.x) {
    const int j = i / ROWV, v = i % ROWV;
    const int hi = h + j - 1, wi = v / VPP - 1;
    uint4 val = zero;
    if (hi >= 0 && hi < H && wi >= 0 && wi < W) {
      const uint4* row = reinterpret_cast<const uint4*>(
          x + ((int64_t(b) * T_ + ti) * H + hi) * int64_t(W) * CIN);
      val = row[v - VPP];
    }
    xv[i] = val;
  }
}

constexpr int RPB = 2;                  // output rows per block (bf16 path)
constexpr int XROWS = RPB + KH - 1;     // staged input rows
constexpr size_t SMEM_BF16 = size_t(WTAP) * 2 + size_t(XROWS) * XROW * 2;  // 81792 B
constexpr int THREADS_BF16 = 32 * 4 * RPB;  // warp 4r+j: output row r, channels 16j..16j+15
static_assert(size_t(RPB) * MAX_W * COUT * 4 <= SMEM_BF16, "f32 epilogue must fit");

__global__ void __launch_bounds__(THREADS_BF16)
stem_conv_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ k,
                      const float* __restrict__ mean, const float* __restrict__ mul,
                      const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                      int B, int T_, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xs = ws + WTAP;
  const int n_hb = (H + RPB - 1) / RPB;
  const int h0 = (blockIdx.x % n_hb) * RPB;  // output rows h0 .. h0+RPB-1 of (b, t)
  const int t = (blockIdx.x / n_hb) % T_;
  const int b = blockIdx.x / (n_hb * T_);
  const int warp = threadIdx.x / 32;
  const int r = warp / 4, nt = warp % 4;
  const int h = h0 + r;
  const bool row_ok = h < H;  // uniform per warp
  const int n_mt = (W + 15) / 16;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) wmma::fill_fragment(acc[i], 0.0f);

  for (int m = 0; m < KT; ++m) {
    const int ti = t + m - 1;
    if (ti < 0 || ti >= T_) continue;  // uniform over the block
    __syncthreads();
    stage_tap<XROWS>(ws, xs, x, k, b, ti, m, h0, T_, H, W);
    __syncthreads();
    if (!row_ok) continue;
    for (int kh = 0; kh < KH; ++kh) {
      const int hi = h + kh - 1;
      if (hi < 0 || hi >= H) continue;
      const __nv_bfloat16* xrow = xs + (r + kh) * XROW;
#pragma unroll
      for (int kk = 0; kk < KROW / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, ws + (kh * KROW + kk * 16) * COUT + nt * 16, COUT);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (mt < n_mt) {
            // rows w = 16mt..16mt+15 of A start at staged position w, stride CIN
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
            wmma::load_matrix_sync(af, xrow + mt * 16 * CIN + kk * 16, CIN);
            wmma::mma_sync(acc[mt], af, bf, acc[mt]);
          }
        }
      }
    }
  }
  __syncthreads();
  float* ys = reinterpret_cast<float*>(smem);  // [RPB][MAX_W][COUT] f32 over the stage
  if (row_ok) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      if (mt < n_mt)
        wmma::store_matrix_sync(ys + (r * MAX_W + mt * 16) * COUT + nt * 16, acc[mt], COUT,
                                wmma::mem_row_major);
  }
  __syncthreads();
  for (int rr = 0; rr < RPB && h0 + rr < H; ++rr) {
    __nv_bfloat16* yrow = y + ((int64_t(b) * T_ + t) * H + h0 + rr) * W * COUT;
    const float* yr = ys + rr * MAX_W * COUT;
    for (int i = threadIdx.x; i < W * COUT; i += blockDim.x) {
      const int co = i % COUT;
      using fav::rt;
      float v = rt<__nv_bfloat16>(yr[i]);
      v = rt<__nv_bfloat16>(__fsub_rn(v, rt<__nv_bfloat16>(mean[co])));
      v = rt<__nv_bfloat16>(__fmul_rn(v, rt<__nv_bfloat16>(mul[co])));
      v = rt<__nv_bfloat16>(__fadd_rn(v, rt<__nv_bfloat16>(bias[co])));
      yrow[i] = __float2bfloat16(fmaxf(v, 0.f));
    }
  }
}

constexpr size_t SMEM_F32 = size_t(WTAP) * 4 + size_t(KH) * XROW * 4;  // 150528 B
constexpr int THREADS_F32 = 256;
constexpr int WPT = MAX_W / (THREADS_F32 / COUT);  // 32 output positions per thread

__global__ void __launch_bounds__(THREADS_F32)
stem_conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ k,
                     const float* __restrict__ mean, const float* __restrict__ mul,
                     const float* __restrict__ bias, float* __restrict__ y,
                     int B, int T_, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);
  float* xs = ws + WTAP;
  const int row = blockIdx.x;
  const int h = row % H;
  const int t = (row / H) % T_;
  const int b = row / (H * T_);
  const int co = threadIdx.x % COUT;
  const int wg = threadIdx.x / COUT;  // positions wg, wg+4, ...
  constexpr int WSTEP = THREADS_F32 / COUT;

  float acc[WPT];
#pragma unroll
  for (int i = 0; i < WPT; ++i) acc[i] = 0.f;

  for (int m = 0; m < KT; ++m) {
    const int ti = t + m - 1;
    if (ti < 0 || ti >= T_) continue;
    __syncthreads();
    stage_tap<KH>(ws, xs, x, k, b, ti, m, h, T_, H, W);
    __syncthreads();
    for (int kh = 0; kh < KH; ++kh) {
      const int hi = h + kh - 1;
      if (hi < 0 || hi >= H) continue;
      for (int kq = 0; kq < KROW; ++kq) {
        const float wv = ws[(kh * KROW + kq) * COUT + co];
        const float* xr = xs + kh * XROW + kq;
#pragma unroll
        for (int i = 0; i < WPT; ++i) acc[i] = fmaf(xr[(wg + WSTEP * i) * CIN], wv, acc[i]);
      }
    }
  }
  float* yrow = y + int64_t(row) * W * COUT;
  const float mn = mean[co], ml = mul[co], bs = bias[co];
#pragma unroll
  for (int i = 0; i < WPT; ++i) {
    const int w = wg + WSTEP * i;
    if (w < W) {
      const float v = __fadd_rn(__fmul_rn(__fsub_rn(acc[i], mn), ml), bs);
      yrow[int64_t(w) * COUT + co] = fmaxf(v, 0.f);
    }
  }
}

}  // namespace

FAV_API int fav_stem_conv_bn_relu(const void* x, const void* k, const void* mean,
                                  const void* mul, const void* bias, void* y, int64_t B,
                                  int64_t T, int64_t H, int64_t W, int dtype, void* stream) {
  if (W > MAX_W || W < 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == fav::kBF16) {
    err = cudaFuncSetAttribute(stem_conv_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(SMEM_BF16));
    if (err != cudaSuccess) return int(err);
    const unsigned blocks = unsigned(B * T * ((H + RPB - 1) / RPB));
    stem_conv_bf16_kernel<<<blocks, THREADS_BF16, SMEM_BF16, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(k),
        static_cast<const float*>(mean), static_cast<const float*>(mul),
        static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), int(B), int(T), int(H),
        int(W));
  } else if (dtype == fav::kF32) {
    err = cudaFuncSetAttribute(stem_conv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(SMEM_F32));
    if (err != cudaSuccess) return int(err);
    stem_conv_f32_kernel<<<unsigned(B * T * H), THREADS_F32, SMEM_F32, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(k),
        static_cast<const float*>(mean), static_cast<const float*>(mul),
        static_cast<const float*>(bias), static_cast<float*>(y), int(B), int(T), int(H), int(W));
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

FAV_API const char* fav_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
