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
// per op, in the Pallas kernel's order.  Relu keeps a NaN, as jnp.maximum.
//
// Bound on the H100: operations.  At B=8, T=64, 224^2 (x [8,32,112,112,24])
// the call does about 631 GFLOP over 565 MB (x 154 MB read, y 411 MB
// written), ~1,100 FLOP per byte, far above the card's ~295 FLOP/byte ridge
// in bf16.
//
// Design (bf16): an implicit GEMM, M = output positions of a row, N = 64
// channels, K = 1536 = 16 (m,kh) input rows x 96.  In NDHWC the 4 W-taps x 24
// channels that output w reads from one input row are 96 contiguous values
// starting at position w, so A needs no im2col copy: rows of A are 48 bytes
// apart in the staged input row and are read with ldmatrix into registers
// (8 rows 48 B apart fall on 8 different 16-byte bank groups).
// - A persistent grid, one block per SM, 288 threads: two consumer
//   warpgroups, each owning 64 of an output row's <=128 positions, and one
//   producer warp.  A block walks work items of two output rows (b,t,h,h+1).
// - The whole bf16 weight (196,608 B) is staged once per block, in wgmma's
//   K-major layout with the 128-byte swizzle (24 blocks of 64 rows of K=64).
// - The input rows an item reads (<= 4 frames x 5 rows) stream through a
//   ring of 5 row buffers in shared memory, filled by cp.async.bulk and
//   completed on mbarriers, so the next rows land while this one is
//   multiplied; the producer runs ahead across items.  Each staged row
//   feeds both output rows (kernel rows kh and kh-1), so A is read once for
//   both.  Zero pads are written once: positions 0 and W+1.. of every buffer.
// - wgmma m64n64k16: A from registers, B (the weight) from shared memory, so
//   one instruction covers all 64 channels: a staged row is 12 wgmmas a
//   warpgroup (6 for each output row), and the two warpgroups' wgmmas
//   interleave on the SM's tensor cores.  The 20 rows of an item are
//   unrolled, a row outside the clip read as zeros, so that no wgmma sits on
//   a divergent path (ptxas would serialize them).
// - BN and relu run from the accumulator registers; the four lanes of a quad
//   swap their channel pairs so that y is stored in 16-byte vectors.
//
// The f32 variant (used only to compare against the plain version) stages
// the weight one temporal tap at a time, one output row per block, and runs
// on the CUDA cores.

#include "common.cuh"

namespace {

constexpr int CIN = 24, COUT = 64, KT = 4, KH = 4, KW = 4;
constexpr int KROW = KW * CIN;          // 96: one (m, kh) slice of the contraction
constexpr int KTOT = KT * KH * KROW;    // 1536
constexpr int MAX_W = 128;              // widest output row
constexpr int KSTEPS = KROW / 16;       // 6 k-steps of 16 a slice

// ---- bf16: tensor cores -------------------------------------------------------
constexpr int ROW_POS = MAX_W + 3;               // staged positions: pads 1 left, 2 right
constexpr int SLOT_BYTES = ROW_POS * CIN * 2;    // 6288
constexpr int RING = 5;
constexpr int W_BYTES = KTOT * COUT * 2;         // 196608
constexpr int KBLK = 64;                         // K of one 128-byte swizzled row
constexpr int KBLK_BYTES = COUT * KBLK * 2;      // 8192
constexpr int CONSUMERS = 256;                   // two warpgroups
constexpr int THREADS_BF16 = CONSUMERS + 32;     // and a producer warp
// + 2 mbarriers a buffer and 16 zero bytes
constexpr size_t SMEM_BF16 = 1024 + W_BYTES + RING * SLOT_BYTES + 2 * RING * 8 + 16;
static_assert(SMEM_BF16 <= 232448, "shared memory of one block");
static_assert(SLOT_BYTES % 16 == 0, "bulk copies need 16-byte slots");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Byte offset of weight element (n = co, k) in the K-major 128-byte-swizzled
// layout: K blocks of 64, each 64 rows (n) of 128 bytes, the 16-byte chunk
// index XORed with n % 8.
__device__ __forceinline__ uint32_t wsw(int n, int k) {
  const int chunk = (k % KBLK) / 8;
  return (k / KBLK) * KBLK_BYTES + n * 128 + ((chunk ^ (n & 7)) << 4) + (k % 8) * 2;
}

// Shared-memory matrix descriptor of a K-major, 128-byte-swizzled B tile:
// rows 128 B apart, 8-row groups 1024 B apart.
__device__ __forceinline__ uint64_t wdesc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64x64] += a[64x16] (registers, this warp's 16 rows) * B[16x64] (shared)
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// acc += A (this staged row, in registers) * the weight of (m,kh) slice `s`
__device__ __forceinline__ void slice_wgmma(float (&acc)[32], const uint32_t (&a)[KSTEPS][4],
                                            int s, uint32_t wbase) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int j = s * KSTEPS + kk;  // global k-step: K block j/4, 32 bytes into its rows
    wgmma_64x64x16(acc, a[kk], wdesc(wbase + (j >> 2) * KBLK_BYTES + (j & 3) * 32));
  }
}

__device__ __forceinline__ float bn_relu(float a, float mn, float ml, float bs) {
  using fav::rt;
  float v = rt<__nv_bfloat16>(a);
  v = rt<__nv_bfloat16>(__fsub_rn(v, rt<__nv_bfloat16>(mn)));
  v = rt<__nv_bfloat16>(__fmul_rn(v, rt<__nv_bfloat16>(ml)));
  v = rt<__nv_bfloat16>(__fadd_rn(v, rt<__nv_bfloat16>(bs)));
  return fav::fmax_nan(v, 0.f);  // relu keeps a NaN
}

// BN + relu of one warp's 16 positions x 64 channels and the store of output
// row `yrow` in 16-byte vectors.  In the m16n8 accumulator layout lane
// (g, c) = (lane / 4, lane % 4) holds rows g and g+8, channels 8q+2c and
// 8q+2c+1 of each tile q; the four lanes of a quad swap pairs (three
// shuffles a group of four tiles) until each holds one whole 8-channel tile.
__device__ __forceinline__ uint32_t pick4(const uint32_t* v, int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

__device__ __forceinline__ void store_row(const float (&acc)[32], __nv_bfloat16* yrow, int w0,
                                          int lane, int W, const float* __restrict__ mean,
                                          const float* __restrict__ mul,
                                          const float* __restrict__ bias) {
  const int g = lane >> 2, c = lane & 3;
  uint32_t p[2][8];  // [row g, g+8][tile]: this lane's bf16 pair
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int co = 8 * q + 2 * c;
    const float m0 = __ldg(mean + co), m1 = __ldg(mean + co + 1);
    const float l0 = __ldg(mul + co), l1 = __ldg(mul + co + 1);
    const float b0 = __ldg(bias + co), b1 = __ldg(bias + co + 1);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(bn_relu(acc[4 * q + 2 * half], m0, l0, b0),
                                                      bn_relu(acc[4 * q + 2 * half + 1], m1, l1, b1));
      p[half][q] = *reinterpret_cast<const uint32_t*>(&v);
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int w = w0 + g + 8 * half;
#pragma unroll
    for (int grp = 0; grp < 2; ++grp) {
      uint32_t o[4] = {0, 0, 0, 0};
#pragma unroll
      for (int sft = 0; sft < 4; ++sft) {
        // lane c ^ sft needs this lane's pair of its tile 4grp + (c ^ sft)
        const uint32_t send = pick4(&p[half][4 * grp], c ^ sft);
        const uint32_t got = sft ? __shfl_xor_sync(0xffffffffu, send, sft) : send;
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = j == (c ^ sft) ? got : o[j];
      }
      if (w < W)
        *reinterpret_cast<uint4*>(yrow + int64_t(w) * COUT + 8 * (4 * grp + c)) =
            make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

__global__ void __launch_bounds__(THREADS_BF16, 1)
stem_conv_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ k,
                      const float* __restrict__ mean, const float* __restrict__ mul,
                      const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, int B,
                      int T_, int H, int W) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* wsm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = wsm + W_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + RING * SLOT_BYTES);  // full, then empty
  const uint32_t zero_u32 = smem_u32(bars + 2 * RING);
  const int tid = threadIdx.x;

  // the weight, once per block: [k][co] -> K-major swizzled, 8 k a 16-byte chunk
  const unsigned short* kb = reinterpret_cast<const unsigned short*>(k);
  for (int c = tid; c < KTOT / 8 * COUT; c += THREADS_BF16) {
    const int n = c % COUT, k0 = c / COUT * 8;
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = uint32_t(kb[(k0 + 2 * i) * COUT + n]) | (uint32_t(kb[(k0 + 2 * i + 1) * COUT + n]) << 16);
    *reinterpret_cast<uint4*>(wsm + wsw(n, k0)) = make_uint4(v[0], v[1], v[2], v[3]);
  }
  // zero row buffers (the pads, position 0 and W+1.., are never written
  // again) and the zero bytes after the barriers
  if (tid == 0) *reinterpret_cast<uint4*>(bars + 2 * RING) = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < RING * SLOT_BYTES / 16; i += THREADS_BF16)
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(smem_u32(bars + s), 1);
      mbar_init(smem_u32(bars + RING + s), CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  const int n_hp = (H + 1) / 2;
  const int64_t n_items = int64_t(B) * T_ * n_hp;
  const uint32_t ring_u32 = smem_u32(ring);

  if (tid >= CONSUMERS) {  // producer: one lane streams the input rows
    if (tid != CONSUMERS) return;
    const uint32_t bytes = uint32_t(W) * CIN * 2;
    int s = 0;
    uint32_t phase = 1;  // a fresh buffer counts as released
    for (int64_t item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int h0 = int(item % n_hp) * 2;
      const int t = int(item / n_hp % T_);
      const int64_t b = item / (int64_t(n_hp) * T_);
      for (int m = 0; m < KT; ++m) {
        const int ti = t + m - 1;
        if (ti < 0 || ti >= T_) continue;
        for (int r = 0; r < KH + 1; ++r) {
          const int hi = h0 + r - 1;
          if (hi < 0 || hi >= H) continue;
          mbar_wait(smem_u32(bars + RING + s), phase);
          mbar_expect_tx(smem_u32(bars + s), bytes);
          bulk_load(ring_u32 + s * SLOT_BYTES + CIN * 2,
                    x + ((b * T_ + ti) * H + hi) * int64_t(W) * CIN, bytes, smem_u32(bars + s));
          if (++s == RING) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  const int lane = tid % 32;
  const int w0 = (tid / 128) * 64 + (tid / 32 % 4) * 16;  // this warp's 16 positions
  const uint32_t a_off = (w0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * (CIN * 2) + 16 * (lane >> 4);
  const uint32_t wbase = smem_u32(wsm);
  int s = 0;
  uint32_t phase = 0;
  for (int64_t item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int h0 = int(item % n_hp) * 2;
    const int t = int(item / n_hp % T_);
    const int64_t b = item / (int64_t(n_hp) * T_);
    float acc0[32], acc1[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
    fence_acc(acc0);
    fence_acc(acc1);
    // The 20 (frame m, row r) inputs in a fixed order, unrolled so that no
    // wgmma, and no write of its A registers, sits on a divergent path.
    uint32_t a[KSTEPS][4];
#pragma unroll
    for (int m = 0; m < KT; ++m) {
#pragma unroll
      for (int r = 0; r < KH + 1; ++r) {
        const int ti = t + m - 1, hi = h0 + r - 1;
        const bool staged = ti >= 0 && ti < T_ && hi >= 0 && hi < H;  // uniform
        if (staged) mbar_wait(smem_u32(bars + s), phase);
        // a row outside the clip reads the 16 zero bytes with every lane
        const uint32_t abase = staged ? ring_u32 + s * SLOT_BYTES + a_off : zero_u32;
        const uint32_t kstep = staged ? 32 : 0;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) ldsm_x4(abase + kstep * kk, a[kk]);
        if (staged) {
          __syncwarp();
          if (lane == 0) mbar_arrive(smem_u32(bars + RING + s));
          if (++s == RING) {
            s = 0;
            phase ^= 1;
          }
        }
        // input row hi is kernel row r of output row h0 and r-1 of h0+1
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
        if (r < KH) slice_wgmma(acc0, a, m * KH + r, wbase);
        if (r >= 1) slice_wgmma(acc1, a, m * KH + r - 1, wbase);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        // the next row's ldmatrix rewrites A: this row's wgmmas must be done
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      }
    }
    fence_acc(acc0);
    fence_acc(acc1);
    if (w0 >= W) continue;
    __nv_bfloat16* yrow = y + ((b * T_ + t) * H + h0) * int64_t(W) * COUT;
    store_row(acc0, yrow, w0, lane, W, mean, mul, bias);
    if (h0 + 1 < H) store_row(acc1, yrow + int64_t(W) * COUT, w0, lane, W, mean, mul, bias);
  }
}

// ---- f32: CUDA cores, only to compare against the plain version -------------
constexpr int NPOS = MAX_W + 8;        // staged input positions per row (>= MAX_W + 3)
constexpr int XROW = NPOS * CIN;       // elements of one staged input row
constexpr int WTAP = KH * KROW * COUT;  // elements of one temporal tap of k
constexpr size_t SMEM_F32 = size_t(WTAP) * 4 + size_t(KH) * XROW * 4;  // 150528 B
constexpr int THREADS_F32 = 256;
constexpr int WPT = MAX_W / (THREADS_F32 / COUT);  // 32 output positions per thread

// Stage temporal tap m of the weight and input rows h-1 .. h+2 of frame ti.
__device__ void stage_tap(float* ws, float* xs, const float* __restrict__ x,
                          const float* __restrict__ k, int b, int ti, int m, int h, int T_, int H,
                          int W) {
  const uint4* src = reinterpret_cast<const uint4*>(k + int64_t(m) * WTAP);
  uint4* dst = reinterpret_cast<uint4*>(ws);
  constexpr int NV = WTAP * 4 / 16;
  for (int i = threadIdx.x; i < NV; i += blockDim.x) dst[i] = src[i];
  // zero-padded rows: xs[j][p][ci] = x[b, ti, h+j-1, p-1, ci], 16-byte vectors
  constexpr int VPP = CIN * 4 / 16;
  constexpr int ROWV = NPOS * VPP;
  uint4* xv = reinterpret_cast<uint4*>(xs);
  for (int i = threadIdx.x; i < KH * ROWV; i += blockDim.x) {
    const int j = i / ROWV, v = i % ROWV;
    const int hi = h + j - 1, wi = v / VPP - 1;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (hi >= 0 && hi < H && wi >= 0 && wi < W) {
      const uint4* row = reinterpret_cast<const uint4*>(
          x + ((int64_t(b) * T_ + ti) * H + hi) * int64_t(W) * CIN);
      val = row[v - VPP];
    }
    xv[i] = val;
  }
}

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
    stage_tap(ws, xs, x, k, b, ti, m, h, T_, H, W);
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
      yrow[int64_t(w) * COUT + co] = fav::fmax_nan(v, 0.f);  // relu keeps a NaN
    }
  }
}

}  // namespace

// The kernels' dynamic shared-memory limits and the card's SM count, set and
// read once, at the first launch (a warm-up before a CUDA graph's capture):
// the launches a capture records make no runtime call but the launch.
struct StemSetup {
  cudaError_t err;
  int sms;
};

static const StemSetup& stem_setup() {
  static const StemSetup setup = [] {
    StemSetup s{cudaSuccess, 0};
    int dev = 0;
    s.err = cudaFuncSetAttribute(stem_conv_bf16_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BF16));
    if (s.err == cudaSuccess)
      s.err = cudaFuncSetAttribute(stem_conv_f32_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_F32));
    if (s.err == cudaSuccess) s.err = cudaGetDevice(&dev);
    if (s.err == cudaSuccess)
      s.err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev);
    return s;
  }();
  return setup;
}

FAV_API int fav_stem_conv_bn_relu(const void* x, const void* k, const void* mean,
                                  const void* mul, const void* bias, void* y, int64_t B,
                                  int64_t T, int64_t H, int64_t W, int dtype, void* stream) {
  if (W > MAX_W || W < 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const StemSetup& setup = stem_setup();
  if (setup.err != cudaSuccess) return int(setup.err);
  if (dtype == fav::kBF16) {
    if (!fav::aligned16(x)) return int(cudaErrorMisalignedAddress);
    const int64_t items = B * T * ((H + 1) / 2);
    const unsigned blocks = unsigned(items < setup.sms ? items : setup.sms);
    stem_conv_bf16_kernel<<<blocks, THREADS_BF16, SMEM_BF16, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(k),
        static_cast<const float*>(mean), static_cast<const float*>(mul),
        static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), int(B), int(T), int(H),
        int(W));
  } else if (dtype == fav::kF32) {
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
