// K6: the DenseNet encoder stem and pool0 in one pass, for Hopper (sm_90a).
//
// Replaces the Pallas kernel dmmfods_tpu/ops/pallas/stem_pool.py::
// stem_pool_strip (kernel body _kernel). It computes
//
//   out = maxpool3x3/s2/p1(ReLU(conv7x7/s2/p3(x) * gamma + beta))
//
// with the conv accumulated in f32 from T inputs and weights, the BN fold,
// ReLU and max in f32, and one rounding to T at the end; the stem plane
// (H/2, W/2, F) never reaches device memory.
//
// Operands (NHWC): x (B, H, W, C) T, C <= 8; gamma, beta (F) float, the
// folded norm0; out (B, HQ, WQ, F) T with H2 = ceil(H / 2), HQ = ceil(H2 / 2)
// (the same along W); and conv0's weight, for float32
//   w7  (7, 7, C, F)        float, as (ky, kx, in, out)
// and for bfloat16 packed by ops/stem_pool.py::pack_stem_weights
//   wk  (K_pad, F_pad)      bf16, row k = (dy * 7 + dx) * C + c, with K_pad =
//                           49 C and F_pad = F rounded up to 16 (zeros in
//                           the padding).
//
// The TPU kernel runs conv0 in its space-to-depth form and splits the s2d
// plane by column parity, because a stride-2 gather after the fact has no
// good lowering there (stem_pool.py:17-34). A GPU thread indexes with any
// stride, so this kernel computes the direct form.
//
// Both bodies work on a 4x16 tile of pooled outputs, whose 3x3/s2 windows
// read a 9x33 tile of stem values (297 pixels: the ring shared with the
// neighbouring tiles is computed twice, 297 / 256 = 1.16x), whose 7x7/s2
// taps read a 23x71xC window of the input. Stem positions outside the stem
// plane are set to 0: after ReLU every value is >= 0, so 0 is the identity
// of the max and a row or column of the pool's padding cannot contribute
// ReLU(beta). What bounds the function on an H100: at 1280x1920, C = 3,
// conv0 is 11.6 GFLOP against 15 MB read and 20 MB written (bf16), so the
// operations, ~0.012 ms on the tensor cores.
//
// ---- bfloat16: conv0 on the tensor cores (stem_pool_mma_kernel) ----------
//
// The CUDA-core body (below, now float32 only) ran at ~80x that bound: every
// product an f32 FMA, one block an SM, and staging, FMAs and pooling one
// after the other. The bf16 kernel runs conv0 as an implicit GEMM on
// mma.sync m16n8k16 (bf16 in, f32 accumulation):
//   * M = the tile's 297 stem pixels padded to 19 m16 tiles (304 rows; the
//     7 padding rows are computed and never used), N = F in passes of 64, K
//     = K_pad (C = 3: 160 = 10 k16 steps);
//   * B, the packed weight, stays resident: K_pad x 64 staged once per block
//     and pass by cp.async (C = 3: 20 KB), read by ldmatrix.trans;
//   * A is an im2col of the tile in shared memory, built from the staged
//     window in K chunks of 32 through two buffers: the warps build chunk
//     j + 1 while they run the MMAs of chunk j, one barrier a chunk. For a
//     fixed dy the 7 C taps (dx, c) of stem pixel sx are the contiguous run
//     at window column 2 sx, so an A row is 7 such runs and its zero pad.
//     The row stride of 40 bf16 (80 bytes) puts ldmatrix's 8 rows on 8
//     different 16-byte bank groups. A whole-K im2col would take 102 KB at
//     C = 3 and 248 KB at C = 8; the chunks take 48 KB at every C;
//   * the window is staged in bf16 by plain loads, 8 in flight a thread
//     (its global rows start at column 4 px0 - 5, not 16-byte aligned at C
//     = 1 or 3), with zeros outside the image: conv0's zero padding, on the
//     input, before BN;
//   * warps: 4 over M (m16 tiles w, w + 4, ...: 5, 5, 5, 4 of them) x 2 over
//     N (32 features each, 4 n8 tiles): one A fragment feeds 4 MMAs, one B
//     fragment pair 5 m16 tiles; 80 accumulators a thread;
//   * epilogue: acc * gamma + beta and ReLU in f32 on the accumulators, 0
//     outside the stem plane, kept in shared memory in bf16 where the im2col
//     buffers were (297 x 72 bf16, 42.8 KB). That is exact: rounding to
//     nearest is monotonic, so the max of the rounded values is the rounded
//     max. Then the 3x3/s2 max, 8 features (16 bytes) at a time, and
//     16-byte stores of the NHWC output where F % 8 == 0.
// Shared memory: 48,640 B of im2col buffers + K_pad x 72 x 2 B of weights +
// 23 x 71 x C x 2 B of window: 81,488 B at C = 3 and 61,760 B at C = 1, so
// two 256-thread blocks an SM (at most 128 registers a thread) for C <= 6;
// 132,368 B at C = 8, one block.
//
// ---- float32: the CUDA-core kernel (stem_pool_kernel) --------------------
//
// float32 is the check type, and TF32 tensor cores would not meet its 1e-4
// bound, so it keeps the CUDA-core body. One 256-thread block per 4x16
// tile:
//   1. stage the tile's 23x71xC input window into shared memory in f32,
//      zero outside the image;
//   2. for 64 output channels at a time, stage those channels' weights
//      (7x7xCx64, f32), compute the tile's 9x33 stem values once each
//      (19 pixels x 4 channels per thread), apply BN + ReLU, and keep them
//      in shared memory, 0 outside the stem plane;
//   3. take the 3x3/s2 max of each pooled output and store it.
// Shared memory: (23*71*C + 49*C*64 + 297*64) floats = 133 KB at C = 3,
// 229 KB at C = 8, the largest C the plan takes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "dtype.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kPY = 4;                       // pooled rows per block
constexpr int kPX = 16;                      // pooled columns per block
constexpr int kSR = 2 * kPY + 1;             // stem rows of the tile
constexpr int kSC = 2 * kPX + 1;             // stem columns
constexpr int kSP = kSR * kSC;               // 297 stem pixels
constexpr int kIR = 2 * kSR + 5;             // input rows of the window
constexpr int kIC = 2 * kSC + 5;             // input columns
constexpr int kFC = 64;                      // output channels per pass
constexpr int kThreads = 256;
constexpr int kSI = (kSP + 15) / 16;         // stem pixels per thread
constexpr int kCMax = 8;

size_t smem_bytes(int C) {
  return (static_cast<size_t>(kIR) * kIC * C + 49 * C * kFC + kSP * kFC) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
stem_pool_kernel(const T* __restrict__ x, const T* __restrict__ w7,
                 const float* __restrict__ gamma, const float* __restrict__ beta,
                 T* __restrict__ out, int H, int W, int C, int F) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                          // [kIR][kIC][C]
  float* ws = xs + kIR * kIC * C;            // [7][7][C][kFC]
  float* st = ws + 49 * C * kFC;             // [kSP][kFC]

  const int tid = threadIdx.x;
  const int H2 = (H + 1) / 2, W2 = (W + 1) / 2;
  const int HQ = (H2 + 1) / 2, WQ = (W2 + 1) / 2;
  const int py0 = blockIdx.y * kPY, px0 = blockIdx.x * kPX;
  const int sy0 = 2 * py0 - 1, sx0 = 2 * px0 - 1;   // stem origin of the tile
  const int iy0 = 2 * sy0 - 3, ix0 = 2 * sx0 - 3;   // input origin
  const T* img = x + static_cast<int64_t>(blockIdx.z) * H * W * C;
  T* dst = out + static_cast<int64_t>(blockIdx.z) * HQ * WQ * F;

  const int row = kIC * C;
  for (int e = tid; e < kIR * row; e += kThreads) {
    const int r = e / row;
    const int q = e - r * row;
    const int gy = iy0 + r;
    const int gx = ix0 + q / C;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      v = to_f32(img[(static_cast<int64_t>(gy) * W + gx) * C + q % C]);
    }
    xs[e] = v;
  }

  const int tf = tid % 16;                   // channels tf + 16 j
  const int tp = tid / 16;                   // stem pixels tp + 16 i
  int base[kSI];
#pragma unroll
  for (int i = 0; i < kSI; ++i) {
    const int s = tp + 16 * i < kSP ? tp + 16 * i : 0;
    base[i] = (2 * (s / kSC) * kIC + 2 * (s % kSC)) * C;
  }

  for (int f0 = 0; f0 < F; f0 += kFC) {
    __syncthreads();  // xs staged (first pass) / ws and st free (later passes)
    for (int e = tid; e < 49 * C * kFC; e += kThreads) {
      const int k = e / kFC;                 // (dy * 7 + dx) * C + c
      const int f = f0 + e % kFC;
      ws[e] = f < F ? to_f32(w7[static_cast<int64_t>(k) * F + f]) : 0.f;
    }
    __syncthreads();

    float acc[kSI][4];
#pragma unroll
    for (int i = 0; i < kSI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int dy = 0; dy < 7; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 7; ++dx) {
        for (int c = 0; c < C; ++c) {
          const int off = (dy * kIC + dx) * C + c;
          const float* wrow = ws + ((dy * 7 + dx) * C + c) * kFC + tf;
          float wv[4], xv[kSI];
#pragma unroll
          for (int j = 0; j < 4; ++j) wv[j] = wrow[16 * j];
#pragma unroll
          for (int i = 0; i < kSI; ++i) xv[i] = xs[base[i] + off];
#pragma unroll
          for (int i = 0; i < kSI; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kSI; ++i) {
      const int s = tp + 16 * i;
      if (s >= kSP) continue;
      const int sy = sy0 + s / kSC;
      const int sx = sx0 + s % kSC;
      const bool inside = sy >= 0 && sy < H2 && sx >= 0 && sx < W2;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = f0 + tf + 16 * j;
        st[s * kFC + tf + 16 * j] =
            inside && f < F ? fmaxf(fmaf(acc[i][j], gamma[f], beta[f]), 0.f) : 0.f;
      }
    }
    __syncthreads();

    for (int e = tid; e < kPY * kPX * kFC; e += kThreads) {
      const int f = e % kFC;
      const int o = e / kFC;
      const int oy = o / kPX, ox = o % kPX;
      const int py = py0 + oy, px = px0 + ox;
      if (py >= HQ || px >= WQ || f0 + f >= F) continue;
      const float* s = st + ((2 * oy) * kSC + 2 * ox) * kFC + f;
      float m = 0.f;
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) m = fmaxf(m, s[(a * kSC + b) * kFC]);
      dst[(static_cast<int64_t>(py) * WQ + px) * F + f0 + f] = from_f32<T>(m);
    }
  }
}

// ---- bfloat16: the tensor-core kernel ---------------------------------------

using bf16 = __nv_bfloat16;

namespace tc {   // the tensor-core kernel's plan, kernel and launch

constexpr int kMTiles = (kSP + 15) / 16;     // 19 m16 tiles of stem pixels
constexpr int kRows = kMTiles * 16;          // 304 im2col rows
constexpr int kKC = 32;                      // im2col K per chunk (2 k16 steps)
constexpr int kAS = kKC + 8;                 // im2col row stride: conflict-free ldmatrix
constexpr int kFN = 64;                      // features per pass (2 warps x 32)
constexpr int kBS = kFN + 8;                 // weight row stride: conflict-free ldmatrix
constexpr int kSS = kFN + 8;                 // stem row stride (16-byte rows, no conflicts)
constexpr int kWarpMT = (kMTiles + 3) / 4;   // m16 tiles per warp: 5
constexpr int kBuildRows = kRows / 16;       // im2col rows a lane builds per chunk: 19
constexpr size_t kABytes = size_t(2) * kRows * kAS * sizeof(bf16);
static_assert(kRows % 16 == 0 && kThreads == 256, "8 warps: 4 over M x 2 over N");
static_assert(size_t(kSP) * kSS * sizeof(bf16) <= kABytes, "the stem tile fits where A was");

template <int C>
constexpr int kKPad = (49 * C + 15) / 16 * 16;   // K_pad: 49 C rounded up to 16

template <int C>
constexpr size_t smem_bytes() {
  return kABytes + size_t(kKPad<C>) * kBS * sizeof(bf16) +
         (size_t(kIR) * kIC * C * sizeof(bf16) + 15) / 16 * 16;
}
static_assert(smem_bytes<kCMax>() <= 232448, "C = 8 fits one block");

// One 4x16 pooled tile per block (see the note at the top): the window
// staged once; per pass of 64 features, the weights staged, conv0 as an
// implicit GEMM over im2col chunks, BN + ReLU into the bf16 stem tile, the
// pool.
template <int C>
__global__ void __launch_bounds__(kThreads, 2)
stem_pool_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wk,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     bf16* __restrict__ out, int H, int W, int F) {
  constexpr int kK = 49 * C;                 // taps (dy, dx, c)
  constexpr int kKP = kKPad<C>;
  constexpr int kRun = 7 * C;                // taps of one dy: a contiguous window run
  constexpr int kRS = kIC * C;               // window row (elements)
  constexpr int kWin = kIR * kRS;
  constexpr int kChunks = (kKP + kKC - 1) / kKC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* abuf = reinterpret_cast<bf16*>(smem_raw);                    // [2][kRows][kAS]
  bf16* st = abuf;                                                   // [kSP][kSS], after the MMAs
  bf16* bs = reinterpret_cast<bf16*>(smem_raw + kABytes);            // [kKP][kBS]
  bf16* win = bs + kKP * kBS;                                        // [kIR][kRS]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int H2 = (H + 1) / 2, W2 = (W + 1) / 2;
  const int HQ = (H2 + 1) / 2, WQ = (W2 + 1) / 2;
  const int py0 = blockIdx.y * kPY, px0 = blockIdx.x * kPX;
  const int sy0 = 2 * py0 - 1, sx0 = 2 * px0 - 1;   // stem origin of the tile
  const int iy0 = 2 * sy0 - 3, ix0 = 2 * sx0 - 3;   // input origin
  const int fpad = (F + 15) & ~15;
  const bf16* img = x + static_cast<int64_t>(blockIdx.z) * H * W * C;
  bf16* dst = out + static_cast<int64_t>(blockIdx.z) * HQ * WQ * F;
  const bf16 zero = __ushort_as_bfloat16(0);

  // ---- the window: each global row is one contiguous run of kRS values ----
  for (int e0 = 0; e0 < kWin; e0 += 8 * kThreads) {
    bf16 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * kThreads + tid;
      const int r = e / kRS;
      const int q = e - r * kRS;
      const int gy = iy0 + r;
      const int gx = ix0 + q / C;
      v[u] = zero;
      if (e < kWin && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v[u] = img[(static_cast<int64_t>(gy) * W + ix0) * C + q];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * kThreads + tid;
      if (e < kWin) win[e] = v[u];
    }
  }

  // ---- im2col chunk j into a: lane & 15 owns the K pair 2 (lane & 15), +1,
  // of rows 2 warp + (lane >> 4) + 16 i; a padding row repeats pixel 296 ----
  auto build = [&](int j, bf16* a) {
    const int t = thread_index();
    const int kk = 2 * (t & 15);
    int off[2];                              // window offsets of the pair's taps
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = j * kKC + kk + h;
      const int dy = k / kRun;
      off[h] = k < kK ? dy * kRS + (k - dy * kRun) : -1;
    }
    const int row0 = 2 * (t >> 5) + ((t >> 4) & 1);
#pragma unroll 4
    for (int i = 0; i < kBuildRows; ++i) {
      const int row = row0 + 16 * i;
      const int m = row < kSP ? row : kSP - 1;
      const bf16* w = win + 2 * (m / kSC) * kRS + 2 * (m % kSC) * C;
      const bf16 lo = off[0] >= 0 ? w[off[0]] : zero;
      const bf16 hi = off[1] >= 0 ? w[off[1]] : zero;
      *reinterpret_cast<__nv_bfloat162*>(a + row * kAS + kk) = __halves2bfloat162(lo, hi);
    }
  };

  const int wm = warp & 3;                   // m16 tiles wm + 4 i
  const int wn = warp >> 2;                  // features 32 wn + [0, 32) of the pass
  const int arow = lane & 15;                // the lane's ldmatrix row
  const int acol = (lane >> 4) * 8;          // and column

  for (int f0 = 0; f0 < F; f0 += kFN) {
    // the pass's weights, columns f0 + [0, 64) that F_pad holds
    const int nv = min(kFN, fpad - f0) / 8;
    for (int e = tid; e < kKP * nv; e += kThreads) {
      const int k = e / nv;
      const int v = e - k * nv;
      cp_async16(bs + k * kBS + 8 * v, wk + static_cast<int64_t>(k) * fpad + f0 + 8 * v, true);
    }
    cp_async_commit();
    __syncthreads();                         // the window staged / the last pass's pool done
    build(0, abuf);
    cp_async_wait<0>();
    __syncthreads();

    const bool n0 = f0 + wn * 32 < fpad;     // the warp's two n16 pairs hold features
    const bool n1 = f0 + wn * 32 + 16 < fpad;
    float acc[kWarpMT][4][4];
#pragma unroll
    for (int i = 0; i < kWarpMT; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][n][r] = 0.f;

    for (int j = 0; j < kChunks; ++j) {
      if (j + 1 < kChunks) build(j + 1, abuf + ((j + 1) & 1) * kRows * kAS);
      const bf16* a = abuf + (j & 1) * kRows * kAS;
#pragma unroll
      for (int ks = 0; ks < kKC / 16; ++ks) {
        const int k = j * kKC + ks * 16;
        if (!n0 || k >= kKP) break;
        uint32_t b0[4], b1[4];
        ldsm_x4_trans(b0, bs + (k + arow) * kBS + wn * 32 + acol);
        if (n1) ldsm_x4_trans(b1, bs + (k + arow) * kBS + wn * 32 + 16 + acol);
#pragma unroll
        for (int i = 0; i < kWarpMT; ++i) {
          const int tile = wm + 4 * i;
          if (tile >= kMTiles) continue;
          uint32_t af[4];
          ldsm_x4(af, a + (tile * 16 + arow) * kAS + ks * 16 + acol);
          mma_bf16(acc[i][0], af, b0[0], b0[1]);
          mma_bf16(acc[i][1], af, b0[2], b0[3]);
          if (n1) {
            mma_bf16(acc[i][2], af, b1[0], b1[1]);
            mma_bf16(acc[i][3], af, b1[2], b1[3]);
          }
        }
      }
      __syncthreads();                       // chunk j + 1 built; chunk j's buffer free
    }

    // ---- BN + ReLU + the stem-plane mask -> the bf16 stem tile ------------
    float g[4][2], b[4][2];                  // the lane's features 32 wn + 8 n + 2 (lane & 3), +1
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int f = f0 + wn * 32 + n * 8 + 2 * (lane & 3) + h;
        g[n][h] = f < F ? gamma[f] : 0.f;
        b[n][h] = f < F ? beta[f] : 0.f;
      }
#pragma unroll
    for (int i = 0; i < kWarpMT; ++i) {
      const int tile = wm + 4 * i;
      if (tile >= kMTiles) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = tile * 16 + (lane >> 2) + 8 * hf;
        if (m >= kSP) continue;
        const int sy = sy0 + m / kSC;
        const int sx = sx0 + m % kSC;
        const bool inside = sy >= 0 && sy < H2 && sx >= 0 && sx < W2;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float v0 = inside ? fmaxf(fmaf(acc[i][n][2 * hf], g[n][0], b[n][0]), 0.f) : 0.f;
          const float v1 =
              inside ? fmaxf(fmaf(acc[i][n][2 * hf + 1], g[n][1], b[n][1]), 0.f) : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(st + m * kSS + wn * 32 + n * 8 + 2 * (lane & 3)) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    __syncthreads();

    // ---- the 3x3/s2 max, 8 features a thread --------------------------------
    const int nf = min(kFN, F - f0);
    const int nvec = (nf + 7) / 8;
    for (int e = tid; e < kPY * kPX * nvec; e += kThreads) {
      const int o = e / nvec;
      const int v = e - o * nvec;
      const int oy = o / kPX, ox = o % kPX;
      const int py = py0 + oy, px = px0 + ox;
      if (py >= HQ || px >= WQ) continue;
      const bf16* s = st + ((2 * oy) * kSC + 2 * ox) * kSS + 8 * v;
      uint4 mx = *reinterpret_cast<const uint4*>(s);
#pragma unroll
      for (int q = 1; q < 9; ++q) {
        uint4 sv = *reinterpret_cast<const uint4*>(s + ((q / 3) * kSC + q % 3) * kSS);
#pragma unroll
        for (int i = 0; i < 4; ++i) pairs(mx)[i] = __hmax2(pairs(mx)[i], pairs(sv)[i]);
      }
      bf16* d = dst + (static_cast<int64_t>(py) * WQ + px) * F + f0 + 8 * v;
      if ((F & 7) == 0) {
        *reinterpret_cast<uint4*>(d) = mx;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (8 * v + 2 * i < nf) d[2 * i] = pairs(mx)[i].x;
          if (8 * v + 2 * i + 1 < nf) d[2 * i + 1] = pairs(mx)[i].y;
        }
      }
    }
  }
}

template <int C>
int run(const void* x, const void* wk, const float* gamma, const float* beta, void* out,
        int B, int H, int W, int F, cudaStream_t s) {
  if (reinterpret_cast<uintptr_t>(wk) & 15) return static_cast<int>(cudaErrorMisalignedAddress);
  constexpr size_t smem = smem_bytes<C>();
  cudaError_t err = cudaFuncSetAttribute(
      stem_pool_mma_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int HQ = ((H + 1) / 2 + 1) / 2, WQ = ((W + 1) / 2 + 1) / 2;
  const dim3 grid((WQ + kPX - 1) / kPX, (HQ + kPY - 1) / kPY, B);
  stem_pool_mma_kernel<C><<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wk), gamma, beta,
      static_cast<bf16*>(out), H, W, F);
  return static_cast<int>(cudaGetLastError());
}

int run_bf16(const void* x, const void* wk, const float* gamma, const float* beta,
             void* out, int B, int H, int W, int C, int F, cudaStream_t s) {
  switch (C) {
    case 1: return run<1>(x, wk, gamma, beta, out, B, H, W, F, s);
    case 2: return run<2>(x, wk, gamma, beta, out, B, H, W, F, s);
    case 3: return run<3>(x, wk, gamma, beta, out, B, H, W, F, s);
    case 4: return run<4>(x, wk, gamma, beta, out, B, H, W, F, s);
    case 5: return run<5>(x, wk, gamma, beta, out, B, H, W, F, s);
    case 6: return run<6>(x, wk, gamma, beta, out, B, H, W, F, s);
    case 7: return run<7>(x, wk, gamma, beta, out, B, H, W, F, s);
    case 8: return run<8>(x, wk, gamma, beta, out, B, H, W, F, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

size_t smem(int C) {
  switch (C) {
    case 1: return smem_bytes<1>();
    case 2: return smem_bytes<2>();
    case 3: return smem_bytes<3>();
    case 4: return smem_bytes<4>();
    case 5: return smem_bytes<5>();
    case 6: return smem_bytes<6>();
    case 7: return smem_bytes<7>();
    case 8: return smem_bytes<8>();
    default: return 0;
  }
}

}  // namespace tc

int run_f32(const void* x, const void* w7, const float* gamma, const float* beta, void* out,
            int B, int H, int W, int C, int F, cudaStream_t s) {
  const size_t smem = smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      stem_pool_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int HQ = ((H + 1) / 2 + 1) / 2, WQ = ((W + 1) / 2 + 1) / 2;
  const dim3 grid((WQ + kPX - 1) / kPX, (HQ + kPY - 1) / kPY, B);
  stem_pool_kernel<float><<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w7), gamma, beta,
      static_cast<float*>(out), H, W, C, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, with w7 as (7, 7, C, F) float; 1 = bfloat16, with w7
// the packed (K_pad, F_pad) weight (see the top), 16-byte aligned. One
// launch on `stream`, without synchronising. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int dmm_stem_pool(const void* x, const void* w7, const void* gamma,
                             const void* beta, void* out, int B, int H, int W, int C,
                             int F, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C > kCMax || F <= 0 || B > 65535 ||
      (((H + 1) / 2 + 1) / 2 + kPY - 1) / kPY > 65535 ||
      static_cast<int64_t>(H) * W * C > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  switch (dtype) {
    case 0:
      return run_f32(x, w7, g, b, out, B, H, W, C, F, s);
    case 1:
      return tc::run_bf16(x, w7, g, b, out, B, H, W, C, F, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 kernel's dynamic shared memory per block for C inputs (0 for a C
// it does not take).
extern "C" int dmm_stem_pool_mma_smem(int C) { return static_cast<int>(tc::smem(C)); }
