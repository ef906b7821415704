// K3: the heat-map head at inference, for Hopper (sm_90a).
//
//   a      = ReLU(cat(up2(x_lo), raw) * g0 + b0)       rounded to T
//   mid    = conv3x3(a, w0)                             f32 accumulation
//   h      = ReLU(mid * g1 + b1), zero outside image    rounded to T
//   logits = conv5x5(h, w1)                             f32 accumulation
//
// Replaces the Pallas kernel dmmfods_tpu/ops/pallas/phase_head.py::
// phase_head_strip (kernel body _kernel, entry phase_space_head_strip). Like
// it, this kernel never writes the upsample, the concat or the mid tensor to
// device memory: it reads x_lo and raw once (plus halos) and writes the
// NHWC logits.
//
// refine0 runs in phase space, as on the TPU: a 3x3 conv over a nearest-2x
// upsample reads only a 2x2 window of low-res cells, with weights that
// depend on the output pixel's phase (u, v) = (y % 2, x % 2). With the raw
// input space-to-depth'd onto the same low-res grid, refine0 of a pixel of
// phase p = 2u + v at low-res cell (i, j) is
//
//   mid = sum_{r,s in {0,1}} src[i - 1 + u + r][j - 1 + v + s] @ w0p[r][s][:, p]
//
// over src = [BN0-ReLU(x_lo) | BN0-ReLU(s2d(raw))] (c_up + 4 rc channels),
// zero outside the low-res image: 4 x (c_up + 4 rc) MACs per output channel
// instead of 9 x (c_up + rc). w0p is dmmfods_tpu/ops/fused.py::
// fold_phase_head_weights's, built by the wrapper in f32. refine1 stays the
// plain 5x5 at full resolution: the card has no relayout cost to avoid, so
// the output is NHWC directly and no depth-to-space is needed.
//
// Operands (NHWC; H = 2 hh, W = 2 hw; c_src = c_up + 4 rc):
//   x_lo  (B, hh, hw, c_up)         T, the decoder output before the upsample
//   raw   (B, H, W, rc)             T, the raw network input (the skip)
//   g0, b0 (c_up + rc,)             float, folded norm0
//   g1, b1 (cm,)                    float, folded norm1
//   out   (B, H, W, nc)             T
// and the weights, for float32
//   w0p   (2, 2, c_src, 4, cm)      float, refine0 in phase space
//   w1    (5, 5, cm, nc)            float, refine1 as (ky, kx, in, out)
// and for bfloat16 packed by ops/phase_head.py::pack_phase_head_weights
//   w0k   (4, 4 cp, CMT)            bf16, w0p as phase p = 2u + v, then
//                                   k = (2r + s) cp + c, then cm padded to
//                                   CMT; cp = c_src rounded up to 16
//   w1k   (25, CMT, 8)              bf16, w1 with cm padded to CMT, nc to 8
// (zeros in every padding), with CMT the layout's padded mid channels (64
// or 96, below).
//
// What bounds it on an H100: at 1280x1920 refine0 in phase space is 4 x 144
// x 64 MACs per pixel, about 181 GFLOP a frame, refine1 25 x 64 x 3 MACs
// (24 GFLOP), against about 40 MB read and 15 MB written: operations, on
// the tensor cores (989 TFLOP/s bf16), ~0.2 ms.
//
// ---- bfloat16: refine0 and refine1 on the tensor cores -------------------
//
// The CUDA-core kernel (below, now float32 only) ran at ~197x that bound:
// every product as an f32 FMA, all of w0p (590 KB in f32) restaged for
// each of 19,200 8x16 tiles a frame (11.3 GB), staging and FMAs one after
// the other at one block per SM, and a 1.875x recomputed mid ring. The
// bf16 kernel (phase_head_mma_kernel):
//   * runs refine0 as one GEMM per phase p on mma.sync m16n8k16 (bf16 in,
//     f32 accumulation) fed by ldmatrix: M = the tile's mid pixels of phase
//     p, N = 64 (cm), K = 4 taps x cp. Its A rows are implicit: the lane's
//     mid pixel's 2x2 low-res window in the source held in shared memory;
//   * takes w0p rounded once to bf16 (folded in f32 first, as before): one
//     extra rounding of 2^-9 relative per weight beside the bf16 source's,
//     inside BOUND_BF16 (the float32 kernel keeps w0p in f32);
//   * streams w0k through a 3-stage cp.async ring of 64-row K-chunks, so a
//     chunk's copy overlaps the products on the one before; each tile reads
//     w0k once (295 KB in bf16; 4,800 16x32 tiles, 1.42 GB a frame, against
//     11.3 GB before);
//   * works on 16x32 output tiles: the mid ring recomputed is 20 x 36 / 16 x
//     32 = 1.41x (1.5x with the M padding to 16 rows), against 1.875x;
//   * stages the low-res source once per tile by cp.async (x_lo 16 bytes at
//     a time; the space-to-depth'd raw input 8 bytes, one 4-channel pixel,
//     at a time, else by plain loads) and applies BN0 + ReLU in place in
//     shared memory before ldmatrix reads it: the ReLU keeps BN0 out of the
//     weights;
//   * runs refine1 as an implicit GEMM too, nc padded to one n8 tile: M =
//     the 512 output pixels, K = 25 taps x 64, A rows from h in shared
//     memory.
// One 256-thread block per tile and per SM. The kernel is a template on its
// shared-memory layout HeadLayout<KCS, CMT, CMP>, picked by shape in the C
// entry (mirrored by ops/phase_head.py::LAYOUTS_BF16):
//   * <192, 64, 64>, DenseNet-121's head (c_src <= 192, cm <= 64): the
//     source, h (all 64 mid channels) and the ring take 222 KB;
//   * <256, 96, 48>, DenseNet-161's (c_src 208, cm 96; any c_src <= 256,
//     cm <= 96): the same tile in two passes over the mid channels. The
//     source stays resident (124 KB at 256 channels); each pass runs
//     refine0 for 48 mid channels from its half of w0k's columns into a
//     48-channel h (79 KB), then adds refine1's partial sums over those
//     channels (K = 25 x 48) to the same accumulators. Each tile still
//     reads w0k once; 224 KB in all.
// A pass's w1k rows are staged into the ring once its refine0 is done.
// nc <= 8; larger shapes are refused.
// What bounds it now (an H100 at 700 W: ~2.3 ms at 1280x1920, ~11x the
// bound, by variants with one part removed): not the MMAs but latency at
// one 8-warp block per SM, in the tile's staging, the ring's per-chunk
// waits and barriers, and refine0's ldmatrix traffic (PERF.md).
//
// ---- float32: the CUDA-core kernel (phase_head_kernel) --------------------
//
// float32 is the check type, and TF32 tensor cores would not meet its
// 1e-4 bound, so it keeps the CUDA-core body. One 256-thread block per 8x16
// output tile. It
//   1. stages the tile's 8x12 low-res source halo 16 channels at a time,
//      BN0 folded and ReLU'd on the way into shared memory (the raw input
//      space-to-depth'd by indexing), beside the matching rows of w0p;
//   2. accumulates refine0 for the 12x20 full-res mid halo (the 5x5 needs 2
//      px on each side) in f32 registers: each 16-thread group takes one
//      phase, so a warp reads one phase's weights, 15 pixels x 4 channels
//      per thread;
//   3. applies BN1 + ReLU + the image mask and keeps h in shared memory;
//   4. runs refine1 from shared memory, two threads per output pixel over
//      the two halves of the mid channels, and stores the logits.
// refine0 on the mid ring is recomputed (240 / 128 = 1.875x its work).
// Compiling parts of it out on an H100 (700 W) showed staging, the refine0
// FMAs and refine1 run one after the other, with one block per SM (160
// registers a thread). Any H, W and channel count are taken with masked
// edges. It is a template on the mid channels it holds, CMMax = 64 or 96
// (refine0 accumulates 4 or 6 channels x 15 pixels a thread; the C entry
// picks the smaller that takes cm); cm <= 96 and nc <= 8 are the
// shared-memory plan's limits and larger is refused.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "dtype.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kTH = 8;                  // output tile rows (even)
constexpr int kTW = 16;                 // output tile columns (even)
constexpr int kMH = kTH + 4;            // mid halo rows (5x5 needs 2 each side)
constexpr int kMW = kTW + 4;
constexpr int kMid = kMH * kMW;         // 240 mid pixels, 60 of each phase
constexpr int kPW = kMW / 2;            // columns of one phase's mid pixels
static_assert(kMid / 4 == 4 * 15, "one phase's mid pixels: 4 thread groups x 15");
constexpr int kLH = kTH / 2 + 4;        // low-res source halo rows
constexpr int kLW = kTW / 2 + 4;
constexpr int kLo = kLH * kLW;          // 96 low-res source cells
constexpr int kLS = kLo + 1;            // odd stride: conflict-free staging
constexpr int kCMMaxWide = 96;          // refine0 outputs c_mid, widest plan
constexpr int kNCMax = 8;               // classes
constexpr int kCK = 16;                 // source channels staged per step
constexpr int kThreads = 256;
constexpr int kOut = kTH * kTW;         // 128 output pixels

// the shared-memory plan of a kernel holding CMMax mid channels
template <int CMMax>
struct F32Plan {
  static constexpr int kHS = CMMax + 2;                            // h row stride
  static constexpr int kStage0 = kCK * kLS + 4 * kCK * 4 * CMMax;  // source + w0p chunk
  static constexpr int kStage1 = 25 * CMMax * kNCMax;              // w1, after refine0
  static constexpr int kStageFloats = kStage0 > kStage1 ? kStage0 : kStage1;
};

template <typename T, int CMMax>
constexpr size_t smem_bytes() {
  using P = F32Plan<CMMax>;
  return (P::kStageFloats + kOut * kNCMax) * sizeof(float) + kMid * P::kHS * sizeof(T);
}

template <typename T, int CMMax>
__global__ void __launch_bounds__(kThreads, 1)
phase_head_kernel(const T* __restrict__ x_lo, const T* __restrict__ raw,
                  const float* __restrict__ g0, const float* __restrict__ b0,
                  const float* __restrict__ w0p, const float* __restrict__ g1,
                  const float* __restrict__ b1, const T* __restrict__ w1,
                  T* __restrict__ out, int H, int W, int c_up, int rc, int cm,
                  int nc) {
  constexpr int kHS = F32Plan<CMMax>::kHS;
  constexpr int kNJ = CMMax / 16;               // mid channels a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* stage = reinterpret_cast<float*>(smem_raw);
  float* srcs = stage;                          // [kCK][kLS]
  float* w0s = stage + kCK * kLS;               // [4 taps][kCK][4 phases][CMMax]
  float* w1s = stage;                           // [25][cm][nc], after refine0
  float* part = stage + F32Plan<CMMax>::kStageFloats;  // [kOut][kNCMax]
  T* hs = reinterpret_cast<T*>(part + kOut * kNCMax);  // [kMid][kHS]

  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * kTH;
  const int x0 = blockIdx.x * kTW;
  const int b = blockIdx.z;
  const int hh = H / 2;
  const int hw = W / 2;
  const int c_src = c_up + 4 * rc;
  const int ly0 = y0 / 2 - 2;                   // low-res origin of the halo
  const int lx0 = x0 / 2 - 2;
  const T* xb = x_lo + static_cast<int64_t>(b) * hh * hw * c_up;
  const T* rb = raw + static_cast<int64_t>(b) * H * W * rc;

  // ---- refine0: group tp takes phase p = tp / 4; its pixels q = tp % 4 +
  // 4 i of that phase, at mid (2 qy + u, 2 qx + v); channels tc + 16 j ----
  const int tc = tid % 16;
  const int tp = tid / 16;
  const int phase = tp / 4;
  const int u = phase / 2;
  const int v = phase % 2;
  int base[15];   // low-res window origin of each pixel in the staged halo
  int mid[15];    // its mid-halo index
#pragma unroll
  for (int i = 0; i < 15; ++i) {
    const int q = tp % 4 + 4 * i;
    const int qy = q / kPW;
    const int qx = q % kPW;
    base[i] = (qy + u) * kLW + (qx + v);
    mid[i] = (2 * qy + u) * kMW + (2 * qx + v);
  }
  float acc[15][kNJ];
#pragma unroll
  for (int i = 0; i < 15; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < c_src; c0 += kCK) {
    for (int e = tid; e < kLo * kCK; e += kThreads) {
      const int cell = e / kCK;
      const int kk = e % kCK;
      const int c = c0 + kk;
      const int gy = ly0 + cell / kLW;
      const int gx = lx0 + cell % kLW;
      float val = 0.f;
      if (c < c_src && gy >= 0 && gy < hh && gx >= 0 && gx < hw) {
        float xv;
        int bn;
        if (c < c_up) {
          xv = to_f32(xb[(static_cast<int64_t>(gy) * hw + gx) * c_up + c]);
          bn = c;
        } else {  // s2d: channel c_up + (2 pu + pv) rc + k <- raw[2 gy + pu][2 gx + pv][k]
          const int ph = (c - c_up) / rc;
          const int k = (c - c_up) - ph * rc;
          xv = to_f32(rb[(static_cast<int64_t>(2 * gy + ph / 2) * W + 2 * gx + ph % 2) * rc + k]);
          bn = c_up + k;
        }
        val = round_to<T>(fmaxf(fmaf(xv, g0[bn], b0[bn]), 0.f));
      }
      srcs[kk * kLS + cell] = val;
    }
    for (int e = tid; e < 4 * kCK * 4 * CMMax; e += kThreads) {
      const int n = e % CMMax;
      const int p = (e / CMMax) % 4;
      const int kk = (e / (4 * CMMax)) % kCK;
      const int tap = e / (4 * CMMax * kCK);
      const int c = c0 + kk;
      w0s[e] = (c < c_src && n < cm)
                   ? w0p[((static_cast<int64_t>(tap) * c_src + c) * 4 + p) * cm + n]
                   : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 4; ++tap) {
      const int shift = (tap / 2) * kLW + (tap % 2);
#pragma unroll 2
      for (int kk = 0; kk < kCK; ++kk) {
        float wv[kNJ], av[15];
        const float* wrow = w0s + ((tap * kCK + kk) * 4 + phase) * CMMax + tc;
#pragma unroll
        for (int j = 0; j < kNJ; ++j) wv[j] = wrow[16 * j];
#pragma unroll
        for (int i = 0; i < 15; ++i) av[i] = srcs[kk * kLS + base[i] + shift];
#pragma unroll
        for (int i = 0; i < 15; ++i)
#pragma unroll
          for (int j = 0; j < kNJ; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // ---- BN1 + ReLU + the image mask -> h in shared memory; stage w1 ------
#pragma unroll
  for (int i = 0; i < 15; ++i) {
    const int m = mid[i];
    const int gy = y0 - 2 + m / kMW;
    const int gx = x0 - 2 + m % kMW;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int n = tc + 16 * j;
      if (n >= cm) continue;
      const float v = inside ? fmaxf(fmaf(acc[i][j], g1[n], b1[n]), 0.f) : 0.f;
      hs[m * kHS + n] = from_f32<T>(v);
    }
  }
  for (int e = tid; e < 25 * cm * nc; e += kThreads) w1s[e] = to_f32(w1[e]);
  __syncthreads();

  // ---- refine1: output pixel o, mid channels half, half + 2, ... --------
  const int o = tid % kOut;
  const int half = tid / kOut;
  const int oy = o / kTW;
  const int ox = o % kTW;
  float sum[kNCMax];
#pragma unroll
  for (int n = 0; n < kNCMax; ++n) sum[n] = 0.f;
  for (int tap = 0; tap < 25; ++tap) {
    const T* hrow = hs + ((oy + tap / 5) * kMW + ox + tap % 5) * kHS;
    const float* wt = w1s + tap * cm * nc;
    for (int c = half; c < cm; c += 2) {
      const float hv = to_f32(hrow[c]);
#pragma unroll
      for (int n = 0; n < kNCMax; ++n)
        if (n < nc) sum[n] = fmaf(hv, wt[c * nc + n], sum[n]);
    }
  }
  if (half == 1) {
#pragma unroll
    for (int n = 0; n < kNCMax; ++n) part[o * kNCMax + n] = sum[n];
  }
  __syncthreads();
  if (half == 0) {
    const int gy = y0 + oy;
    const int gx = x0 + ox;
    if (gy < H && gx < W) {
      T* dst = out + ((static_cast<int64_t>(b) * H + gy) * W + gx) * nc;
#pragma unroll
      for (int n = 0; n < kNCMax; ++n)
        if (n < nc) dst[n] = from_f32<T>(sum[n] + part[o * kNCMax + n]);
    }
  }
}

// ---- bfloat16: the tensor-core kernel ---------------------------------------

using bf16 = __nv_bfloat16;

namespace tc {   // the tensor-core kernel's plan, kernel and launch

constexpr int kTH = 16;                  // output tile rows (even)
constexpr int kTW = 32;                  // output tile columns (even)
constexpr int kPH = kTH / 2 + 2;         // one phase's mid pixels: 10 rows
constexpr int kPW = kTW / 2 + 2;         //   x 18 columns
constexpr int kPM = kPH * kPW;           // 180, as 12 m16 tiles (192 rows)
constexpr int kWarpMT = 3;               // m16 tiles per warp (4 warps over M)
static_assert(4 * kWarpMT * 16 >= kPM, "the warps cover a phase's mid pixels");
constexpr int kLW = kTW / 2 + 4;         // low-res source halo: 12 x 20 cells
constexpr int kCells = (kTH / 2 + 4) * kLW;
constexpr int kMW = kTW + 4;             // h: 20 x 36 mid pixels
constexpr int kMid = (kTH + 4) * kMW;
constexpr int kKC = 64;                  // w0k rows per ring chunk
constexpr int kStages = 3;
constexpr int kThreads = 256;

// The shared-memory layout: KCS source channels at most (c_src rounded up to
// 16), CMT mid channels padded (w0k's columns, w1k's rows), CMP of them a
// pass. Two warps split a pass's channels over N.
template <int KCS, int CMT, int CMP>
struct HeadLayout {
  static constexpr int kPasses = CMT / CMP;
  static constexpr int kNT = CMP / 16;           // n8 tiles a warp
  static constexpr int kHS = CMP + 8;            // h row stride: conflict-free ldmatrix
  static constexpr int kWS = CMP + 8;            // ring row stride
  static constexpr size_t kSrcBytes = size_t(kCells) * (KCS + 8) * sizeof(bf16);
  static constexpr size_t kHBytes = size_t(kMid) * kHS * sizeof(bf16);
  static constexpr size_t kRingBytes = size_t(kStages) * kKC * kWS * sizeof(bf16);
  static constexpr size_t kSmem = kSrcBytes + kHBytes + kRingBytes;
  static_assert(CMT % CMP == 0 && CMP % 16 == 0, "whole passes of k16 steps");
  static_assert(KCS % 16 == 0 && KCS <= 256, "the BN0 pass: 8 channels a lane");
  static_assert(kSmem <= 232448, "one block per SM");
  static_assert(25 * CMP * 8 * sizeof(bf16) <= kRingBytes, "a pass's w1k fits in the ring");
};

// One 16x32 output tile per block (see the note at the top): the source
// staged once with BN0 + ReLU; per pass, refine0 phase by phase through the
// w0k ring into h, then refine1 from h into the accumulators.
template <int KCS, int CMT, int CMP>
__global__ void __launch_bounds__(kThreads, 1)
phase_head_mma_kernel(const bf16* __restrict__ x_lo, const bf16* __restrict__ raw,
                      const float* __restrict__ g0, const float* __restrict__ b0,
                      const bf16* __restrict__ w0k, const float* __restrict__ g1,
                      const float* __restrict__ b1, const bf16* __restrict__ w1k,
                      bf16* __restrict__ out, int H, int W, int c_up, int rc, int cm,
                      int nc) {
  using L = HeadLayout<KCS, CMT, CMP>;
  constexpr int kHS = L::kHS;
  constexpr int kWS = L::kWS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* src = reinterpret_cast<bf16*>(smem_raw);                        // [kCells][ss]
  bf16* hs = reinterpret_cast<bf16*>(smem_raw + L::kSrcBytes);          // [kMid][kHS]
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + L::kSrcBytes + L::kHBytes);
  bf16* w1s = ring;                       // [25][CMP][8], a pass's, after its refine0

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int y0 = blockIdx.y * kTH;
  const int x0 = blockIdx.x * kTW;
  const int b = blockIdx.z;
  const int hh = H / 2;
  const int hw = W / 2;
  const int c_src = c_up + 4 * rc;
  const int cp = (c_src + 15) & ~15;      // K of one tap
  const int ss = cp + 8;                  // source row stride: conflict-free ldmatrix
  const int nkc = cp / 16;                // ring chunks per phase: 4 cp / kKC
  const int nchunks = 4 * nkc;
  const int ly0 = y0 / 2 - 2;             // low-res origin of the source halo
  const int lx0 = x0 / 2 - 2;
  const bf16* xb = x_lo + static_cast<int64_t>(b) * hh * hw * c_up;
  const bf16* rb = raw + static_cast<int64_t>(b) * H * W * rc;

  // ---- stage: x_lo's cells by cp.async, then w0k's first two chunks --------
  const bool vec = (c_up & 7) == 0 && (reinterpret_cast<uintptr_t>(x_lo) & 15) == 0;
  if (vec) {
    const int nv = c_up / 8;
    for (int e = tid; e < kCells * nv; e += kThreads) {
      const int cell = e / nv;
      const int v = e - cell * nv;
      const int gy = ly0 + cell / kLW;
      const int gx = lx0 + cell % kLW;
      const bool in = gy >= 0 && gy < hh && gx >= 0 && gx < hw;
      const bf16* g = in ? xb + (static_cast<int64_t>(gy) * hw + gx) * c_up + v * 8 : xb;
      cp_async16(src + cell * ss + v * 8, g, in);
    }
  }
  // the raw input's four pixels of each cell, one 8-byte copy each, where a
  // pixel is 4 bf16 channels (the network's RGB + LiDAR) at channels c_up +
  // 4 ph; else the BN0 pass below reads them from global memory
  const bool raw_vec = rc == 4 && (c_up & 3) == 0 && (reinterpret_cast<uintptr_t>(raw) & 7) == 0;
  if (raw_vec) {
    for (int e = tid; e < kCells * 4; e += kThreads) {
      const int cell = e >> 2;
      const int ph = e & 3;
      const int gy = ly0 + cell / kLW;
      const int gx = lx0 + cell % kLW;
      const bool in = gy >= 0 && gy < hh && gx >= 0 && gx < hw;
      const bf16* g =
          in ? rb + (static_cast<int64_t>(2 * gy + (ph >> 1)) * W + 2 * gx + (ph & 1)) * 4 : rb;
      cp_async8(src + cell * ss + c_up + 4 * ph, g, in);
    }
  }
  cp_async_commit();
  // w0k rows [kc kKC, +kKC) of phase p, the pass's CMP columns
  auto load_chunk = [&](int pass, int j) {
    constexpr int kPieces = CMP / 8;
    const int p = j / nkc;
    const int kc = j - p * nkc;
    const bf16* g = w0k + (static_cast<int64_t>(p) * 4 * cp + kc * kKC) * CMT + pass * CMP;
    bf16* d = ring + (j % kStages) * kKC * kWS;
    for (int e = tid; e < kKC * kPieces; e += kThreads) {
      const int r = e / kPieces;
      const int v = e - r * kPieces;
      cp_async16(d + r * kWS + v * 8, g + r * CMT + v * 8, true);
    }
  };
  load_chunk(0, 0);
  cp_async_commit();
  load_chunk(0, 1);
  cp_async_commit();
  cp_async_wait<2>();                     // the source has landed
  __syncthreads();

  // ---- BN0 + ReLU in place: warp w takes cells w, w + 8, ..., lane v the
  // channels [8 v, 8 v + 8) of each (cp <= 256: 32 lanes at most), with its
  // channels' BN0 constants and raw offsets in registers; zero outside the
  // image and in the padding ---------------------------------------------------
  if (lane < cp / 8) {
    const int c = lane * 8;
    float g[8], bb[8];
    int roff[8];    // s2d channel c_up + (2 pu + pv) rc + k: raw[2 gy + pu][2 gx + pv][k]
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int cc = c + i;
      const int ph = cc < c_src && cc >= c_up ? (cc - c_up) / rc : 0;
      const int k = cc - c_up - ph * rc;
      const int bn = cc < c_up ? cc : c_up + k;
      g[i] = cc < c_src ? g0[bn] : 0.f;
      bb[i] = cc < c_src ? b0[bn] : 0.f;
      roff[i] = ((ph >> 1) * W + (ph & 1)) * rc + k;
    }
    // every channel of the lane staged by cp.async (or padding, zeroed below)
    const bool from_smem = (c >= c_up || vec) && (c + 8 <= c_up || raw_vec);
    for (int cell = warp; cell < kCells; cell += kThreads / 32) {
      const int gy = ly0 + cell / kLW;
      const int gx = lx0 + cell % kLW;
      bf16* d = src + cell * ss + c;
      uint4 o = make_uint4(0, 0, 0, 0);
      if (gy >= 0 && gy < hh && gx >= 0 && gx < hw) {
        float xv[8];
        if (from_smem) {
          uint4 in = *reinterpret_cast<const uint4*>(d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(pairs(in)[i]);
            xv[2 * i] = c + 2 * i < c_src ? f.x : 0.f;           // padding: not staged
            xv[2 * i + 1] = c + 2 * i + 1 < c_src ? f.y : 0.f;
          }
        } else {
          const bf16* xc = xb + (static_cast<int64_t>(gy) * hw + gx) * c_up;
          const bf16* rc0 = rb + (static_cast<int64_t>(2 * gy) * W + 2 * gx) * rc;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int cc = c + i;
            xv[i] = cc < c_up ? to_f32(xc[cc]) : (cc < c_src ? to_f32(rc0[roff[i]]) : 0.f);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pairs(o)[i] = __floats2bfloat162_rn(fmaxf(fmaf(xv[2 * i], g[2 * i], bb[2 * i]), 0.f),
                                              fmaxf(fmaf(xv[2 * i + 1], g[2 * i + 1],
                                                         bb[2 * i + 1]), 0.f));
      }
      *reinterpret_cast<uint4*>(d) = o;
    }
  }

  // refine1's accumulators, summed over the passes: warp w -> output pixels
  // [64 w, 64 w + 64), all classes
  const int arow = lane & 15;             // the lane's ldmatrix row
  const int acol = (lane >> 4) * 8;       // and column
  float acc1[4][4];
  int hpix[4];                            // the lane's A row: its pixel in h
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = (warp * 4 + i) * 16 + arow;
    hpix[i] = (o / kTW) * kMW + o % kTW;
#pragma unroll
    for (int r = 0; r < 4; ++r) acc1[i][r] = 0.f;
  }

  for (int pass = 0; pass < L::kPasses; ++pass) {
    if (pass > 0) {                       // the ring is free: the last pass synced
      load_chunk(pass, 0);
      cp_async_commit();
      load_chunk(pass, 1);
      cp_async_commit();
    }
    // ---- refine0: phase by phase, warp (wm, wn) -> m16 tiles 3 wm + i, the
    // pass's mid channels CMP / 2 wn + [0, CMP / 2) ---------------------------
    const int wm = warp & 3;
    const int wn = warp >> 2;
    float acc[kWarpMT][L::kNT][4];
    int cell0[kWarpMT];                   // the lane's A row: its window's first cell
    for (int j = 0; j < nchunks; ++j) {
      const int p = j / nkc;
      const int kc = j - p * nkc;
      if (kc == 0) {
#pragma unroll
        for (int i = 0; i < kWarpMT; ++i) {
          int q = (wm * kWarpMT + i) * 16 + arow;
          q = q < kPM ? q : 0;            // a padding row reads any cell
          cell0[i] = (q / kPW + (p >> 1)) * kLW + q % kPW + (p & 1);
#pragma unroll
          for (int t = 0; t < L::kNT; ++t)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][t][r] = 0.f;
        }
      }
      cp_async_wait<1>();                 // chunk j has landed
      __syncthreads();                    // for every thread; chunk j - 1's slot is free
      if (j + 2 < nchunks) load_chunk(pass, j + 2);
      cp_async_commit();
      const bf16* wb = ring + (j % kStages) * kKC * kWS + wn * (CMP / 2);
#pragma unroll
      for (int ks = 0; ks < kKC / 16; ++ks) {
        const int k = kc * kKC + ks * 16; // K = (tap, channel); cp % 16 == 0
        const int tap = k / cp;
        const int c = k - tap * cp;
        const int toff = (tap >> 1) * kLW + (tap & 1);
        uint32_t a[kWarpMT][4];
#pragma unroll
        for (int i = 0; i < kWarpMT; ++i) ldsm_x4(a[i], src + (cell0[i] + toff) * ss + c + acol);
#pragma unroll
        for (int np = 0; np < L::kNT / 2; ++np) {
          uint32_t bw[4];
          ldsm_x4_trans(bw, wb + (ks * 16 + arow) * kWS + np * 16 + acol);
#pragma unroll
          for (int i = 0; i < kWarpMT; ++i) {
            mma_bf16(acc[i][2 * np], a[i], bw[0], bw[1]);
            mma_bf16(acc[i][2 * np + 1], a[i], bw[2], bw[3]);
          }
        }
        if (L::kNT % 2) {                 // an odd last n8 tile
          uint32_t bw[2];
          ldsm_x2_trans(bw, wb + (ks * 16 + arow) * kWS + (L::kNT - 1) * 8);
#pragma unroll
          for (int i = 0; i < kWarpMT; ++i) mma_bf16(acc[i][L::kNT - 1], a[i], bw[0], bw[1]);
        }
      }
      if (kc == nkc - 1) {                // BN1 + ReLU + the image mask -> h
#pragma unroll
        for (int i = 0; i < kWarpMT; ++i)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int q = (wm * kWarpMT + i) * 16 + (lane >> 2) + 8 * hf;
            if (q >= kPM) continue;
            const int my = 2 * (q / kPW) + (p >> 1);
            const int mx = 2 * (q % kPW) + (p & 1);
            const int gy = y0 - 2 + my;
            const int gx = x0 - 2 + mx;
            const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
            bf16* hrow = hs + (my * kMW + mx) * kHS;
#pragma unroll
            for (int t = 0; t < L::kNT; ++t) {
              const int n = wn * (CMP / 2) + t * 8 + 2 * (lane & 3);   // in the pass
              const int ng = pass * CMP + n;
              const float v0 = (inside && ng < cm)
                  ? fmaxf(fmaf(acc[i][t][2 * hf], g1[ng], b1[ng]), 0.f) : 0.f;
              const float v1 = (inside && ng + 1 < cm)
                  ? fmaxf(fmaf(acc[i][t][2 * hf + 1], g1[ng + 1], b1[ng + 1]), 0.f) : 0.f;
              *reinterpret_cast<__nv_bfloat162*>(hrow + n) = __floats2bfloat162_rn(v0, v1);
            }
          }
      }
    }
    __syncthreads();                      // h complete; the ring free

    for (int e = tid; e < 25 * CMP; e += kThreads) {
      const int tap = e / CMP;
      const int r = e - tap * CMP;
      cp_async16(w1s + e * 8, w1k + (static_cast<int64_t>(tap) * CMT + pass * CMP + r) * 8,
                 true);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // ---- refine1: the pass's mid channels, K = 25 taps x CMP -------------
    for (int tap = 0; tap < 25; ++tap) {
      const int toff = (tap / 5) * kMW + tap % 5;
#pragma unroll
      for (int ks = 0; ks < CMP / 16; ++ks) {
        uint32_t bw[2];
        ldsm_x2_trans(bw, w1s + (tap * CMP + ks * 16 + arow) * 8);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t a[4];
          ldsm_x4(a, hs + (hpix[i] + toff) * kHS + ks * 16 + acol);
          mma_bf16(acc1[i], a, bw[0], bw[1]);
        }
      }
    }
    __syncthreads();                      // h and the ring free for the next pass
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int o = (warp * 4 + i) * 16 + (lane >> 2) + 8 * hf;
      const int gy = y0 + o / kTW;
      const int gx = x0 + o % kTW;
      const int n = 2 * (lane & 3);
      if (gy >= H || gx >= W || n >= nc) continue;
      bf16* dst = out + ((static_cast<int64_t>(b) * H + gy) * W + gx) * nc;
      dst[n] = __float2bfloat16(acc1[i][2 * hf]);
      if (n + 1 < nc) dst[n + 1] = __float2bfloat16(acc1[i][2 * hf + 1]);
    }
}

template <int KCS, int CMT, int CMP>
int run_head_bf16(const void* x_lo, const void* raw, const float* g0, const float* b0,
                  const void* w0k, const float* g1, const float* b1, const void* w1k,
                  void* out, int B, int hh, int hw, int c_up, int rc, int cm, int nc,
                  cudaStream_t s) {
  constexpr size_t kSmem = HeadLayout<KCS, CMT, CMP>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      phase_head_mma_kernel<KCS, CMT, CMP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int H = 2 * hh;
  const int W = 2 * hw;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  phase_head_mma_kernel<KCS, CMT, CMP><<<grid, kThreads, kSmem, s>>>(
      static_cast<const bf16*>(x_lo), static_cast<const bf16*>(raw), g0, b0,
      static_cast<const bf16*>(w0k), g1, b1, static_cast<const bf16*>(w1k),
      static_cast<bf16*>(out), H, W, c_up, rc, cm, nc);
  return static_cast<int>(cudaGetLastError());
}

// The layout of a head (ops/phase_head.py::bf16_layout): 0 = <192, 64, 64>,
// 1 = <256, 96, 48>, -1 = none takes it.
int layout_of(int c_src, int cm) {
  const int cp = (c_src + 15) & ~15;
  if (cp <= 192 && cm <= 64) return 0;
  if (cp <= 256 && cm <= 96) return 1;
  return -1;
}

}  // namespace tc

template <int CMMax>
int run_head_f32(const void* x_lo, const void* raw, const float* g0, const float* b0,
                 const float* w0p, const float* g1, const float* b1, const void* w1,
                 void* out, int B, int hh, int hw, int c_up, int rc, int cm, int nc,
                 cudaStream_t s) {
  const size_t smem = smem_bytes<float, CMMax>();
  cudaError_t err = cudaFuncSetAttribute(
      phase_head_kernel<float, CMMax>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int H = 2 * hh;
  const int W = 2 * hw;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  phase_head_kernel<float, CMMax><<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(x_lo), static_cast<const float*>(raw), g0, b0, w0p, g1,
      b1, static_cast<const float*>(w1), static_cast<float*>(out), H, W, c_up, rc, cm,
      nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, with w0 = w0p and w1 as (5, 5, cm, nc) float; 1 =
// bfloat16, with w0 = w0k and w1 = w1k as packed (see the top). One launch
// on `stream`, no synchronisation. Returns the cudaError_t of the launch (0
// on success).
extern "C" int dmm_phase_head(const void* x_lo, const void* raw, const void* g0,
                              const void* b0, const void* w0, const void* g1,
                              const void* b1, const void* w1, void* out, int B,
                              int hh, int hw, int c_up, int rc, int cm, int nc,
                              int dtype, void* stream) {
  if (B <= 0 || B > 65535 || hh <= 0 || hw <= 0 || c_up < 0 || rc < 0 ||
      c_up + rc <= 0 || cm <= 0 || cm > kCMMaxWide || nc <= 0 || nc > kNCMax ||
      (2 * hh + kTH - 1) / kTH > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f_g0 = static_cast<const float*>(g0);
  const float* f_b0 = static_cast<const float*>(b0);
  const float* f_g1 = static_cast<const float*>(g1);
  const float* f_b1 = static_cast<const float*>(b1);
  const float* f_w0 = static_cast<const float*>(w0);
  switch (dtype) {
    case 0:
      return cm <= 64 ? run_head_f32<64>(x_lo, raw, f_g0, f_b0, f_w0, f_g1, f_b1, w1, out, B,
                                         hh, hw, c_up, rc, cm, nc, s)
                      : run_head_f32<96>(x_lo, raw, f_g0, f_b0, f_w0, f_g1, f_b1, w1, out, B,
                                         hh, hw, c_up, rc, cm, nc, s);
    case 1:
      switch (tc::layout_of(c_up + 4 * rc, cm)) {
        case 0:
          return tc::run_head_bf16<192, 64, 64>(x_lo, raw, f_g0, f_b0, w0, f_g1, f_b1, w1,
                                                out, B, hh, hw, c_up, rc, cm, nc, s);
        case 1:
          return tc::run_head_bf16<256, 96, 48>(x_lo, raw, f_g0, f_b0, w0, f_g1, f_b1, w1,
                                                out, B, hh, hw, c_up, rc, cm, nc, s);
        default:
          return static_cast<int>(cudaErrorInvalidValue);
      }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 kernel's dynamic shared memory per block for a head of c_src
// source and cm mid channels (its layout's), 0 if no layout takes it.
extern "C" int dmm_phase_head_mma_smem(int c_src, int cm) {
  switch (tc::layout_of(c_src, cm)) {
    case 0: return static_cast<int>(tc::HeadLayout<192, 64, 64>::kSmem);
    case 1: return static_cast<int>(tc::HeadLayout<256, 96, 48>::kSmem);
    default: return 0;
  }
}
