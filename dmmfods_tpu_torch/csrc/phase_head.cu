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
//   w0p   (2, 2, c_src, 4, cm)      float, refine0 in phase space
//   g1, b1 (cm,)                    float, folded norm1
//   w1    (5, 5, cm, nc)            T, refine1 as (ky, kx, in, out)
//   out   (B, H, W, nc)             T
//
// One 256-thread block per 8x16 output tile. It
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
//
// What bounds it on an H100: at 1280x1920 refine0 in phase space is 4 x 144
// x 64 MACs per pixel, about 181 GFLOP a frame (340 with the ring), against
// about 40 MB read and 15 MB written. This first version runs on CUDA cores
// in f32 and is bound by neither: compiling parts of it out on an H100
// (700 W) showed staging (every block restages all of w0p, 590 KB), the
// refine0 FMAs and refine1 run one after the other, with one 256-thread
// block per SM (160 registers a thread) and nothing to hide a block's
// staging behind. The direct 3x3 form with twice the FMAs took the same
// time. The fast version stages asynchronously and runs refine0 on the
// tensor cores. Any H, W and channel count are taken with masked edges;
// cm <= 64 and nc <= 8 are the shared-memory plan's limits and larger is
// refused.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "dtype.cuh"

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
constexpr int kCMMax = 64;              // refine0 outputs c_mid
constexpr int kHS = kCMMax + 2;         // h row stride
constexpr int kNCMax = 8;               // classes
constexpr int kCK = 16;                 // source channels staged per step
constexpr int kThreads = 256;
constexpr int kOut = kTH * kTW;         // 128 output pixels

constexpr int kStage0 = kCK * kLS + 4 * kCK * 4 * kCMMax;  // source + w0p chunk
constexpr int kStage1 = 25 * kCMMax * kNCMax;              // w1, after refine0
constexpr int kStageFloats = kStage0 > kStage1 ? kStage0 : kStage1;

template <typename T>
constexpr size_t smem_bytes() {
  return (kStageFloats + kOut * kNCMax) * sizeof(float) + kMid * kHS * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
phase_head_kernel(const T* __restrict__ x_lo, const T* __restrict__ raw,
                  const float* __restrict__ g0, const float* __restrict__ b0,
                  const float* __restrict__ w0p, const float* __restrict__ g1,
                  const float* __restrict__ b1, const T* __restrict__ w1,
                  T* __restrict__ out, int H, int W, int c_up, int rc, int cm,
                  int nc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* stage = reinterpret_cast<float*>(smem_raw);
  float* srcs = stage;                          // [kCK][kLS]
  float* w0s = stage + kCK * kLS;               // [4 taps][kCK][4 phases][kCMMax]
  float* w1s = stage;                           // [25][cm][nc], after refine0
  float* part = stage + kStageFloats;           // [kOut][kNCMax]
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
  float acc[15][4];
#pragma unroll
  for (int i = 0; i < 15; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

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
    for (int e = tid; e < 4 * kCK * 4 * kCMMax; e += kThreads) {
      const int n = e % kCMMax;
      const int p = (e / kCMMax) % 4;
      const int kk = (e / (4 * kCMMax)) % kCK;
      const int tap = e / (4 * kCMMax * kCK);
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
        float wv[4], av[15];
        const float* wrow = w0s + ((tap * kCK + kk) * 4 + phase) * kCMMax + tc;
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = wrow[16 * j];
#pragma unroll
        for (int i = 0; i < 15; ++i) av[i] = srcs[kk * kLS + base[i] + shift];
#pragma unroll
        for (int i = 0; i < 15; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
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
    for (int j = 0; j < 4; ++j) {
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

template <typename T>
int run_head(const void* x_lo, const void* raw, const float* g0, const float* b0,
             const float* w0p, const float* g1, const float* b1, const void* w1,
             void* out, int B, int hh, int hw, int c_up, int rc, int cm, int nc,
             cudaStream_t s) {
  const size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      phase_head_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int H = 2 * hh;
  const int W = 2 * hw;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  phase_head_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x_lo), static_cast<const T*>(raw), g0, b0, w0p, g1, b1,
      static_cast<const T*>(w1),
      static_cast<T*>(out), H, W, c_up, rc, cm, nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. One launch on `stream`, no
// synchronisation. Returns the cudaError_t of the launch (0 on success).
extern "C" int dmm_phase_head(const void* x_lo, const void* raw, const void* g0,
                              const void* b0, const void* w0p, const void* g1,
                              const void* b1, const void* w1, void* out, int B,
                              int hh, int hw, int c_up, int rc, int cm, int nc,
                              int dtype, void* stream) {
  if (B <= 0 || B > 65535 || hh <= 0 || hw <= 0 || c_up < 0 || rc < 0 ||
      c_up + rc <= 0 || cm <= 0 || cm > kCMMax || nc <= 0 || nc > kNCMax ||
      (2 * hh + kTH - 1) / kTH > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f_g0 = static_cast<const float*>(g0);
  const float* f_b0 = static_cast<const float*>(b0);
  const float* f_g1 = static_cast<const float*>(g1);
  const float* f_b1 = static_cast<const float*>(b1);
  const float* f_w0p = static_cast<const float*>(w0p);
  switch (dtype) {
    case 0:
      return run_head<float>(x_lo, raw, f_g0, f_b0, f_w0p, f_g1, f_b1, w1, out, B, hh,
                             hw, c_up, rc, cm, nc, s);
    case 1:
      return run_head<__nv_bfloat16>(x_lo, raw, f_g0, f_b0, f_w0p, f_g1, f_b1, w1,
                                     out, B, hh, hw, c_up, rc, cm, nc, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
