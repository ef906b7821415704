// K2: a whole DenseNet dense block at inference, for Hopper (sm_90a).
//
// Replaces the Pallas kernel
// dmmfods_tpu/ops/pallas/dense_block_strip.py::dense_block_strip_carry
// (kernel body _carry_kernel). For each layer l of the block, with BN folded
// into per-channel (gamma, beta) and width = c0 + l * G:
//
//   act = ReLU(buf[..., :width] * g1 + b1)            rounded to T
//   y1  = act @ w1                                    f32 accumulation
//   y2  = ReLU(y1 * g2 + b2), zero outside the image  rounded to T
//   buf[..., width:width + G] = conv3x3(y2, w3)        f32 accumulation
//
// The zero outside the image is the 3x3's zero padding. It has to sit after
// BN2: BN2's bias makes a zeroed pixel non-zero.
//
// Operands (NHWC, P = B*H*W pixels):
//   x    (B, H, W, c0)        T, the block input
//   out  (B, H, W, cmax)      T, cmax = c0 + L * G: the block's output buffer
//   g1, b1 (L, cmax)          float, folded norm1, zero beyond each width
//   w1   (L, cmax, K)         T, conv1 as (in, out)
//   g2, b2 (L, K)             float, folded norm2
//   w3   (L, 3, 3, K, G)      T, conv2 as (ky, kx, in, out)
//
// Why the TPU design does not carry over. The TPU kernel keeps rs + L + 2
// full-width rows of the cmax-wide buffer in 110 MB of VMEM and carries the
// halo from one in-order grid step to the next. A GPU block has at most
// 227 KB of shared memory, and one full-width row of the buffer is already
// 480 px * 256 ch * 2 B = 245,760 B at block 1 of the 1280x1920 frame (and
// the same at block 2); blocks also run in no order. So the block buffer
// lives in device memory, written once per channel slab, and the dense
// layers are L launches in stream order of one fused layer kernel. A layer
// reads the [0, width) prefix and writes the disjoint [width, width + G)
// slab, so no block of a launch reads what another writes.
//
// The layer kernel: one 256-thread block per 8x16 output tile. It
//   1. stages the tile's 10x18 halo of the prefix 32 channels at a time,
//      BN1-folded and ReLU'd on the way into shared memory, beside the
//      matching 32 rows of w1, and accumulates the 1x1 in f32 registers
//      (12 pixels x 8 channels per thread);
//   2. applies BN2 + ReLU + the image mask and keeps y2 for the whole halo
//      in shared memory (180 x 128, in T);
//   3. runs the 3x3 from shared memory, one tap of w3 staged at a time
//      (4 pixels x 4 channels per thread), and stores the G new channels.
// The 1x1 is recomputed on the halo ring (180 / 128 = 1.41x its work).
//
// What bounds it on an H100: at block 1 of the 1280x1920 frame one block
// call does about 116 GFLOP (with the ring) on 153,600 pixels and moves
// about 0.3 GB, far above the bf16 ridge of ~295 FLOP/byte. This first
// version runs its FMAs on CUDA cores in f32, not on the tensor cores, and
// is bound by neither: compiling parts of it out on an H100 (700 W) showed
// the staging into shared memory and the FMAs each take about half of its
// time, one after the other, because one 256-thread block per SM (145
// registers a thread) leaves nothing to run while a block stages. The fast
// version stages asynchronously (cp.async or TMA, double-buffered) and runs
// the products on the tensor cores. Any H, W, c0 and width are taken, with
// every edge masked; K <= 128 and G <= 32 are the shared-memory plan's
// limits and anything larger is refused.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "dtype.cuh"

namespace {

constexpr int kTH = 8;                       // output tile rows
constexpr int kTW = 16;                      // output tile columns
constexpr int kHH = kTH + 2;                 // halo rows
constexpr int kHW = kTW + 2;                 // halo columns
constexpr int kHalo = kHH * kHW;             // 180 halo pixels
constexpr int kNP = 192;                     // halo pixels padded to 16 x 12
constexpr int kNPS = kNP + 1;                // odd stride: conflict-free staging
constexpr int kKMax = 128;                   // bottleneck width K (bn_size * G)
constexpr int kKS = kKMax + 2;               // y2 row stride
constexpr int kGMax = 32;                    // growth rate G
constexpr int kCK = 32;                      // prefix channels staged per step
constexpr int kThreads = 256;

constexpr int kStageFloats =
    (kCK * kNPS + kCK * kKMax) > (kKMax * kGMax) ? (kCK * kNPS + kCK * kKMax)
                                                 : (kKMax * kGMax);

template <typename T>
constexpr size_t smem_bytes() {
  return kStageFloats * sizeof(float) + kHalo * kKS * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
dense_layer_kernel(T* __restrict__ buf, const float* __restrict__ g1,
                   const float* __restrict__ b1, const T* __restrict__ w1,
                   const float* __restrict__ g2, const float* __restrict__ b2,
                   const T* __restrict__ w3, int H, int W, int cmax, int width,
                   int K, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* stage = reinterpret_cast<float*>(smem_raw);
  float* acts = stage;                       // [kCK][kNPS]
  float* w1s = stage + kCK * kNPS;           // [kCK][kKMax]
  float* w3s = stage;                        // [kKMax][kGMax], after the 1x1
  T* y2s = reinterpret_cast<T*>(stage + kStageFloats);  // [kHalo][kKS]

  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * kTH;
  const int x0 = blockIdx.x * kTW;
  T* img = buf + static_cast<int64_t>(blockIdx.z) * H * W * cmax;

  // ---- 1x1 over the halo: pixels tp + 16 i, channels tk + 16 j ----------
  const int tk = tid % 16;
  const int tp = tid / 16;
  float acc[12][8];
#pragma unroll
  for (int i = 0; i < 12; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < width; c0 += kCK) {
    for (int e = tid; e < kNP * kCK; e += kThreads) {
      const int p = e / kCK;
      const int kk = e % kCK;
      const int c = c0 + kk;
      float v = 0.f;
      if (p < kHalo && c < width) {
        const int gy = y0 - 1 + p / kHW;
        const int gx = x0 - 1 + p % kHW;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
          const float xv = to_f32(img[(static_cast<int64_t>(gy) * W + gx) * cmax + c]);
          v = round_to<T>(fmaxf(fmaf(xv, g1[c], b1[c]), 0.f));
        }
      }
      acts[kk * kNPS + p] = v;
    }
    for (int e = tid; e < kCK * kKMax; e += kThreads) {
      const int kk = e / kKMax;
      const int k = e % kKMax;
      const int c = c0 + kk;
      w1s[e] = (c < width && k < K) ? to_f32(w1[static_cast<int64_t>(c) * K + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kCK; ++kk) {
      float av[12], wv[8];
#pragma unroll
      for (int i = 0; i < 12; ++i) av[i] = acts[kk * kNPS + tp + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) wv[j] = w1s[kk * kKMax + tk + 16 * j];
#pragma unroll
      for (int i = 0; i < 12; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // ---- BN2 + ReLU + the image mask -> y2 in shared memory ---------------
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    const int p = tp + 16 * i;
    if (p >= kHalo) continue;
    const int gy = y0 - 1 + p / kHW;
    const int gx = x0 - 1 + p % kHW;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = tk + 16 * j;
      if (k >= K) continue;
      const float v = inside ? fmaxf(fmaf(acc[i][j], g2[k], b2[k]), 0.f) : 0.f;
      y2s[p * kKS + k] = from_f32<T>(v);
    }
  }

  // ---- 3x3 over y2: output pixels tq + 32 i, channels tg + 8 j ---------
  const int tg = tid % 8;
  const int tq = tid / 8;
  int base[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = tq + 32 * i;
    base[i] = (o / kTW) * kHW + (o % kTW);
  }
  float acc2[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc2[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();  // y2s complete (tap 0) / w3s free (later taps)
    const T* w3t = w3 + static_cast<int64_t>(tap) * K * G;
    for (int e = tid; e < kKMax * kGMax; e += kThreads) {
      const int k = e / kGMax;
      const int g = e % kGMax;
      w3s[e] = (k < K && g < G) ? to_f32(w3t[k * G + g]) : 0.f;
    }
    __syncthreads();
    const int shift = (tap / 3) * kHW + (tap % 3);
    for (int k = 0; k < K; ++k) {
      float wv[4], yv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = w3s[k * kGMax + tg + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) yv[i] = to_f32(y2s[(base[i] + shift) * kKS + k]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc2[i][j] = fmaf(yv[i], wv[j], acc2[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = tq + 32 * i;
    const int gy = y0 + o / kTW;
    const int gx = x0 + o % kTW;
    if (gy >= H || gx >= W) continue;
    T* dst = img + (static_cast<int64_t>(gy) * W + gx) * cmax + width;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int g = tg + 8 * j;
      if (g < G) dst[g] = from_f32<T>(acc2[i][j]);
    }
  }
}

template <typename T>
int run_block(const void* x, void* out, const float* g1, const float* b1,
              const void* w1, const float* g2, const float* b2, const void* w3,
              int B, int H, int W, int c0, int L, int G, int K, cudaStream_t s) {
  const int cmax = c0 + L * G;
  const size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      dense_layer_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // the block input into channels [0, c0) of the buffer
  err = cudaMemcpy2DAsync(out, cmax * sizeof(T), x, c0 * sizeof(T), c0 * sizeof(T),
                          static_cast<size_t>(B) * H * W, cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  const T* w1t = static_cast<const T*>(w1);
  const T* w3t = static_cast<const T*>(w3);
  for (int l = 0; l < L; ++l) {
    dense_layer_kernel<T><<<grid, kThreads, smem, s>>>(
        static_cast<T*>(out), g1 + static_cast<int64_t>(l) * cmax,
        b1 + static_cast<int64_t>(l) * cmax, w1t + static_cast<int64_t>(l) * cmax * K,
        g2 + static_cast<int64_t>(l) * K, b2 + static_cast<int64_t>(l) * K,
        w3t + static_cast<int64_t>(l) * 9 * K * G, H, W, cmax, c0 + l * G, K, G);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Runs the whole block: the copy of x into
// the buffer, then one layer launch per layer, all on `stream`, without
// synchronising. Returns the first cudaError_t (0 on success).
extern "C" int dmm_dense_block_strip(const void* x, void* out, const void* g1,
                                     const void* b1, const void* w1, const void* g2,
                                     const void* b2, const void* w3, int B, int H,
                                     int W, int c0, int L, int G, int K, int dtype,
                                     void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || c0 <= 0 || L <= 0 || G <= 0 || G > kGMax ||
      K <= 0 || K > kKMax || B > 65535 || (H + kTH - 1) / kTH > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f_g1 = static_cast<const float*>(g1);
  const float* f_b1 = static_cast<const float*>(b1);
  const float* f_g2 = static_cast<const float*>(g2);
  const float* f_b2 = static_cast<const float*>(b2);
  switch (dtype) {
    case 0:
      return run_block<float>(x, out, f_g1, f_b1, w1, f_g2, f_b2, w3, B, H, W, c0, L,
                              G, K, s);
    case 1:
      return run_block<__nv_bfloat16>(x, out, f_g1, f_b1, w1, f_g2, f_b2, w3, B, H, W,
                                      c0, L, G, K, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
