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
// Operands (NHWC): x (B, H, W, C) T, C <= 8; w7 (7, 7, C, F) T, conv0 as
// (ky, kx, in, out); gamma, beta (F) float, the folded norm0; out (B, HQ, WQ,
// F) T with H2 = ceil(H / 2), HQ = ceil(H2 / 2) (the same along W).
//
// The TPU kernel runs conv0 in its space-to-depth form and splits the s2d
// plane by column parity, because a stride-2 gather after the fact has no
// good lowering there (stem_pool.py:17-34). A GPU thread indexes with any
// stride, so this kernel computes the direct form.
//
// One 256-thread block per 4x16 tile of pooled outputs:
//   1. stage the tile's 23x71xC input window into shared memory in f32,
//      zero outside the image: conv0's zero padding, on the input, before BN;
//   2. for 64 output channels at a time, stage those channels' weights
//      (7x7xCx64, f32), compute the tile's 9x33 stem values once each
//      (19 pixels x 4 channels per thread), apply BN + ReLU, and keep them
//      in shared memory, with stem positions outside the stem plane set to
//      0: after ReLU every value is >= 0, so 0 is the identity of the max
//      and a row or column of the pool's padding cannot contribute ReLU(beta);
//   3. take the 3x3/s2 max of each pooled output and store it.
// Shared memory: (23*71*C + 49*C*64 + 297*64) floats = 133 KB at C = 3,
// 229 KB at C = 8, the largest C the plan takes.
//
// What bounds it on an H100: at 1280x1920, C = 3, conv0 is 11.6 GFLOP on
// CUDA cores in f32 against 15 MB read and 20 MB written (bf16), so the FMAs
// bound it; the ring of stem values shared by two tiles is computed twice
// (9x33 per 8x32 new stem pixels, 1.16x).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "dtype.cuh"

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

template <typename T>
int run(const void* x, const void* w7, const float* gamma, const float* beta, void* out,
        int B, int H, int W, int C, int F, cudaStream_t s) {
  const size_t smem = smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      stem_pool_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int HQ = ((H + 1) / 2 + 1) / 2, WQ = ((W + 1) / 2 + 1) / 2;
  const dim3 grid((WQ + kPX - 1) / kPX, (HQ + kPY - 1) / kPY, B);
  stem_pool_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w7), gamma, beta,
      static_cast<T*>(out), H, W, C, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. One launch on `stream`, without
// synchronising. Returns the cudaError_t of the launch (0 on success).
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
      return run<float>(x, w7, g, b, out, B, H, W, C, F, s);
    case 1:
      return run<__nv_bfloat16>(x, w7, g, b, out, B, H, W, C, F, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
