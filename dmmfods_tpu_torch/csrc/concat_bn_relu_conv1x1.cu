// K1: fused concat + folded BatchNorm + ReLU + 1x1 conv, for Hopper (sm_90a).
//
//   out = ReLU(a * gamma_a + beta_a) @ W_a  +  ReLU(b * gamma_b + beta_b) @ W_b
//
// Replaces the Pallas kernel dmmfods_tpu/ops/fused.py::_pallas_fused
// (kernel body _fused_kernel). The channel concat of the two streams is never
// materialised: the K loop runs over a's channels, then over b's.
//
// Operands (all row-major, R = B*H*W pixel rows in NHWC order):
//   a     (R, Ca)        activation dtype T (float or bf16)
//   b     (R, Cb)        T
//   gamma (Ca+Cb,)       float, the folded BN scale  scale * rsqrt(var + eps)
//   beta  (Ca+Cb,)       float, the folded BN shift  bias - mean * gamma
//   w     (Cout, Ca+Cb)  T, the 1x1 conv weight in torch's (O, I) order
//   out   (R, Cout)      T
//
// What bounds it on an H100: at the serving shape (Ca = Cb = Cout = 128,
// R = 384 * batch; 98,304 rows at batch 256) one call moves about 75 MB in
// bf16 and does 6.4 GFLOP, about 85 FLOP per byte. That is below the card's
// bf16 ridge of about 295 FLOP/byte, so a tensor-core version is bound by
// memory, and the fast version (a later change) keeps a and b read exactly
// once and the weight resident on chip. This first version is the simple,
// right one: CUDA-core FMAs in f32, so it is bound by the FMA rate instead.
//
// Design: one 256-thread block per 64x64 output tile. The K loop stages a
// 64x32 chunk of the (virtual) concat into shared memory, applying the BN
// fold and ReLU in f32 on the way in (the prologue), and a 32x64 chunk of W
// beside it. Each thread accumulates a 4x4 sub-tile in f32 registers and
// rounds once on the store. Every edge (R, Ca, Cb, Cout not multiples of the
// tile) is masked, so any shape is taken.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;       // output rows per block
constexpr int kBN = 64;       // output channels per block
constexpr int kBK = 32;       // K chunk staged per step
constexpr int kThreads = 256; // 16 x 16 threads, 4x4 outputs each

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
concat_bn_relu_conv1x1_kernel(const T* __restrict__ a, const T* __restrict__ b,
                              const float* __restrict__ gamma,
                              const float* __restrict__ beta,
                              const T* __restrict__ w, T* __restrict__ out,
                              int64_t rows, int ca, int cb, int cout) {
  // k-major tiles; the +1 pad makes the k-strided stores bank-conflict free
  __shared__ float xs[kBK][kBM + 1];
  __shared__ float ws[kBK][kBN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output channels tx, tx+16, tx+32, tx+48
  const int ty = tid / 16;  // output rows ty, ty+16, ty+32, ty+48
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int k_total = ca + cb;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k_total; k0 += kBK) {
    // prologue: the concat chunk, BN-folded and ReLU'd in f32. Neighbouring
    // threads read neighbouring channels of one pixel row (coalesced).
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int mm = i / kBK;
      const int kk = i % kBK;
      const int64_t r = m0 + mm;
      const int k = k0 + kk;
      float v = 0.f;
      if (r < rows && k < k_total) {
        const float x = k < ca ? to_f32(a[r * ca + k]) : to_f32(b[r * cb + (k - ca)]);
        v = fmaxf(fmaf(x, gamma[k], beta[k]), 0.f);
      }
      xs[kk][mm] = v;
    }
    for (int i = tid; i < kBN * kBK; i += kThreads) {
      const int nn = i / kBK;
      const int kk = i % kBK;
      const int n = n0 + nn;
      const int k = k0 + kk;
      ws[kk][nn] = (n < cout && k < k_total)
                       ? to_f32(w[static_cast<int64_t>(n) * k_total + k])
                       : 0.f;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float xv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = m0 + ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < cout) out[r * cout + n] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
void launch(const void* a, const void* b, const void* gamma, const void* beta,
            const void* w, void* out, int64_t rows, int ca, int cb, int cout,
            cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((rows + kBM - 1) / kBM),
                  static_cast<unsigned>((cout + kBN - 1) / kBN));
  concat_bn_relu_conv1x1_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const T*>(w), static_cast<T*>(out), rows, ca, cb, cout);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch
// (0 on success). Launches on `stream` and does not synchronise.
extern "C" int dmm_concat_bn_relu_conv1x1(const void* a, const void* b,
                                          const void* gamma, const void* beta,
                                          const void* w, void* out, int64_t rows,
                                          int ca, int cb, int cout, int dtype,
                                          void* stream) {
  if (rows <= 0 || ca < 0 || cb < 0 || ca + cb <= 0 || cout <= 0 ||
      (rows + kBM - 1) / kBM > 0x7fffffff || (cout + kBN - 1) / kBN > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch<float>(a, b, gamma, beta, w, out, rows, ca, cb, cout, s);
      break;
    case 1:
      launch<__nv_bfloat16>(a, b, gamma, beta, w, out, rows, ca, cb, cout, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
