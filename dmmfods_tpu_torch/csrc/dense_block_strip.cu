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
// The layer kernel: one 256-thread block per 8x16 output tile, running
// dense_layer_tile (csrc/dense_layer_tile.cuh, shared with K4): the tile's
// 10x18 halo of the prefix staged 32 channels at a time with BN1 + ReLU and
// the 1x1 into f32 registers, BN2 + ReLU + the image mask into y2 in shared
// memory, then the 3x3 and the store of the G new channels. The 1x1 is
// recomputed on the halo ring (180 / 128 = 1.41x its work).
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

#include "dense_layer_tile.cuh"

namespace {

constexpr int kTH = 8;                       // output tile rows
constexpr int kTW = 16;                      // output tile columns

template <typename T>
__global__ void __launch_bounds__(kLayerThreads, 1)
dense_layer_kernel(T* __restrict__ buf, const float* __restrict__ g1,
                   const float* __restrict__ b1, const T* __restrict__ w1,
                   const float* __restrict__ g2, const float* __restrict__ b2,
                   const T* __restrict__ w3, int H, int W, int cmax, int width,
                   int K, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ImageFrame<T> frame{buf + static_cast<int64_t>(blockIdx.z) * H * W * cmax, H, W,
                            cmax};
  dense_layer_tile<T, kTH, kTW>(smem_raw, frame, width, K, G, blockIdx.y * kTH,
                                blockIdx.x * kTW, g1, b1, w1, g2, b2, w3);
}

template <typename T>
int run_block(const void* x, void* out, const float* g1, const float* b1,
              const void* w1, const float* g2, const float* b2, const void* w3,
              int B, int H, int W, int c0, int L, int G, int K, cudaStream_t s) {
  const int cmax = c0 + L * G;
  const size_t smem = LayerTile<kTH, kTW>::smem_bytes<T>();
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
    dense_layer_kernel<T><<<grid, kLayerThreads, smem, s>>>(
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
