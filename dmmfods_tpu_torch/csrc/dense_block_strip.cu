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
//   w1   (L, cmax, K)         float, conv1 as (in, out); bf16 packed, below
//   g2, b2 (L, K)             float, folded norm2
//   w3   (L, 3, 3, K, G)      float, conv2 as (ky, kx, in, out); bf16 packed
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
// The float32 layer kernel (dense_layer_kernel): one 256-thread block per
// 8x16 output tile, running dense_layer_tile (csrc/dense_layer_tile.cuh,
// shared with K4 and K5) on CUDA cores in f32: the tile's 10x18 halo of the
// prefix staged 32 channels at a time with BN1 + ReLU and the 1x1 into f32
// registers, BN2 + ReLU + the image mask into y2 in shared memory, then the
// 3x3 and the store of the G new channels. float32 is the check type, and
// TF32 tensor cores would not meet its 1e-4 bound, so it keeps this body.
//
// The bfloat16 layer kernel (dense_layer_mma_kernel) runs
// dense_layer_mma (csrc/dense_layer_mma.cuh) on the tensor cores, with w1
// and w3 packed by ops/dense_block_strip.py::pack_layer_weights:
//   w1   (L, cp, KP)          bf16, cp = cmax rounded up to 32, K padded
//   w3   (L, 9, KP, GP)       bf16, K and G padded (zeros in the padding),
// (KP, GP) the narrowest layout that holds (K, G): (128, 32) or (192, 48)
// (layer_layout in dense_layer_tile.cuh). Both kernels are templates on the
// layout, and the C entry picks the instantiation by shape.
//
// What bounds it on an H100: at block 1 of the 1280x1920 frame one block
// call does about 102 GFLOP (116 with the ring) on 153,600 pixels and must
// move about 0.1 GB (the input once, the 256-channel buffer once):
// operations, ~0.1 ms at 989 TFLOP/s. The CUDA-core body ran at ~80x that
// in bf16, its f32 FMAs and its staging one after the other at one block
// per SM. The bf16 kernel runs the products on
// mma.sync with cp.async double-buffered staging at two blocks per SM (see
// the header's note), one block per 8x16 tile. At block 2 of the frame
// (160x240) that is 300 tiles a layer, 1.14 waves of the 264 slots of 132
// SMs at two blocks each; 8x8 tiles (600, 2.27 waves, each with its own
// weight staging and a larger ring) measured the same there on an H100 and
// 6-17% slower at block 1, so the kernel has the one tile. It runs ~1 ms a
// block call, 11-17x the bound, bound by latency in its staging and
// barriers more than by its MMAs (the header's note). At (192, 48)
// (DenseNet-161's blocks 1 and 2: 229 / 157 GFLOP, bounds ~0.23 / ~0.16 ms)
// the body holds one block an SM (154 KB of shared memory), 132 slots. Any
// H, W, c0 and width are taken, with every edge masked; K <= 192 and G <=
// 48 are the widest layout's limits and anything larger is refused.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "dense_layer_mma.cuh"
#include "dense_layer_tile.cuh"

namespace {

constexpr int kTH = 8;                       // output tile rows
constexpr int kTW = 16;                      // output tile columns

template <int KMax, int GMax>
__global__ void __launch_bounds__(kLayerThreads, 1)
dense_layer_kernel(float* __restrict__ buf, const float* __restrict__ g1,
                   const float* __restrict__ b1, const float* __restrict__ w1,
                   const float* __restrict__ g2, const float* __restrict__ b2,
                   const float* __restrict__ w3, int H, int W, int cmax, int width,
                   int K, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ImageFrame<float> frame{buf + static_cast<int64_t>(blockIdx.z) * H * W * cmax, H,
                                W, cmax};
  dense_layer_tile<kTH, kTW, KMax, GMax>(smem_raw, frame, width, K, G, blockIdx.y * kTH,
                                         blockIdx.x * kTW, g1, b1, w1, g2, b2, w3);
}

template <int KP, int GP>
using LayerPlan = LayerMma<kTH, kTW, KP, GP>;

template <int KP, int GP>
__global__ void __launch_bounds__(LayerPlan<KP, GP>::kThreads,
                                  LayerPlan<KP, GP>::kBlocksPerSm)
dense_layer_mma_kernel(__nv_bfloat16* buf, const float* __restrict__ g1,
                       const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w1,
                       const float* __restrict__ g2, const float* __restrict__ b2,
                       const __nv_bfloat16* __restrict__ w3, int H, int W, int cmax,
                       int width, int K, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ImageFrame<__nv_bfloat16> frame{
      buf + static_cast<int64_t>(blockIdx.z) * H * W * cmax, H, W, cmax};
  const LayerArgs args{width, K, G, g1, b1, w1, g2, b2, w3};
  dense_layer_mma<kTH, kTW, KP, GP>(smem_raw, frame, args, blockIdx.y * kTH,
                                    blockIdx.x * kTW);
}

// the block input into channels [0, c0) of the buffer
int copy_input(const void* x, void* out, int B, int H, int W, int c0, int cmax,
               size_t elem, cudaStream_t s) {
  return static_cast<int>(cudaMemcpy2DAsync(
      out, cmax * elem, x, c0 * elem, c0 * elem, static_cast<size_t>(B) * H * W,
      cudaMemcpyDeviceToDevice, s));
}

template <int KMax, int GMax>
int run_block_f32(const void* x, void* out, const float* g1, const float* b1,
                  const void* w1, const float* g2, const float* b2, const void* w3,
                  int B, int H, int W, int c0, int L, int G, int K, cudaStream_t s) {
  const int cmax = c0 + L * G;
  const size_t smem = LayerTile<kTH, kTW, KMax, GMax>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      dense_layer_kernel<KMax, GMax>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (int rc = copy_input(x, out, B, H, W, c0, cmax, sizeof(float), s)) return rc;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  const float* w1t = static_cast<const float*>(w1);
  const float* w3t = static_cast<const float*>(w3);
  for (int l = 0; l < L; ++l) {
    dense_layer_kernel<KMax, GMax><<<grid, kLayerThreads, smem, s>>>(
        static_cast<float*>(out), g1 + static_cast<int64_t>(l) * cmax,
        b1 + static_cast<int64_t>(l) * cmax, w1t + static_cast<int64_t>(l) * cmax * K,
        g2 + static_cast<int64_t>(l) * K, b2 + static_cast<int64_t>(l) * K,
        w3t + static_cast<int64_t>(l) * 9 * K * G, H, W, cmax, c0 + l * G, K, G);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <int KP, int GP>
int run_block_bf16(const void* x, void* out, const float* g1, const float* b1,
                   const void* w1, const float* g2, const float* b2, const void* w3,
                   int B, int H, int W, int c0, int L, int G, int K, cudaStream_t s) {
  using P = LayerPlan<KP, GP>;
  const int cmax = c0 + L * G;
  const int cp = (cmax + P::kCK - 1) / P::kCK * P::kCK;   // w1's packed rows
  cudaError_t err = cudaFuncSetAttribute(
      dense_layer_mma_kernel<KP, GP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(P::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (int rc = copy_input(x, out, B, H, W, c0, cmax, sizeof(__nv_bfloat16), s)) return rc;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  const __nv_bfloat16* w1t = static_cast<const __nv_bfloat16*>(w1);
  const __nv_bfloat16* w3t = static_cast<const __nv_bfloat16*>(w3);
  for (int l = 0; l < L; ++l) {
    dense_layer_mma_kernel<KP, GP><<<grid, P::kThreads, P::kSmem, s>>>(
        static_cast<__nv_bfloat16*>(out), g1 + static_cast<int64_t>(l) * cmax,
        b1 + static_cast<int64_t>(l) * cmax, w1t + static_cast<int64_t>(l) * cp * P::kK,
        g2 + static_cast<int64_t>(l) * K, b2 + static_cast<int64_t>(l) * K,
        w3t + static_cast<int64_t>(l) * 9 * P::kK * P::kG, H, W, cmax, c0 + l * G, K, G);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// the block in `dtype` on the instantiation of layout (KP, GP)
template <int KP, int GP>
int run_block(const void* x, void* out, const float* g1, const float* b1, const void* w1,
              const float* g2, const float* b2, const void* w3, int B, int H, int W,
              int c0, int L, int G, int K, int dtype, cudaStream_t s) {
  switch (dtype) {
    case 0:
      return run_block_f32<KP, GP>(x, out, g1, b1, w1, g2, b2, w3, B, H, W, c0, L, G, K, s);
    case 1:
      return run_block_bf16<KP, GP>(x, out, g1, b1, w1, g2, b2, w3, B, H, W, c0, L, G, K, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, with w1 (L, cmax, K) and w3 (L, 3, 3, K, G) in f32; 1 =
// bfloat16, with w1 and w3 packed in the layout of (K, G) (see the top). Runs
// the whole block: the copy of x into the buffer, then one layer launch per
// layer, all on `stream`, without synchronising. Returns the first
// cudaError_t (0 on success; cudaErrorInvalidValue past K 192 or G 48).
extern "C" int dmm_dense_block_strip(const void* x, void* out, const void* g1,
                                     const void* b1, const void* w1, const void* g2,
                                     const void* b2, const void* w3, int B, int H,
                                     int W, int c0, int L, int G, int K, int dtype,
                                     void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || c0 <= 0 || L <= 0 || G <= 0 || K <= 0 ||
      B > 65535 || (H + kTH - 1) / kTH > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f_g1 = static_cast<const float*>(g1);
  const float* f_b1 = static_cast<const float*>(b1);
  const float* f_g2 = static_cast<const float*>(g2);
  const float* f_b2 = static_cast<const float*>(b2);
  switch (layer_layout(K, G)) {
    case 0:
      return run_block<128, 32>(x, out, f_g1, f_b1, w1, f_g2, f_b2, w3, B, H, W, c0, L, G,
                                K, dtype, s);
    case 1:
      return run_block<192, 48>(x, out, f_g1, f_b1, w1, f_g2, f_b2, w3, B, H, W, c0, L, G,
                                K, dtype, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 layer kernel's dynamic shared memory per block in the layout of
// (K, G), or -1 past the widest.
extern "C" int dmm_dense_layer_mma_smem(int K, int G) {
  switch (layer_layout(K, G)) {
    case 0: return static_cast<int>(LayerPlan<128, 32>::kSmem);
    case 1: return static_cast<int>(LayerPlan<192, 48>::kSmem);
    default: return -1;
  }
}
