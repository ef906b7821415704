// K4: a whole DenseNet dense block in one launch, for Hopper (sm_90a).
//
// Replaces the Pallas kernel
// dmmfods_tpu/ops/pallas/dense_block.py::dense_block_pallas (kernel body
// _block_kernel). For each layer l, with BN folded and width = c0 + l * G:
//
//   act = ReLU(buf[..., :width] * g1 + b1)            rounded to T
//   y1  = act @ w1                                    f32 accumulation
//   y2  = ReLU(y1 * g2 + b2), zero outside its image  rounded to T
//   buf[..., width:width + G] = conv3x3(y2, w3)        f32 accumulation
//
// the rounding of K2 (csrc/dense_block_strip.cu), whose per-tile layer body
// (csrc/dense_layer_tile.cuh) this kernel runs.
//
// Operands (NHWC): x (B, H, W, c0) T; out (B, H, W, cmax) T, the block's
// output buffer; g1, b1 (L, cmax) float, zero beyond each width; w1 (L, cmax,
// K) T; g2, b2 (L, K) float; w3 (L, 3, 3, K, G) T.
//
// Why the TPU design does not carry over. A TPU program holds the whole
// (cmax, group * h * w) buffer of a group of images in VMEM, up to 20 MB. A
// GPU block has at most 227 KB of shared memory, and one image's buffer at
// 128x192 is already 786 KB (block 1, bf16), 393 KB (block 2), 196 KB
// (block 3). What carries over is the point of the kernel: a program owns
// whole images, so no other program reads its 3x3 halo, and all L layers
// run in one launch with a barrier between layers and no concat.
//
// The design: one thread-block cluster per image. Its cs blocks (cs <= 8,
// dividing the image's tiles, chosen by the batch so that small batches
// still spread over the SMs) share the image's tiles; each block runs
// dense_layer_tile over its tiles of one layer, then the cluster waits at a
// barrier before the next layer. The buffer is the output tensor in device
// memory (L2-resident at these sizes), written once per slab; y2 stays in
// shared memory per tile, with the 1x1 recomputed on the tile's ring. A
// layer reads [0, width) and writes [width, width + G) of its own tiles'
// pixels, so within a layer nothing races; across layers a slab written by
// one block of the cluster is read by its neighbours, so the barrier is a
// release/acquire one with a device fence on each side, and the buffer is
// never read through the non-coherent read-only path (no __restrict__ on
// it). Tiles never straddle two images, and the image mask zeroes the 3x3's
// neighbours outside each image, so packed images do not bleed.
//
// Tile shapes: 8x16, 8x12 and 4x6, the one with the least padded halo work
// for the plane (32x48 -> 8x16, 16x24 and 8x12 -> 8x12, 4x6 -> 4x6: the
// DenseNet-121 blocks at 128x192 with no ragged tile).
//
// What bounds it on an H100: as K2, the staging into shared memory and the
// CUDA-core f32 FMAs, one after the other at one block per SM (PERF.md);
// the small tiles of blocks 3 and 4 use 75% and 19% of the 3x3's threads.
// This is the simple version: no tensor cores, no asynchronous staging.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "dense_layer_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;               // the portable cluster size

// Every block of the cluster has stored its slabs and will see the others'.
__device__ __forceinline__ void cluster_barrier() {
  __threadfence();
  cg::this_cluster().sync();
  __threadfence();
}

template <typename T, int TH, int TW>
__global__ void __launch_bounds__(kLayerThreads, 1)
dense_block_kernel(const T* __restrict__ x, T* out, const float* __restrict__ g1,
                   const float* __restrict__ b1, const T* __restrict__ w1,
                   const float* __restrict__ g2, const float* __restrict__ b2,
                   const T* __restrict__ w3, int H, int W, int c0, int L, int G,
                   int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cs = gridDim.x;                  // blocks per image = the cluster
  const int rank = blockIdx.x;
  const int cmax = c0 + L * G;
  const int pixels = H * W;
  T* img = out + static_cast<int64_t>(blockIdx.y) * pixels * cmax;
  const T* src = x + static_cast<int64_t>(blockIdx.y) * pixels * c0;

  // the block input into channels [0, c0) of the buffer
  for (int e = rank * kLayerThreads + threadIdx.x; e < pixels * c0;
       e += cs * kLayerThreads) {
    const int p = e / c0;
    img[static_cast<int64_t>(p) * cmax + (e - p * c0)] = src[e];
  }
  cluster_barrier();

  const int tiles_x = (W + TW - 1) / TW;
  const int tiles = tiles_x * ((H + TH - 1) / TH);
  const ImageFrame<T> frame{img, H, W, cmax};
  for (int l = 0; l < L; ++l) {
    for (int t = rank; t < tiles; t += cs) {
      dense_layer_tile<T, TH, TW>(
          smem_raw, frame, c0 + l * G, K, G, (t / tiles_x) * TH,
          (t % tiles_x) * TW, g1 + static_cast<int64_t>(l) * cmax,
          b1 + static_cast<int64_t>(l) * cmax, w1 + static_cast<int64_t>(l) * cmax * K,
          g2 + static_cast<int64_t>(l) * K, b2 + static_cast<int64_t>(l) * K,
          w3 + static_cast<int64_t>(l) * 9 * K * G);
    }
    cluster_barrier();
  }
}

template <int TH, int TW>
int tile_cost(int H, int W) {
  return ((H + TH - 1) / TH) * ((W + TW - 1) / TW) * LayerTile<TH, TW>::kNP;
}

template <typename T, int TH, int TW>
int launch(const void* x, void* out, const float* g1, const float* b1, const void* w1,
           const float* g2, const float* b2, const void* w3, int B, int H, int W,
           int c0, int L, int G, int K, cudaStream_t s) {
  auto kernel = dense_block_kernel<T, TH, TW>;
  const size_t smem = LayerTile<TH, TW>::template smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // blocks per image: enough to cover the SMs at small batch, at most the
  // portable cluster size, and dividing the tiles evenly
  const int tiles = ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  int want = (sms + B - 1) / B;
  want = want < kMaxCluster ? want : kMaxCluster;
  int cs = 1;
  for (int c = want; c > 1; --c) {
    if (tiles % c == 0) {
      cs = c;
      break;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, B, 1);
  cfg.blockDim = dim3(kLayerThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), static_cast<T*>(out),
                           g1, b1, static_cast<const T*>(w1), g2, b2,
                           static_cast<const T*>(w3), H, W, c0, L, G, K);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_block(const void* x, void* out, const float* g1, const float* b1,
              const void* w1, const float* g2, const float* b2, const void* w3,
              int B, int H, int W, int c0, int L, int G, int K, cudaStream_t s) {
  const int c816 = tile_cost<8, 16>(H, W);
  const int c812 = tile_cost<8, 12>(H, W);
  const int c46 = tile_cost<4, 6>(H, W);
  if (c816 <= c812 && c816 <= c46) {
    return launch<T, 8, 16>(x, out, g1, b1, w1, g2, b2, w3, B, H, W, c0, L, G, K, s);
  }
  if (c812 <= c46) {
    return launch<T, 8, 12>(x, out, g1, b1, w1, g2, b2, w3, B, H, W, c0, L, G, K, s);
  }
  return launch<T, 4, 6>(x, out, g1, b1, w1, g2, b2, w3, B, H, W, c0, L, G, K, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Runs the whole block, the copy of x into
// the buffer included, as one launch on `stream`, without synchronising.
// Returns the first cudaError_t (0 on success).
extern "C" int dmm_dense_block(const void* x, void* out, const void* g1, const void* b1,
                               const void* w1, const void* g2, const void* b2,
                               const void* w3, int B, int H, int W, int c0, int L,
                               int G, int K, int dtype, void* stream) {
  const int64_t cmax = static_cast<int64_t>(c0) + static_cast<int64_t>(L) * G;
  if (B <= 0 || H <= 0 || W <= 0 || c0 <= 0 || L <= 0 || G <= 0 || G > kGMax ||
      K <= 0 || K > kKMax || B > 65535 ||
      static_cast<int64_t>(H) * W * cmax > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f_g1 = static_cast<const float*>(g1);
  const float* f_b1 = static_cast<const float*>(b1);
  const float* f_g2 = static_cast<const float*>(g2);
  const float* f_b2 = static_cast<const float*>(b2);
  switch (dtype) {
    case 0:
      return run_block<float>(x, out, f_g1, f_b1, w1, f_g2, f_b2, w3, B, H, W, c0, L, G,
                              K, s);
    case 1:
      return run_block<__nv_bfloat16>(x, out, f_g1, f_b1, w1, f_g2, f_b2, w3, B, H, W,
                                      c0, L, G, K, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
