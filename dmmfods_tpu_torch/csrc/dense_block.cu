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
// the rounding of K2 (csrc/dense_block_strip.cu), whose per-tile layer
// bodies this kernel runs: csrc/dense_layer_mma.cuh on the tensor cores in
// bf16, csrc/dense_layer_tile.cuh on the CUDA cores in f32 (the check type;
// TF32 would not meet its 1e-4 bound).
//
// Operands (NHWC): x (B, H, W, c0) T; out (B, H, W, cmax) T, the block's
// output buffer; g1, b1 (L, cmax) float, zero beyond each width; g2, b2 (L,
// K) float; w1 and w3 in f32 as (L, cmax, K) and (L, 3, 3, K, G), in bf16
// packed by ops/dense_block_strip.py::pack_layer_weights as (L, cp, KP) and
// (L, 9, KP, GP), cp = cmax rounded up to 32, zeros in the padding, (KP, GP)
// the layout of (K, G): (128, 32) or (192, 48). Both kernels are templates
// on the tile and the layout; the C entry picks both by shape.
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
// still spread over the SMs) share the image's tiles; each block runs the
// layer body over its tiles of one layer, then the cluster waits at a
// barrier before the next layer. The buffer is the output tensor in device
// memory (L2-resident at these sizes), written once per slab; y2 stays in
// shared memory per tile, with the 1x1 recomputed on the tile's ring. A
// layer reads [0, width) and writes [width, width + G) of its own tiles'
// pixels, so within a layer nothing races; across layers a slab written by
// one block of the cluster is read by its neighbours, so the barrier is a
// release/acquire one with a device fence on each side, and the buffer is
// never read through the non-coherent read-only path (no __restrict__ on
// it; the bf16 body stages it by cp.async.cg, which reads through L2, and
// by plain loads where a piece straddles width or 16-byte alignment).
// Tiles never straddle two images, and the image mask zeroes the 3x3's
// neighbours outside each image, so packed images do not bleed.
//
// Tile shapes: 8x16, 8x12 and 4x6, the one with the least padded halo work
// (tiles x the 1x1's M padded to 16 rows; the larger tile on a tie) for the
// plane: 32x48 -> 8x16 (12 tiles, 12 m16 tiles of halo each), 16x24 and
// 8x12 -> 8x12 (4 and 1 tiles, 9 m16 tiles), 4x6 -> 4x6 (1 tile, 3 m16
// tiles): the DenseNet-121 blocks at 128x192, with no ragged tile. The bf16
// body deals each tile's 3x3 over its 8 warps as (m16 tile, n8 pair) units
// (dense_layer_mma.cuh): at G 32 16 at 8x16 (two a warp), 12 at 8x12, 4 at
// 4x6; at G 48 (DenseNet-161) 24 at 8x16 (three a warp), 18 at 8x12, 6 at
// 4x6 (one a warp).
// ops/dense_block.py::block_plan mirrors this plan and dmm_dense_block_plan
// reports the one this file makes.
//
// What bounds it on an H100: at b256 the four blocks do 26-261 GFLOP
// (0.03-0.26 ms on the tensor cores) and must move 0.01-0.2 GB (at most
// 0.06 ms): operations. The bf16 kernel takes 2.2 / 1.8 / 1.5 / 0.65 ms
// there (at 700 W), the layer body's latency (dense_layer_mma.cuh). At
// (128, 32) it runs two 256-thread blocks an SM (97 KB of shared memory at
// 8x16, at most 128 registers), so one block's staging runs under the
// other's products (at (192, 48) one, but two at 4x6);
// the planes of blocks 3 and 4, one tile an image, recompute the 1x1 on a
// ring that lies wholly outside the image (140 halo pixels for 96 outputs
// at 8x12, 48 for 24 at 4x6), and the 4x6 tile's 3x3 keeps half the warps
// busy. Skipping the ring's m16 tiles that lie wholly outside the image
// would save one of 9 at 8x12 and none at 4x6: at most 0.04 ms of block 3's
// 1.5 (its 1x1 MMAs take 0.31), so the body runs them. The f32 kernel is
// the CUDA-core body at one block an SM.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "dense_layer_mma.cuh"
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

// What both kernels do around their layer body: the block input into
// channels [0, c0) of image blockIdx.y's buffer, then for each layer l
// begin(l), a block barrier, and every tile of this block (rank blockIdx.x
// of the cluster's gridDim.x) as tile(l, y0, x0), with the cluster's barrier
// after each layer.
template <typename T, int TH, int TW, typename Begin, typename Tile>
__device__ __forceinline__ void block_schedule(const T* __restrict__ x, T* out, int H, int W,
                                               int c0, int L, int G, Begin begin, Tile tile) {
  const int cmax = c0 + L * G;
  const int pixels = H * W;
  T* img = out + static_cast<int64_t>(blockIdx.y) * pixels * cmax;
  const T* src = x + static_cast<int64_t>(blockIdx.y) * pixels * c0;
  for (int e = blockIdx.x * kLayerThreads + threadIdx.x; e < pixels * c0;
       e += gridDim.x * kLayerThreads) {
    const int p = e / c0;
    img[static_cast<int64_t>(p) * cmax + (e - p * c0)] = src[e];
  }
  cluster_barrier();

  const int tiles_x = (W + TW - 1) / TW;
  const int tiles = tiles_x * ((H + TH - 1) / TH);
  for (int l = 0; l < L; ++l) {
    begin(l);
    __syncthreads();
    for (int t = blockIdx.x; t < tiles; t += gridDim.x)
      tile(l, (t / tiles_x) * TH, (t % tiles_x) * TW);
    cluster_barrier();
  }
}

// image blockIdx.y of the (B, H, W, cmax) buffer
template <typename T>
__device__ __forceinline__ ImageFrame<T> image_frame(T* out, int H, int W, int cmax) {
  return ImageFrame<T>{out + static_cast<int64_t>(blockIdx.y) * H * W * cmax, H, W, cmax};
}

template <int TH, int TW, int KMax, int GMax>
__global__ void __launch_bounds__(kLayerThreads, 1)
dense_block_kernel(const float* __restrict__ x, float* out, const float* __restrict__ g1,
                   const float* __restrict__ b1, const float* __restrict__ w1,
                   const float* __restrict__ g2, const float* __restrict__ b2,
                   const float* __restrict__ w3, int H, int W, int c0, int L, int G,
                   int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  block_schedule<float, TH, TW>(
      x, out, H, W, c0, L, G, [](int) {},
      [=](int l, int y0, int x0) {
        const int64_t cmax = c0 + L * G;
        dense_layer_tile<TH, TW, KMax, GMax>(
            smem, image_frame(out, H, W, c0 + L * G), c0 + l * G, K, G, y0, x0,
            g1 + l * cmax, b1 + l * cmax, w1 + l * cmax * K, g2 + l * K, b2 + l * K,
            w3 + static_cast<int64_t>(l) * 9 * K * G);
      });
}

// The bf16 kernel keeps its frame and each layer's LayerArgs in shared
// memory, written by thread 0 at the start of the layer (LayerArgs in
// dense_layer_mma.cuh says why).
template <int TH, int TW, int KP, int GP>
__global__ void __launch_bounds__(kLayerThreads, LayerMma<TH, TW, KP, GP>::kBlocksPerSm)
dense_block_mma_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* out,
                       const float* __restrict__ g1, const float* __restrict__ b1,
                       const __nv_bfloat16* __restrict__ w1, const float* __restrict__ g2,
                       const float* __restrict__ b2, const __nv_bfloat16* __restrict__ w3,
                       int H, int W, int c0, int L, int G, int K) {
  using P = LayerMma<TH, TW, KP, GP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ ImageFrame<__nv_bfloat16> frame_s;
  __shared__ LayerArgs args_s;
  unsigned char* smem = smem_raw;
  ImageFrame<__nv_bfloat16>* frame = &frame_s;
  LayerArgs* args = &args_s;
  block_schedule<__nv_bfloat16, TH, TW>(
      x, out, H, W, c0, L, G,
      [=](int l) {
        if (threadIdx.x != 0) return;
        const int64_t cmax = c0 + L * G;
        const int64_t cp = (cmax + P::kCK - 1) / P::kCK * P::kCK;   // w1's packed rows
        *frame = image_frame(out, H, W, c0 + L * G);
        *args = LayerArgs{c0 + l * G, K, G, g1 + l * cmax, b1 + l * cmax,
                          w1 + l * cp * P::kK, g2 + l * K, b2 + l * K,
                          w3 + static_cast<int64_t>(l) * 9 * P::kK * P::kG};
      },
      [=](int, int y0, int x0) {
        dense_layer_mma<TH, TW, KP, GP>(smem, *frame, *args, y0, x0);
      });
}

int tiles_of(int H, int W, int TH, int TW) {
  return ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
}

// blocks per image: enough to cover the SMs at small batch, at most the
// portable cluster size, and dividing the tiles evenly
int cluster_size(int B, int tiles, int sms) {
  int want = (sms + B - 1) / B;
  want = want < kMaxCluster ? want : kMaxCluster;
  for (int c = want; c > 1; --c)
    if (tiles % c == 0) return c;
  return 1;
}

// The plane's tile, by index into (8x16, 8x12, 4x6): the least padded halo
// work, the larger tile on a tie
int pick_tile(int H, int W) {
  const int c816 = tiles_of(H, W, 8, 16) * LayerMma<8, 16, 128, 32>::kNP;
  const int c812 = tiles_of(H, W, 8, 12) * LayerMma<8, 12, 128, 32>::kNP;
  const int c46 = tiles_of(H, W, 4, 6) * LayerMma<4, 6, 128, 32>::kNP;
  if (c816 <= c812 && c816 <= c46) return 0;
  return c812 <= c46 ? 1 : 2;
}

// One launch of `kernel` on B clusters of blocks sharing an image's tiles.
template <typename... KArgs, typename... Args>
int launch_clusters(void (*kernel)(KArgs...), size_t smem, int B, int tiles, cudaStream_t s,
                    Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cs = cluster_size(B, tiles, sms);
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
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int TH, int TW, int KP, int GP>
int launch(const void* x, void* out, const float* g1, const float* b1, const void* w1,
           const float* g2, const float* b2, const void* w3, int B, int H, int W, int c0,
           int L, int G, int K, int dtype, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  const int tiles = tiles_of(H, W, TH, TW);
  if (dtype == 0) {
    return launch_clusters(dense_block_kernel<TH, TW, KP, GP>,
                           LayerTile<TH, TW, KP, GP>::kSmem, B, tiles, s,
                           static_cast<const float*>(x), static_cast<float*>(out), g1, b1,
                           static_cast<const float*>(w1), g2, b2,
                           static_cast<const float*>(w3), H, W, c0, L, G, K);
  }
  return launch_clusters(dense_block_mma_kernel<TH, TW, KP, GP>,
                         LayerMma<TH, TW, KP, GP>::kSmem, B, tiles, s,
                         static_cast<const bf16*>(x), static_cast<bf16*>(out), g1, b1,
                         static_cast<const bf16*>(w1), g2, b2, static_cast<const bf16*>(w3),
                         H, W, c0, L, G, K);
}

// the tile's launch in the layout of (K, G)
template <int TH, int TW>
int launch_layout(const void* x, void* out, const float* g1, const float* b1, const void* w1,
                  const float* g2, const float* b2, const void* w3, int B, int H, int W,
                  int c0, int L, int G, int K, int dtype, cudaStream_t s) {
  switch (layer_layout(K, G)) {
    case 0:
      return launch<TH, TW, 128, 32>(x, out, g1, b1, w1, g2, b2, w3, B, H, W, c0, L, G, K,
                                     dtype, s);
    case 1:
      return launch<TH, TW, 192, 48>(x, out, g1, b1, w1, g2, b2, w3, B, H, W, c0, L, G, K,
                                     dtype, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// a tile's plan in a layout: (TH, TW, its 1x1's m16 tiles, its 3x3's, the
// 3x3's units, the most a warp runs, the bf16 kernel's dynamic shared memory)
template <int TH, int TW, int KP, int GP>
void tile_plan(int* plan) {
  using P = LayerMma<TH, TW, KP, GP>;
  plan[0] = TH;
  plan[1] = TW;
  plan[2] = P::kMT1;
  plan[3] = P::kMT3;
  plan[4] = P::kUnits;
  plan[5] = P::kWarpUnits;
  plan[6] = static_cast<int>(P::kSmem);
}

template <int TH, int TW>
void tile_plan_layout(int layout, int* plan) {
  if (layout == 0)
    tile_plan<TH, TW, 128, 32>(plan);
  else
    tile_plan<TH, TW, 192, 48>(plan);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (w1 and w3 packed: see the top). Runs the
// whole block, the copy of x into the buffer included, as one launch on
// `stream`, without synchronising. Returns the first cudaError_t (0 on
// success; cudaErrorInvalidValue past K 192 or G 48).
extern "C" int dmm_dense_block(const void* x, void* out, const void* g1, const void* b1,
                               const void* w1, const void* g2, const void* b2,
                               const void* w3, int B, int H, int W, int c0, int L,
                               int G, int K, int dtype, void* stream) {
  const int64_t cmax = static_cast<int64_t>(c0) + static_cast<int64_t>(L) * G;
  if (B <= 0 || H <= 0 || W <= 0 || c0 <= 0 || L <= 0 || G <= 0 || K <= 0 ||
      layer_layout(K, G) < 0 || B > 65535 || (dtype != 0 && dtype != 1) ||
      static_cast<int64_t>(H) * W * cmax > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f_g1 = static_cast<const float*>(g1);
  const float* f_b1 = static_cast<const float*>(b1);
  const float* f_g2 = static_cast<const float*>(g2);
  const float* f_b2 = static_cast<const float*>(b2);
  switch (pick_tile(H, W)) {
    case 0:
      return launch_layout<8, 16>(x, out, f_g1, f_b1, w1, f_g2, f_b2, w3, B, H, W, c0, L, G,
                                  K, dtype, s);
    case 1:
      return launch_layout<8, 12>(x, out, f_g1, f_b1, w1, f_g2, f_b2, w3, B, H, W, c0, L, G,
                                  K, dtype, s);
    default:
      return launch_layout<4, 6>(x, out, f_g1, f_b1, w1, f_g2, f_b2, w3, B, H, W, c0, L, G,
                                 K, dtype, s);
  }
}

// The launch plan dmm_dense_block makes for a batch of B images of H x W
// with growth G and bottleneck K on a card of `sms` SMs, into plan[0..8]:
// the tile (TH, TW), its tiles an image, the cluster's blocks, the tile's 1x1
// and 3x3 m16 tiles, the 3x3's units, the most of them a warp runs and the
// bf16 kernel's dynamic shared memory, in the layout of (K, G). Returns 0,
// or cudaErrorInvalidValue.
extern "C" int dmm_dense_block_plan(int B, int H, int W, int sms, int G, int K, int* plan) {
  const int layout = layer_layout(K, G);
  if (B <= 0 || H <= 0 || W <= 0 || sms <= 0 || G <= 0 || K <= 0 || layout < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int tile[7];
  switch (pick_tile(H, W)) {
    case 0: tile_plan_layout<8, 16>(layout, tile); break;
    case 1: tile_plan_layout<8, 12>(layout, tile); break;
    default: tile_plan_layout<4, 6>(layout, tile); break;
  }
  const int tiles = tiles_of(H, W, tile[0], tile[1]);
  plan[0] = tile[0];
  plan[1] = tile[1];
  plan[2] = tiles;
  plan[3] = cluster_size(B, tiles, sms);
  for (int i = 2; i < 7; ++i) plan[i + 2] = tile[i];
  return 0;
}
