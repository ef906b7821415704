// K5: a whole DenseNet dense block at inference as independent row strips
// that recompute their halo, in one launch, for Hopper (sm_90a).
//
// Replaces the Pallas kernel
// dmmfods_tpu/ops/pallas/dense_block_strip.py::dense_block_strip (kernel body
// _strip_kernel). It computes K2's function (csrc/dense_block_strip.cu) with
// K2's rounding, through the same per-tile layer bodies: in bf16
// csrc/dense_layer_mma.cuh on the tensor cores, at K2's 8x16 tile, so the
// two give the same bits; in f32 csrc/dense_layer_tile.cuh on the CUDA cores
// (the check type). For each layer l, with BN folded and width = c0 + l * G:
//
//   act = ReLU(buf[..., :width] * g1 + b1)            rounded to T
//   y1  = act @ w1                                    f32 accumulation
//   y2  = ReLU(y1 * g2 + b2), 0 outside the window   rounded to T
//   buf[..., width:width + G] = conv3x3(y2, w3)        f32 accumulation
//
// Operands (NHWC, batch 1): x (1, H, W, c0) T; out (1, H, W, cmax) T, the
// block's output buffer; halo (strips, 2 L, W, cmax) T, scratch; arrive
// (strips) uint32, scratch; g1, b1 (L, cmax) float, zero beyond each width;
// g2, b2 (L, K) float; w1 and w3 as K2 takes them (f32 (L, cmax, K) and (L,
// 3, 3, K, G); bf16 packed as (L, cp, KP) and (L, 9, KP, GP) in the layout
// (KP, GP) of (K, G): (128, 32) or (192, 48)). Both kernels are templates
// on the layout, picked by shape in the C entry. The caller allocates both
// scratch buffers; this file allocates nothing.
//
// What the TPU kernel does: each in-order grid step computes rs output rows
// from a window of rs + 2 L input rows held in VMEM for all L layers; the
// halo rows are recomputed in every strip, so the strips are independent;
// layer l's validity window shrinks by one row a side, and y2 is zeroed
// outside it and outside the image.
//
// What carries over: independent strips, the recomputed halo, the shrinking
// window, and one launch per dense block. What does not: one full-width row
// of the buffer is 245,760 B at both 1280x1920 blocks (480 px * 256 ch * 2 B,
// 240 px * 512 ch * 2 B), above the 232,448 B of shared memory a block may
// use, so a strip's window lives in device memory. A strip's own rows are
// its rows of `out`; its halo rows, whose outer rows hold values that must
// never reach the output, are its private rows of `halo` (L above, L below).
//
// The design. The plane is cut into strips of `rows` output rows (the last
// may be ragged); the caller picks rows (ops/dense_block_strip.py
// plan_strips). One cooperative launch of `blocks` 256-thread blocks, at most
// as many as the SMs hold (two an SM in bf16 at (128, 32), one at (192, 48)
// and in f32), all resident at once, which the launch checks first; strip s owns blocks [s * blocks / strips,
// (s + 1) * blocks / strips). A strip's blocks copy its window of x into
// channels [0, c0), then run the layers: layer l computes the output rows
// [r0 - e, r1 + e), e = L - 1 - l (clipped to the image), tile by tile
// (8x16 tiles dealt round-robin over the strip's blocks), reading the rows
// [r0 - e - 1, r1 + e + 1) that the previous layer left valid. Between
// layers the strip's blocks, and only they, meet at a barrier: a counter in
// device memory with a device fence on each side. Every block of the
// strip reads slabs that its neighbours wrote, so the buffer and the halo are
// never read through the non-coherent read-only path (no __restrict__ on
// them). Each layer computes only its shrinking window, so each boundary
// between strips costs about L - 1 recomputed rows a layer: the work is
// 1 + (L - 1) (strips - 1) / H times the block's, plus the tiles' rounding
// to 8 rows (JAX's whole-window schedule pays (rs + 2 L) / rs).
//
// What bounds it on an H100: as K2's, the layer body's latency
// (csrc/dense_layer_mma.cuh), at two 256-thread blocks an SM in bf16 at
// (128, 32) (one at (192, 48)); and
// beside K2, the strips' recomputed rows (1.016x / 1.069x of the block's at
// the two 1280x1920 blocks). It takes 1.06 / 1.20 ms there against K2's
// 0.95 / 0.98 (at 700 W); its barriers cost at most 0.02 ms a call.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "dense_layer_mma.cuh"
#include "dense_layer_tile.cuh"

namespace {

constexpr int kTH = 8;                       // output tile rows
constexpr int kTW = 16;                      // output tile columns
// a barrier that waits longer than this traps instead of hanging the card
constexpr unsigned long long kBarrierTimeoutNs = 10ull * 1000 * 1000 * 1000;

// A strip's window: its own rows [r0, r1) in `out`, the halo rows
// [r0 - L, r0) in `above` and [r1, r1 + L) in `below` (both private to the
// strip). A layer touches only rows [ylo, yhi) of the image.
template <typename T>
struct StripFrame {
  T* out;
  T* above;
  T* below;
  int r0, r1, L, W, cmax;
  int ylo, yhi;
  __device__ __forceinline__ bool inside(int y, int x) const {
    return y >= ylo && y < yhi && x >= 0 && x < W;
  }
  // channel 0 of pixel (y, x)
  __device__ __forceinline__ T* at(int y, int x) const {
    const int64_t row = static_cast<int64_t>(W) * cmax;
    T* base = y < r0 ? above + (y - r0 + L) * row
                     : (y < r1 ? out + y * row : below + (y - r1) * row);
    return base + static_cast<int64_t>(x) * cmax;
  }
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A block's strip, kept in shared memory by its kernel and written by thread
// 0 only: its window as the current layer reads and writes it, its barrier's
// counter and target, its blocks and this block's rank among them, and the
// current layer's first output row and tiles. The loops around the layer
// body read it anew after each barrier, so it holds no registers across the
// bf16 body's accumulators (dense_layer_mma.cuh: LayerArgs).
template <typename T>
struct StripState {
  StripFrame<T> frame;
  unsigned int* count;
  unsigned int target;
  int nb, rank, oy0, tiles;
};

// Every block of the strip has stored its slabs and will see the others':
// each block adds one to the strip's counter, which reaches the target (the
// strip's block count times the barriers passed) when all have arrived. The
// launch is cooperative, so all blocks are resident and the wait ends.
template <typename T>
__device__ __forceinline__ void strip_barrier(StripState<T>& st) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int target = st.target += st.nb;
    __threadfence();
    atomicAdd(st.count, 1u);
    const unsigned long long t0 = global_ns();
    while (*reinterpret_cast<volatile unsigned int*>(st.count) < target) {
      __nanosleep(64);
      if (global_ns() - t0 > kBarrierTimeoutNs) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// the first block of strip s
__device__ __forceinline__ int first_block(int s, int strips, int blocks) {
  return static_cast<int>(static_cast<int64_t>(s) * blocks / strips);
}

// What both kernels do around their layer body, with their strip's state
// `st` in shared memory: find this block's strip, copy the strip's window of
// x into channels [0, c0), then for each layer l set the window it reads,
// call begin(l), and run this block's share of the layer's tiles as
// tile(st.frame, l, y0, x0), with the strip's barrier between layers.
template <typename T, typename Begin, typename Tile>
__device__ __forceinline__ void strip_schedule(const T* __restrict__ x, T* out, T* halo,
                                               unsigned int* arrive, int H, int W, int c0,
                                               int L, int G, int rows, StripState<T>& st,
                                               Begin begin, Tile tile) {
  if (threadIdx.x == 0) {
    const int strips = (H + rows - 1) / rows;
    const int blocks = gridDim.x;
    const int b = blockIdx.x;
    int s = static_cast<int>(static_cast<int64_t>(b) * strips / blocks);
    while (s + 1 < strips && first_block(s + 1, strips, blocks) <= b) ++s;
    while (first_block(s, strips, blocks) > b) --s;
    const int first = first_block(s, strips, blocks);
    const int cmax = c0 + L * G;
    const int64_t row = static_cast<int64_t>(W) * cmax;
    StripFrame<T>& frame = st.frame;
    frame.out = out;
    frame.above = halo + static_cast<int64_t>(s) * 2 * L * row;
    frame.below = frame.above + L * row;
    frame.r0 = s * rows;
    frame.r1 = min(frame.r0 + rows, H);
    frame.L = L;
    frame.W = W;
    frame.cmax = cmax;
    frame.ylo = max(frame.r0 - L, 0);
    frame.yhi = min(frame.r1 + L, H);
    st.count = arrive + s;
    st.target = 0;
    st.nb = first_block(s + 1, strips, blocks) - first;
    st.rank = b - first;
  }
  __syncthreads();

  {  // the window's rows of x into channels [0, c0)
    const StripFrame<T> frame = st.frame;
    const T* src = x + static_cast<int64_t>(frame.ylo) * W * c0;
    const int64_t n = static_cast<int64_t>(frame.yhi - frame.ylo) * W * c0;
    for (int64_t e = static_cast<int64_t>(st.rank) * kLayerThreads + threadIdx.x; e < n;
         e += static_cast<int64_t>(st.nb) * kLayerThreads) {
      const int64_t p = e / c0;
      frame.at(frame.ylo + static_cast<int>(p / W), static_cast<int>(p % W))[e - p * c0] =
          src[e];
    }
  }
  strip_barrier(st);

  const int tiles_x = (W + kTW - 1) / kTW;
  for (int l = 0; l < L; ++l) {
    if (threadIdx.x == 0) {
      const int e = L - 1 - l;               // rows a side later layers still read
      StripFrame<T>& frame = st.frame;
      st.oy0 = max(frame.r0 - e, 0);
      st.tiles = ((min(frame.r1 + e, H) - st.oy0 + kTH - 1) / kTH) * tiles_x;
      frame.ylo = max(frame.r0 - e - 1, 0);  // what layer l - 1 left valid
      frame.yhi = min(frame.r1 + e + 1, H);
    }
    begin(l);
    __syncthreads();
    for (int t = st.rank; t < st.tiles; t += st.nb)
      tile(st.frame, l, st.oy0 + (t / tiles_x) * kTH, (t % tiles_x) * kTW);
    if (l + 1 < L) strip_barrier(st);
  }
}

template <int KMax, int GMax>
__global__ void __launch_bounds__(kLayerThreads, 1)
dense_block_recompute_kernel(const float* __restrict__ x, float* out, float* halo,
                             unsigned int* arrive, const float* __restrict__ g1,
                             const float* __restrict__ b1, const float* __restrict__ w1,
                             const float* __restrict__ g2, const float* __restrict__ b2,
                             const float* __restrict__ w3, int H, int W, int c0, int L,
                             int G, int K, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ StripState<float> state;
  unsigned char* smem = smem_raw;
  strip_schedule<float>(
      x, out, halo, arrive, H, W, c0, L, G, rows, state, [](int) {},
      [=](const StripFrame<float>& frame, int l, int y0, int x0) {
        const int64_t cmax = c0 + L * G;
        dense_layer_tile<kTH, kTW, KMax, GMax>(
            smem, frame, c0 + l * G, K, G, y0, x0, g1 + l * cmax, b1 + l * cmax,
            w1 + l * cmax * K, g2 + l * K, b2 + l * K,
            w3 + static_cast<int64_t>(l) * 9 * K * G);
      });
}

template <int KP, int GP>
using LayerPlan = LayerMma<kTH, kTW, KP, GP>;

// The bf16 kernel keeps each layer's LayerArgs in shared memory beside the
// strip's state, written by thread 0 at the start of the layer.
template <int KP, int GP>
__global__ void __launch_bounds__(kLayerThreads, LayerPlan<KP, GP>::kBlocksPerSm)
dense_block_recompute_mma_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* out,
                                 __nv_bfloat16* halo, unsigned int* arrive,
                                 const float* __restrict__ g1, const float* __restrict__ b1,
                                 const __nv_bfloat16* __restrict__ w1,
                                 const float* __restrict__ g2, const float* __restrict__ b2,
                                 const __nv_bfloat16* __restrict__ w3, int H, int W, int c0,
                                 int L, int G, int K, int rows) {
  using P = LayerPlan<KP, GP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ StripState<__nv_bfloat16> state;
  __shared__ LayerArgs args_s;
  unsigned char* smem = smem_raw;
  LayerArgs* args = &args_s;
  strip_schedule<__nv_bfloat16>(
      x, out, halo, arrive, H, W, c0, L, G, rows, state,
      [=](int l) {
        if (threadIdx.x != 0) return;
        const int64_t cmax = c0 + L * G;
        const int64_t cp = (cmax + P::kCK - 1) / P::kCK * P::kCK;   // w1's packed rows
        *args = LayerArgs{c0 + l * G, K, G, g1 + l * cmax, b1 + l * cmax,
                          w1 + l * cp * P::kK, g2 + l * K, b2 + l * K,
                          w3 + static_cast<int64_t>(l) * 9 * P::kK * P::kG};
      },
      [=](const StripFrame<__nv_bfloat16>& frame, int, int y0, int x0) {
        dense_layer_mma<kTH, kTW, KP, GP>(smem, frame, *args, y0, x0);
      });
}

// One cooperative launch of `blocks` blocks of `kernel`, after checking that
// they can all be resident: the strip barriers wait for every block of a
// strip, so a grid the card cannot hold at once is refused here rather than
// left to hang (the barrier's trap is the last resort).
template <typename... KArgs, typename... Args>
int launch_cooperative(void (*kernel)(KArgs...), size_t smem, int blocks, int strips,
                       void* arrive, cudaStream_t s, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kLayerThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks > per_sm * sms) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  err = cudaMemsetAsync(arrive, 0, static_cast<size_t>(strips) * sizeof(unsigned int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(kLayerThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int KP, int GP>
int run_block(const void* x, void* out, const float* g1, const float* b1, const void* w1,
              const float* g2, const float* b2, const void* w3, int H, int W, int c0, int L,
              int G, int K, int dtype, void* halo, void* arrive, int rows, int blocks,
              cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  const int strips = (H + rows - 1) / rows;
  unsigned int* counts = static_cast<unsigned int*>(arrive);
  if (dtype == 0) {
    return launch_cooperative(
        dense_block_recompute_kernel<KP, GP>, LayerTile<kTH, kTW, KP, GP>::kSmem, blocks,
        strips, arrive, s, static_cast<const float*>(x), static_cast<float*>(out),
        static_cast<float*>(halo), counts, g1, b1, static_cast<const float*>(w1), g2, b2,
        static_cast<const float*>(w3), H, W, c0, L, G, K, rows);
  }
  return launch_cooperative(
      dense_block_recompute_mma_kernel<KP, GP>, LayerPlan<KP, GP>::kSmem, blocks, strips,
      arrive, s, static_cast<const bf16*>(x), static_cast<bf16*>(out),
      static_cast<bf16*>(halo), counts, g1, b1, static_cast<const bf16*>(w1), g2, b2,
      static_cast<const bf16*>(w3), H, W, c0, L, G, K, rows);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The same leading operands as
// dmm_dense_block_strip (B must be 1; w1 and w3 laid out as it takes them),
// then the scratch: halo (strips, 2 L, W, cmax) of the dtype and arrive
// (strips) uint32, with strips = ceil(H / rows), and the grid of `blocks` >=
// strips blocks, at most as many as the card holds at once. Runs the whole
// block, the copy of x into the buffer included, as one launch on `stream`,
// without synchronising. Returns the first cudaError_t (0 on success;
// cudaErrorCooperativeLaunchTooLarge for a grid the card cannot hold;
// cudaErrorInvalidValue past K 192 or G 48).
extern "C" int dmm_dense_block_recompute(const void* x, void* out, const void* g1,
                                         const void* b1, const void* w1, const void* g2,
                                         const void* b2, const void* w3, int B, int H,
                                         int W, int c0, int L, int G, int K, int dtype,
                                         void* stream, void* halo, void* arrive, int rows,
                                         int blocks) {
  const int64_t cmax = static_cast<int64_t>(c0) + static_cast<int64_t>(L) * G;
  if (B != 1 || H <= 0 || W <= 0 || c0 <= 0 || L <= 0 || G <= 0 || K <= 0 || rows <= 0 ||
      blocks < (H + rows - 1) / rows || blocks > 65535 || (dtype != 0 && dtype != 1) ||
      static_cast<int64_t>(H) * W * cmax > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* f_g1 = static_cast<const float*>(g1);
  const float* f_b1 = static_cast<const float*>(b1);
  const float* f_g2 = static_cast<const float*>(g2);
  const float* f_b2 = static_cast<const float*>(b2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (layer_layout(K, G)) {
    case 0:
      return run_block<128, 32>(x, out, f_g1, f_b1, w1, f_g2, f_b2, w3, H, W, c0, L, G, K,
                                dtype, halo, arrive, rows, blocks, s);
    case 1:
      return run_block<192, 48>(x, out, f_g1, f_b1, w1, f_g2, f_b2, w3, H, W, c0, L, G, K,
                                dtype, halo, arrive, rows, blocks, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
