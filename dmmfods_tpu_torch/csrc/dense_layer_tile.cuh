// One dense layer of a DenseNet block over one TH x TW output tile, in f32 on
// the CUDA cores: the body of the float32 kernels of K2
// (csrc/dense_block_strip.cu: one tile per block, one launch per layer), K4
// (csrc/dense_block.cu: one launch per block, each block looping over the
// layers and its tiles) and K5 (csrc/dense_block_recompute.cu: the same over
// a strip's window). Their bf16 kernels run csrc/dense_layer_mma.cuh on the
// tensor cores; f32 is the check type, and TF32 tensor cores would not meet
// its 1e-4 bound. With BN folded into per-channel (gamma, beta) and
// width = c0 + l * G it computes
//
//   act = ReLU(img[..., :width] * g1 + b1)
//   y1  = act @ w1
//   y2  = ReLU(y1 * g2 + b2), zero outside the frame
//   img[..., width:width + G] = conv3x3(y2, w3)
//
// for the tile's output pixels. A Frame says where the layer's pixels are
// and which it may touch: ImageFrame the whole image of one buffer (K2, K4),
// K5's StripFrame a strip's window, whose own rows lie in the output and
// whose halo rows lie in private scratch. A pixel outside the frame reads as
// the 3x3's zero padding and is never written. The zero has to sit after
// BN2, whose bias makes a zeroed pixel non-zero. Only channels [0, width) of
// a pixel are read: the slabs above are unwritten (an uninitialised buffer
// may hold NaN, and 0 * NaN is NaN).
//
// The body is a template on (KMax, GMax), the widest K and G it takes: one
// of the two layouts below, the one the caller picks by shape
// (layer_layout), the bf16 body's too (dense_layer_mma.cuh). 256 threads:
//   1. stage the tile's (TH+2) x (TW+2) halo of the prefix 32 channels at a
//      time, BN1-folded and ReLU'd on the way into shared memory, beside the
//      matching 32 rows of w1, and accumulate the 1x1 in f32 registers
//      (kPI pixels x kKT channels per thread), in kPasses passes over the
//      prefix of kKPass columns of K each: one pass of 128 (8 channels a
//      thread) at KMax 128, two of 96 (6 a thread) at KMax 192, so the
//      accumulators a thread holds do not grow with K (a pass restages the
//      prefix: f32 is the check type);
//   2. apply BN2 + ReLU + the image mask and keep y2 for the whole halo in
//      shared memory (halo x KMax), each pass its columns;
//   3. run the 3x3 from shared memory, one tap of w3 staged at a time
//      (kOI pixels x GMax / 8 channels per thread), and store the G new
//      channels.
// The 1x1 is recomputed on the halo ring. At (192, 48) y2 is 139,680 B at
// 8x16 and the block 176,672 B: one block an SM, as at (128, 32).
#pragma once

#include <stdint.h>

namespace {

constexpr int kLayerThreads = 256;
constexpr int kCK = 32;                      // prefix channels staged per step

// The padded (K, G) layouts of the layer bodies, by index: every block with
// K <= 128 and G <= 32 runs the first (DenseNet-121, -169, -201), any other
// with K <= 192 and G <= 48 the second (DenseNet-161: growth 48, K 192).
// ops/dense_block_strip.py::LAYOUTS mirrors them.
constexpr int kLayouts = 2;
constexpr int kLayoutK[kLayouts] = {128, 192};
constexpr int kLayoutG[kLayouts] = {32, 48};

// the index of the narrowest layout that holds bottleneck K and growth G,
// or -1 past the widest
inline int layer_layout(int K, int G) {
  for (int i = 0; i < kLayouts; ++i)
    if (K <= kLayoutK[i] && G <= kLayoutG[i]) return i;
  return -1;
}

// The whole H x W image of cmax channels at img, NHWC (T: float or
// __nv_bfloat16, the bf16 body's too).
template <typename T>
struct ImageFrame {
  T* img;
  int H, W, cmax;
  __device__ __forceinline__ bool inside(int y, int x) const {
    return y >= 0 && y < H && x >= 0 && x < W;
  }
  // channel 0 of pixel (y, x)
  __device__ __forceinline__ T* at(int y, int x) const {
    return img + (static_cast<int64_t>(y) * W + x) * cmax;
  }
};

template <int TH, int TW, int KMax, int GMax>
struct LayerTile {
  static constexpr int kKS = KMax + 2;                // y2 row stride
  static constexpr int kKPass = KMax <= 128 ? KMax : KMax / 2;  // 1x1 columns a pass
  static constexpr int kPasses = KMax / kKPass;
  static constexpr int kKT = kKPass / 16;             // a thread's columns a pass
  static constexpr int kGT = GMax / 8;                // a thread's 3x3 channels
  static_assert(kKPass % 16 == 0 && kPasses * kKPass == KMax && GMax % 8 == 0,
                "16 threads over a pass's columns, 8 over G");
  static constexpr int kHW = TW + 2;                  // halo columns
  static constexpr int kHalo = (TH + 2) * kHW;        // halo pixels
  static constexpr int kNP = (kHalo + 15) / 16 * 16;  // padded to 16 x kPI
  static constexpr int kPI = kNP / 16;                // 1x1 pixels per thread
  static constexpr int kNPS = kNP + 1;                // odd stride: conflict-free staging
  static constexpr int kOut = TH * TW;
  static constexpr int kOI = (kOut + 31) / 32;        // 3x3 pixels per thread
  static constexpr int kStageFloats =
      (kCK * kNPS + kCK * kKPass) > (KMax * GMax) ? (kCK * kNPS + kCK * kKPass)
                                                  : (KMax * GMax);
  static_assert(kOut <= 128 && kNP <= 192, "tile too large for the register plan");
  static constexpr size_t kSmem = (kStageFloats + kHalo * kKS) * sizeof(float);
  static_assert(kSmem <= 232448, "a block's shared memory");
};

// The layer over the tile whose top-left output pixel is (y0, x0) of the
// pixels of `frame` (a Frame as above: inside(y, x) and at(y, x)). Layer-sliced
// operands: g1, b1 (cmax) and w1 (cmax, K) from the layer's row, g2, b2 (K),
// w3 (3, 3, K, G), with K <= KMax and G <= GMax. Ends with a barrier, so a
// block may call it again at once for another tile.
template <int TH, int TW, int KMax, int GMax, typename Frame>
__device__ __forceinline__ void dense_layer_tile(
    unsigned char* smem_raw, const Frame& frame, int width, int K, int G,
    int y0, int x0, const float* __restrict__ g1, const float* __restrict__ b1,
    const float* __restrict__ w1, const float* __restrict__ g2,
    const float* __restrict__ b2, const float* __restrict__ w3) {
  using Tile = LayerTile<TH, TW, KMax, GMax>;
  constexpr int kHW = Tile::kHW;
  constexpr int kHalo = Tile::kHalo;
  constexpr int kNP = Tile::kNP;
  constexpr int kPI = Tile::kPI;
  constexpr int kNPS = Tile::kNPS;
  constexpr int kKS = Tile::kKS;
  constexpr int kKPass = Tile::kKPass;
  constexpr int kKT = Tile::kKT;
  float* stage = reinterpret_cast<float*>(smem_raw);
  float* acts = stage;                       // [kCK][kNPS]
  float* w1s = stage + kCK * kNPS;           // [kCK][kKPass]
  float* w3s = stage;                        // [KMax][GMax], after the 1x1
  float* y2s = stage + Tile::kStageFloats;   // [kHalo][kKS]

  const int tid = threadIdx.x;

  // ---- 1x1 over the halo: pixels tp + 16 i, channels kb + tk + 16 j ----
  const int tk = tid % 16;
  const int tp = tid / 16;
  for (int kb = 0; kb < KMax; kb += kKPass) {
    float acc[kPI][kKT];
#pragma unroll
    for (int i = 0; i < kPI; ++i)
#pragma unroll
      for (int j = 0; j < kKT; ++j) acc[i][j] = 0.f;

    for (int c0 = 0; c0 < width; c0 += kCK) {
      for (int e = tid; e < kNP * kCK; e += kLayerThreads) {
        const int p = e / kCK;
        const int kk = e % kCK;
        const int c = c0 + kk;
        float v = 0.f;
        if (p < kHalo && c < width) {
          const int gy = y0 - 1 + p / kHW;
          const int gx = x0 - 1 + p % kHW;
          if (frame.inside(gy, gx)) {
            v = fmaxf(fmaf(frame.at(gy, gx)[c], g1[c], b1[c]), 0.f);
          }
        }
        acts[kk * kNPS + p] = v;
      }
      for (int e = tid; e < kCK * kKPass; e += kLayerThreads) {
        const int kk = e / kKPass;
        const int k = kb + e % kKPass;
        const int c = c0 + kk;
        w1s[e] = (c < width && k < K) ? w1[static_cast<int64_t>(c) * K + k] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kCK; ++kk) {
        float av[kPI], wv[kKT];
#pragma unroll
        for (int i = 0; i < kPI; ++i) av[i] = acts[kk * kNPS + tp + 16 * i];
#pragma unroll
        for (int j = 0; j < kKT; ++j) wv[j] = w1s[kk * kKPass + tk + 16 * j];
#pragma unroll
        for (int i = 0; i < kPI; ++i)
#pragma unroll
          for (int j = 0; j < kKT; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
      }
      __syncthreads();
    }

    // ---- BN2 + ReLU + the image mask -> y2 in shared memory -------------
#pragma unroll
    for (int i = 0; i < kPI; ++i) {
      const int p = tp + 16 * i;
      if (p >= kHalo) continue;
      const int gy = y0 - 1 + p / kHW;
      const int gx = x0 - 1 + p % kHW;
      const bool inside = frame.inside(gy, gx);
#pragma unroll
      for (int j = 0; j < kKT; ++j) {
        const int k = kb + tk + 16 * j;
        if (k >= K) continue;
        const float v = inside ? fmaxf(fmaf(acc[i][j], g2[k], b2[k]), 0.f) : 0.f;
        y2s[p * kKS + k] = v;
      }
    }
  }

  // ---- 3x3 over y2: output pixels tq + 32 i, channels tg + 8 j ---------
  const int tg = tid % 8;
  const int tq = tid / 8;
  int base[Tile::kOI];
#pragma unroll
  for (int i = 0; i < Tile::kOI; ++i) {
    const int o = tq + 32 * i;
    const int oc = o < Tile::kOut ? o : 0;   // a slot past the tile reads in range
    base[i] = (oc / TW) * kHW + (oc % TW);
  }
  constexpr int kGT = Tile::kGT;
  float acc2[Tile::kOI][kGT];
#pragma unroll
  for (int i = 0; i < Tile::kOI; ++i)
#pragma unroll
    for (int j = 0; j < kGT; ++j) acc2[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();  // y2s complete (tap 0) / w3s free (later taps)
    const float* w3t = w3 + static_cast<int64_t>(tap) * K * G;
    for (int e = tid; e < KMax * GMax; e += kLayerThreads) {
      const int k = e / GMax;
      const int g = e % GMax;
      w3s[e] = (k < K && g < G) ? w3t[k * G + g] : 0.f;
    }
    __syncthreads();
    const int shift = (tap / 3) * kHW + (tap % 3);
    for (int k = 0; k < K; ++k) {
      float wv[kGT], yv[Tile::kOI];
#pragma unroll
      for (int j = 0; j < kGT; ++j) wv[j] = w3s[k * GMax + tg + 8 * j];
#pragma unroll
      for (int i = 0; i < Tile::kOI; ++i) yv[i] = y2s[(base[i] + shift) * kKS + k];
#pragma unroll
      for (int i = 0; i < Tile::kOI; ++i)
#pragma unroll
        for (int j = 0; j < kGT; ++j) acc2[i][j] = fmaf(yv[i], wv[j], acc2[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < Tile::kOI; ++i) {
    const int o = tq + 32 * i;
    const int gy = y0 + o / TW;
    const int gx = x0 + o % TW;
    if (o >= Tile::kOut || !frame.inside(gy, gx)) continue;
    float* dst = frame.at(gy, gx) + width;
#pragma unroll
    for (int j = 0; j < kGT; ++j) {
      const int g = tg + 8 * j;
      if (g < G) dst[g] = acc2[i][j];
    }
  }
  __syncthreads();  // w3s (aliasing the next tile's staging) and y2s free
}

}  // namespace
