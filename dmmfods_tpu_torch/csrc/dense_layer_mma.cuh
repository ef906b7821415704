// One dense layer of a DenseNet block over one TH x TW output tile, in bf16
// on the tensor cores: the layer body of the bf16 kernels of K2
// (csrc/dense_block_strip.cu, 8x16 tiles), K4 (csrc/dense_block.cu, 8x16,
// 8x12 or 4x6) and K5 (csrc/dense_block_recompute.cu, 8x16). It computes
// what csrc/dense_layer_tile.cuh computes in f32, with BN folded into
// per-channel (gamma, beta) and width = c0 + l * G,
//
//   act = ReLU(img[..., :width] * g1 + b1)            rounded to bf16
//   y1  = act @ w1                                    f32 accumulation
//   y2  = ReLU(y1 * g2 + b2), zero outside the frame  rounded to bf16
//   img[..., width:width + G] = conv3x3(y2, w3)        f32 accumulation
//
// through a Frame (inside(y, x), at(y, x): see dense_layer_tile.cuh): K2's
// and K4's ImageFrame, K5's StripFrame. Only channels [0, width) of a pixel
// are read. Each output pixel's sums run in one order (the prefix's chunks,
// then the taps, each over K in steps of 16) whatever the tile's origin and
// whichever warp holds it, so K2 and K5 give the same bits.
//
// What bounds it on an H100: at block 1 of the 1280x1920 frame one
// DenseNet-121 block call does about 102 GFLOP (116 with the ring) and must
// move about 0.1 GB: operations, ~0.1 ms on the tensor cores (DenseNet-161's
// block 1 does 229 GFLOP, ~0.23 ms). The CUDA-core body
// (dense_layer_tile.cuh) ran at ~80x that in bf16: f32 FMAs, w1 and w3
// restaged and converted to f32 for every tile and every tap, staging and
// FMAs one after the other at one block per SM (145 registers a thread).
// This body:
//   * runs the 1x1 as a GEMM on mma.sync m16n8k16 (bf16 in, f32
//     accumulation) fed by ldmatrix: M = the tile's halo pixels padded to 16
//     rows, N = KP (the padded K), K-dimension = width in chunks of 32
//     channels; two warps over M by four over N, each warp KP / 4 columns
//     (4 n8 tiles at KP 128, 6 at KP 192);
//   * stages each chunk of the prefix with cp.async, double-buffered (the
//     next chunk's copy overlaps this chunk's products), and applies BN1 +
//     ReLU in place in shared memory (the ReLU keeps BN1 out of w1), beside
//     the chunk's 32 rows of w1 read straight in bf16;
//   * runs the 3x3 as an implicit GEMM, nine taps of (output pixels x KP)
//     @ (KP x GP), its A rows the tap's shifted pixels of y2 in shared
//     memory, the taps of w3 streamed two at a time through the freed ring.
//     Its work is dealt over the 8 warps in units of one m16 tile of output
//     pixels (padded to a multiple of 16 with rows that are computed and
//     never stored) by one n8 pair of GP, each warp's units of one m16 tile,
//     so one A fragment feeds them all. At GP 32 (two pairs): 8x16 has 8
//     m16 tiles, 16 units, each warp both pairs of one tile (K2's split);
//     8x12 has 6 m16 tiles, 12 units, warps 0-5 both pairs of one tile,
//     warps 6-7 idle; 4x6 (24 pixels) has 2 m16 tiles, 4 units, warps 0-3
//     one pair each. At GP 48 (three pairs): 8x16 24 units, each warp the
//     three pairs of one tile; 8x12 18 units on warps 0-5; 4x6 6 units,
//     warps 0-5 one pair each;
//   * needs w1 and w3 packed with K padded to KP and G to GP (zeros) by
//     ops/dense_block_strip.py::pack_layer_weights, in one of two layouts:
//     (KP, GP) = (128, 32) for every block with K <= 128 and G <= 32
//     (DenseNet-121, -169, -201), (192, 48) for the rest up to K 192 and G
//     48 (DenseNet-161's growth 48). The padded columns cost products, not
//     results, and the caller picks the layout by shape;
//   * at (128, 32) fits two 256-thread blocks on an SM (97 KB of shared
//     memory at 8x16, at most 128 registers a thread), so one block's
//     staging runs under the other's products; at (192, 48) the ring holds
//     four taps of w3 (86 KB) and y2 is 72 KB, 154 KB at 8x16: one block an
//     SM (kBlocksPerSm), with up to 255 registers for the 1x1's 144
//     accumulators a thread.
// The 1x1 is recomputed on the halo ring (180 / 128 = 1.41x at 8x16, with
// the M padding 1.5x). What bounds it now (K2 ~1 ms a block call at
// 1280x1920, 9-14x the bound; K4 0.65-2.3 ms at b256, 8-25x; K5 1.05-1.2
// ms; on an H100 at 700 W, by variants with one part removed, all at KP
// 128): no one part. Removing the BN1 pass saves 14-27%, the 1x1's MMAs
// 11-21%, the 3x3's MMAs 5-22%; the rest is the latency of each chunk's
// staging and barriers. The float32 kernels keep the CUDA-core body: f32 is
// the check type, and TF32 tensor cores would not meet its 1e-4 bound.
#pragma once

#include <stdint.h>

#include "tensor_core.cuh"

namespace {

template <int TH, int TW, int KP, int GP>
struct LayerMma {
  static constexpr int kThreads = 256;               // 8 warps
  static constexpr int kK = KP;                      // bottleneck width, padded
  static constexpr int kG = GP;                      // growth rate, padded
  static_assert(kK % 64 == 0 && kG % 16 == 0, "4 warps of n8 pairs over K, n8 pairs of G");
  static constexpr int kWN = kK / 4;                 // the 1x1's columns a warp
  static constexpr int kNT = kWN / 8;                //   in n8 tiles
  static constexpr int kHW = TW + 2;                 // halo columns
  static constexpr int kHalo = (TH + 2) * kHW;       // halo pixels: the 1x1's M
  static constexpr int kMT1 = (kHalo + 15) / 16;     // its m16 tiles
  static constexpr int kWarpMT1 = (kMT1 + 1) / 2;    // per warp: 2 warps over M
  static constexpr int kNP = kMT1 * 16;              // staged rows
  static constexpr int kOut = TH * TW;               // output pixels: the 3x3's M
  static constexpr int kMT3 = (kOut + 15) / 16;      // its m16 tiles, the last padded
  static constexpr int kUnits = kMT3 * (kG / 16);    // (m16 tile, n8 pair) units
  static constexpr int kWarpUnits = (kUnits + 7) / 8;  // per warp, all of one m16 tile
  static constexpr int kWarpsPerMT3 = (kG / 16) / kWarpUnits;  // warps sharing one
  static_assert(kMT3 <= 8, "the 3x3's m16 tiles over the 8 warps");
  static_assert((kG / 16) % kWarpUnits == 0 && kMT3 * kWarpsPerMT3 <= 8,
                "each warp's units of one m16 tile, every unit on a warp");
  static constexpr int kCK = 32;                     // prefix channels per chunk
  static constexpr int kAS = kCK + 8;                // row strides in bf16, each
  static constexpr int kWS = kK + 8;                 //   conflict-free for
  static constexpr int kGS = kG + 8;                 //   ldmatrix
  static constexpr int kActBytes = kNP * kAS * 2;
  static constexpr int kStageBytes = kActBytes + kCK * kWS * 2;
  static constexpr int kTapBytes = kK * kGS * 2;     // one tap of w3
  static constexpr int kRingBytes = 2 * kStageBytes > 4 * kTapBytes ? 2 * kStageBytes
                                                                    : 4 * kTapBytes;
  static constexpr size_t kSmem = kRingBytes + size_t(kHalo) * kWS * 2;  // + y2
  // 228 KB of shared memory an SM, 1 KB of it reserved a block: two blocks
  // where two fit (every tile at (128, 32), 4x6 at (192, 48)), else one.
  // The kernels' __launch_bounds__ take it, so a two-block body keeps to 128
  // registers a thread.
  static_assert(kSmem + 1024 <= 233472, "one block an SM");
  static constexpr int kBlocksPerSm = 2 * (kSmem + 1024) <= 233472 ? 2 : 1;
};

// What a layer call reads besides its frame and tile: the layer's width, K
// and G and its layer-sliced operands, g1, b1 (width), g2, b2 (K) in f32, w1
// (rows >= width rounded up to 32, KP) and w3 (9, KP, GP) packed in bf16.
// K2's kernel builds it from its parameters. K4's and K5's kernels, whose
// one launch walks layers and tiles, keep it (and their frame) in shared
// memory: the body reads each field where it uses it, and since every
// __syncthreads() makes the compiler load shared memory anew, it holds no
// register for them across its accumulators, which fill the 128 registers
// of two blocks an SM at (128, 32).
struct LayerArgs {
  int width, K, G;
  const float* g1;
  const float* b1;
  const __nv_bfloat16* w1;
  const float* g2;
  const float* b2;
  const __nv_bfloat16* w3;
};

// The layer over the tile whose top-left output pixel is (y0, x0) of the
// pixels of `frame`, with `args` as above. Ends with a barrier, so a block
// may call it again at once for another tile.
template <int TH, int TW, int KP, int GP, typename Frame>
__device__ __forceinline__ void dense_layer_mma(unsigned char* smem, const Frame& frame,
                                                const LayerArgs& args, int y0, int x0) {
  using bf16 = __nv_bfloat16;
  using P = LayerMma<TH, TW, KP, GP>;
  constexpr int kHW = P::kHW;
  constexpr int kHalo = P::kHalo;
  constexpr int kCK = P::kCK;
  constexpr int kAS = P::kAS;
  constexpr int kWS = P::kWS;
  constexpr int kGS = P::kGS;
  bf16* y2s = reinterpret_cast<bf16*>(smem + P::kRingBytes);   // [kHalo][kWS]

  const int tid = thread_index();
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int arow = lane & 15;             // the lane's ldmatrix row
  const int acol = (lane >> 4) * 8;       // and column
  const int nchunks = (args.width + kCK - 1) / kCK;

  // ---- the prefix's chunk j and w1's rows for it into ring slot j % 2 ------
  auto load_chunk = [&](int j) {
    const int width = args.width;
    const bf16* w1 = args.w1;
    bf16* act = reinterpret_cast<bf16*>(smem + (j & 1) * P::kStageBytes);
    bf16* w1s = reinterpret_cast<bf16*>(smem + (j & 1) * P::kStageBytes + P::kActBytes);
    const int c0 = j * kCK;
    for (int e = tid; e < P::kNP * (kCK / 8); e += P::kThreads) {
      const int p = e / (kCK / 8);
      const int c = c0 + (e % (kCK / 8)) * 8;
      bf16* dst = act + p * kAS + (c - c0);
      const int gy = y0 - 1 + p / kHW;
      const int gx = x0 - 1 + p % kHW;
      if (p >= kHalo || c >= width || !frame.inside(gy, gx)) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);   // masked below
        continue;
      }
      const bf16* g = frame.at(gy, gx) + c;
      if (c + 8 <= width && (reinterpret_cast<uintptr_t>(g) & 15) == 0) {
        cp_async16(dst, g, true);
      } else {   // a piece across width or off 16-byte alignment
        uint4 v = make_uint4(0, 0, 0, 0);
        for (int i = 0; i < 8 && c + i < width; ++i)
          reinterpret_cast<bf16*>(&v)[i] = g[i];
        *reinterpret_cast<uint4*>(dst) = v;
      }
    }
    for (int e = tid; e < kCK * (P::kK / 8); e += P::kThreads) {
      const int r = e / (P::kK / 8);
      const int v = e % (P::kK / 8);
      cp_async16(w1s + r * kWS + v * 8, w1 + static_cast<int64_t>(c0 + r) * P::kK + v * 8,
                 true);
    }
  };

  // ---- 1x1 over the halo: warp (wm, wn) -> m16 tiles wm + 2 i, columns
  // kWN wn + [0, kWN) of K: one A fragment live at a time, each B pair used
  // on all the warp's m16 tiles -------------------------------------------------
  constexpr int kWN = P::kWN;
  constexpr int kNT = P::kNT;
  const int wm = warp & 1;
  const int wn = warp >> 1;
  float acc[P::kWarpMT1][kNT][4];
#pragma unroll
  for (int i = 0; i < P::kWarpMT1; ++i)
#pragma unroll
    for (int t = 0; t < kNT; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][t][r] = 0.f;

  load_chunk(0);
  cp_async_commit();
  for (int j = 0; j < nchunks; ++j) {
    cp_async_wait<0>();                   // chunk j has landed
    __syncthreads();                      // for every thread; slot (j + 1) % 2 is free
    if (j + 1 < nchunks) load_chunk(j + 1);
    cp_async_commit();
    bf16* act = reinterpret_cast<bf16*>(smem + (j & 1) * P::kStageBytes);
    const bf16* w1s =
        reinterpret_cast<const bf16*>(smem + (j & 1) * P::kStageBytes + P::kActBytes);
    // BN1 + ReLU in place, rounded to bf16; zero off the frame and past width
    for (int e = tid; e < P::kNP * (kCK / 8); e += P::kThreads) {
      const int width = args.width;
      const float* g1 = args.g1;
      const float* b1 = args.b1;
      const int p = e / (kCK / 8);
      const int c = j * kCK + (e % (kCK / 8)) * 8;
      bf16* d = act + p * kAS + (c - j * kCK);
      if (p >= kHalo || c >= width || !frame.inside(y0 - 1 + p / kHW, x0 - 1 + p % kHW))
        continue;                         // already zero
      uint4 v = *reinterpret_cast<const uint4*>(d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(pairs(v)[i]);
        const int ca = c + 2 * i;
        const float lo = ca < width ? fmaxf(fmaf(f.x, g1[ca], b1[ca]), 0.f) : 0.f;
        const float hi = ca + 1 < width ? fmaxf(fmaf(f.y, g1[ca + 1], b1[ca + 1]), 0.f) : 0.f;
        pairs(v)[i] = __floats2bfloat162_rn(lo, hi);
      }
      *reinterpret_cast<uint4*>(d) = v;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kCK / 16; ++ks) {
      uint32_t b[kNT / 2][4];
#pragma unroll
      for (int q = 0; q < kNT / 2; ++q)
        ldsm_x4_trans(b[q], w1s + (ks * 16 + arow) * kWS + wn * kWN + 16 * q + acol);
#pragma unroll
      for (int i = 0; i < P::kWarpMT1; ++i) {
        if (wm + 2 * i >= P::kMT1) continue;
        uint32_t a[4];
        ldsm_x4(a, act + ((wm + 2 * i) * 16 + arow) * kAS + ks * 16 + acol);
#pragma unroll
        for (int q = 0; q < kNT / 2; ++q) {
          mma_bf16(acc[i][2 * q], a, b[q][0], b[q][1]);
          mma_bf16(acc[i][2 * q + 1], a, b[q][2], b[q][3]);
        }
      }
    }
  }
  __syncthreads();                        // every warp is done with the ring

  // ---- w3's taps, two at a time, into the ring's two slots ------------------
  auto load_taps = [&](int pair) {
    const bf16* w3 = args.w3;
    bf16* slot = reinterpret_cast<bf16*>(smem + (pair & 1) * 2 * P::kTapBytes);
    for (int t = 2 * pair; t < 2 * pair + 2 && t < 9; ++t)
      for (int e = tid; e < P::kK * (P::kG / 8); e += P::kThreads) {
        const int k = e / (P::kG / 8);
        const int v = e % (P::kG / 8);
        cp_async16(slot + ((t & 1) * P::kK + k) * kGS + v * 8,
                   w3 + (t * P::kK + k) * P::kG + v * 8, true);
      }
  };
  load_taps(0);
  cp_async_commit();
  load_taps(1);
  cp_async_commit();

  // ---- BN2 + ReLU + the frame mask -> y2 in shared memory ------------------
  const int K = args.K;
  const float* g2 = args.g2;
  const float* b2 = args.b2;
#pragma unroll
  for (int i = 0; i < P::kWarpMT1; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = (wm + 2 * i) * 16 + (lane >> 2) + 8 * hf;
      if (p >= kHalo) continue;
      const bool inside = frame.inside(y0 - 1 + p / kHW, x0 - 1 + p % kHW);
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        const int n = wn * kWN + t * 8 + 2 * (lane & 3);
        const float lo = (inside && n < K) ? fmaxf(fmaf(acc[i][t][2 * hf], g2[n], b2[n]), 0.f)
                                           : 0.f;
        const float hi = (inside && n + 1 < K)
                             ? fmaxf(fmaf(acc[i][t][2 * hf + 1], g2[n + 1], b2[n + 1]), 0.f)
                             : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(y2s + p * kWS + n) = __floats2bfloat162_rn(lo, hi);
      }
    }

  // ---- 3x3 over y2: warp -> m16 tile mt3 of output pixels by kWU n8 pairs
  // of G from npair0 (see the top), one A fragment for all ------------------
  constexpr int kWU = P::kWarpUnits;
  const int mt3 = warp / P::kWarpsPerMT3;
  const int npair0 = (warp % P::kWarpsPerMT3) * kWU;
  const bool live = mt3 < P::kMT3;        // else the warp waits at the barriers
  int o = mt3 * 16 + arow;                // the lane's A row: an output pixel,
  o = o < P::kOut ? o : P::kOut - 1;      //   a padded row reading a real one
  const int opix = (o / TW) * kHW + o % TW;
  float acc2[kWU][2][4];
#pragma unroll
  for (int i = 0; i < kWU; ++i)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc2[i][t][r] = 0.f;
  for (int pair = 0; pair < 5; ++pair) {
    cp_async_wait<1>();                   // this pair has landed
    __syncthreads();                      // for every thread (and y2 is complete)
    const bf16* slot = reinterpret_cast<const bf16*>(smem + (pair & 1) * 2 * P::kTapBytes);
    for (int t = 2 * pair; t < 2 * pair + 2 && t < 9; ++t) {
      const bf16* w3s = slot + (t & 1) * P::kK * kGS;
      const int shift = (t / 3) * kHW + t % 3;
      if (!live) continue;
#pragma unroll
      for (int ks = 0; ks < P::kK / 16; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, y2s + (opix + shift) * kWS + acol + ks * 16);
#pragma unroll
        for (int i = 0; i < kWU; ++i) {
          uint32_t bw[4];
          ldsm_x4_trans(bw, w3s + (ks * 16 + arow) * kGS + (npair0 + i) * 16 + acol);
          mma_bf16(acc2[i][0], a, bw[0], bw[1]);
          mma_bf16(acc2[i][1], a, bw[2], bw[3]);
        }
      }
    }
    __syncthreads();                      // the slot is free
    if (pair + 2 < 5) load_taps(pair + 2);
    cp_async_commit();
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int oo = mt3 * 16 + (lane >> 2) + 8 * hf;
    const int gy = y0 + oo / TW;
    const int gx = x0 + oo % TW;
    if (!live || oo >= P::kOut || !frame.inside(gy, gx)) continue;
    const int G = args.G;
    bf16* dst = frame.at(gy, gx) + args.width;
#pragma unroll
    for (int i = 0; i < kWU; ++i)
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int g = ((npair0 + i) * 2 + t) * 8 + 2 * (lane & 3);
        if (g < G) dst[g] = __float2bfloat16(acc2[i][t][2 * hf]);
        if (g + 1 < G) dst[g + 1] = __float2bfloat16(acc2[i][t][2 * hf + 1]);
      }
  }
  __syncthreads();                        // the ring and y2 free for the next tile
}

}  // namespace
