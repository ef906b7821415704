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
//   w     float32: (Cout, Ca+Cb) float, the 1x1 conv weight in torch's (O, I)
//         order; bfloat16: (Ca+Cb, N_pad) bf16, packed by
//         ops/fused.py::pack_fuse_weights (W transposed, N_pad = Cout rounded
//         up to 16, zeros in the pad columns)
//   out   (R, Cout)      T
//
// What bounds it on an H100: at the serving shape (Ca = Cb = Cout = 128,
// R = 384 * batch; 98,304 rows at batch 256) one call moves 75.5 MB in bf16
// and does 6.4 GFLOP, about 85 FLOP per byte. That is below the card's bf16
// ridge of about 295 FLOP/byte, so it is bound by memory (0.0226 ms): a
// block computes all of Cout for its rows, so a and b are read once, and the
// weight stays on chip.
//
// ---- bfloat16: the tensor-core body (concat_bn_relu_conv1x1_mma_kernel) ----
//
// A GEMM out = an @ W on mma.sync m16n8k16 (bf16 in, f32 accumulation) whose
// A operand is normalized in shared memory on its way in:
//   * persistent blocks, one an SM (the grid's x), each looping over the row
//     tiles x, x + gridDim.x, ... of 128 rows; the grid's y splits N into
//     slices of BN = 128 columns (64 where the weight of 128 would not fit),
//     one slice at Cout <= 128, two at 256, so a and b are read once per
//     slice: once at 128 -> 128, twice at 1280x1920's 256 -> 256 (9,600
//     rows, 2 x 9.8 MB, mostly from L2);
//   * W stays resident: the block's (K_p, BN) slice of the packed weight is
//     staged into shared memory once per block by cp.async, before the
//     first tile, not once per tile (768 tiles at b256 would pull 64 KB
//     each from L2, as many bytes as A). K_p pads Ca and Cb each to a
//     multiple of 32 with zero rows, so a K chunk never straddles a and b;
//   * A goes through a 5-stage cp.async ring of 128 x 32 K chunks (8 KB, two
//     16-byte pieces a thread), four chunks (32 KB) in flight an SM. The
//     chunks run on across tiles, so the next tile's loads overlap this
//     tile's last MMAs and its epilogue;
//   * the prologue runs in shared memory: once its own copies of a chunk
//     have landed, each thread applies x * gamma[k] + beta[k] (a multiply,
//     then an add: the plain version's two roundings in f32, no fma),
//     ReLU, and one rounding to bf16 to the 16-byte pieces it copied, before
//     the one barrier a chunk that hands the stage to ldmatrix. gamma and
//     beta for all of K_p live in shared memory in f32 (zeros in the K
//     padding, so a padded column normalizes to 0);
//   * warps: 4 over M x 2 over N, 32 rows x BN / 2 columns each: 2 m16 x 8 n8
//     tiles at BN = 128 (64 f32 accumulators a thread), 2 x 4 at 64. Per k16
//     step a warp loads 2 A fragments (ldmatrix) and BN / 32 B fragment
//     pairs (ldmatrix.trans) for 2 * BN / 8 MMAs; an n16 pair past N_pad is
//     skipped;
//   * epilogue: the accumulators rounded once to bf16 into a 128 x BN tile in
//     shared memory, then 16-byte coalesced stores of the NHWC rows, the
//     ragged last tile masked (its rows beyond R load as zeros by cp.async's
//     zero fill and are never stored).
// Row strides: A stage 40 bf16 (80 B), W and the output tile BN + 8 (272 or
// 144 B), so ldmatrix's 8 rows fall on 8 different 16-byte bank groups.
// Shared memory: K_p (BN + 8) 2 B of weight + 5 x 128 x 40 x 2 B = 51,200 of
// ring + 128 (BN + 8) 2 B of output tile + 8 K_p of gamma and beta:
// 157,696 B at 128 + 128 -> 128 and 229,376 B at 256 + 256 -> 256 (BN 128);
// 225,280 B at 512 + 512 -> 512 (BN 64). The tensor-core body takes Ca, Cb
// and Cout that are multiples of 8, 16-byte-aligned a, b, out and packed
// weight, and K_p up to 512 (BN 128) or 1,056 (BN 64): every fuse of the
// DenseNets the repo builds before block 4, and DenseNet-121's at block 4.
// The C entry picks the CUDA-core body below for any other bf16 call, by
// these shapes and alignments alone, never on a failure.
//
// ---- float32 (and bf16 at other widths): the CUDA-core body -----------------
//
// concat_bn_relu_conv1x1_kernel, float32 the check type: one 256-thread block
// per 64x64 output tile. The K loop stages a 64x32 chunk of the (virtual)
// concat into shared memory, applying the BN fold and ReLU in f32 on the way
// in (the prologue), and a 32x64 chunk of W beside it. Each thread
// accumulates a 4x4 sub-tile in f32 registers and rounds once on the store.
// Every edge (R, Ca, Cb, Cout not multiples of the tile) is masked, so any
// shape is taken. W is read through its strides: (Ca+Cb, 1) over (n, k) for
// float32's (Cout, Ca+Cb), (1, N_pad) for bf16's packed weight.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#include "dtype.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kBM = 64;       // output rows per block
constexpr int kBN = 64;       // output channels per block
constexpr int kBK = 32;       // K chunk staged per step
constexpr int kThreads = 256; // 16 x 16 threads, 4x4 outputs each

template <typename T>
__global__ void __launch_bounds__(kThreads)
concat_bn_relu_conv1x1_kernel(const T* __restrict__ a, const T* __restrict__ b,
                              const float* __restrict__ gamma,
                              const float* __restrict__ beta,
                              const T* __restrict__ w, T* __restrict__ out,
                              int64_t rows, int ca, int cb, int cout, int w_n, int w_k) {
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
                       ? to_f32(w[static_cast<int64_t>(n) * w_n + static_cast<int64_t>(k) * w_k])
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
            const void* w, void* out, int64_t rows, int ca, int cb, int cout, int w_n,
            int w_k, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((rows + kBM - 1) / kBM),
                  static_cast<unsigned>((cout + kBN - 1) / kBN));
  concat_bn_relu_conv1x1_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const T*>(w), static_cast<T*>(out), rows, ca, cb, cout, w_n, w_k);
}

// ---- bfloat16: the tensor-core body -----------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;                   // rows per tile
constexpr int kBK = 32;                    // K per chunk: two k16 steps
constexpr int kStages = 5;                 // chunks in the cp.async ring
constexpr int kAS = kBK + 8;               // A stage row stride: conflict-free ldmatrix
constexpr int kThreads = 256;              // 8 warps: 4 over M x 2 over N
constexpr int kPieces = kBM * kBK / 8 / kThreads;   // a chunk's 16-byte pieces a thread: 2
constexpr size_t kSmemMax = 232448;        // the most a block may have
static_assert(kPieces * kThreads * 8 == kBM * kBK && kBK / 8 == 4, "4 pieces a chunk row");

// Ca or Cb padded to whole K chunks
__host__ __device__ constexpr int pad_k(int c) { return (c + kBK - 1) / kBK * kBK; }

template <int BN>
size_t smem_bytes(int kp) {
  return size_t(kp) * (BN + 8) * sizeof(bf16) + size_t(kStages) * kBM * kAS * sizeof(bf16) +
         size_t(kBM) * (BN + 8) * sizeof(bf16) + size_t(kp) * 2 * sizeof(float);
}

// The N slice the tensor-core body takes for these widths, or 0 for the
// CUDA-core body: widths that are multiples of 8, and a weight slice that
// fits shared memory at 128 columns (where Cout > 64), else at 64.
int tile_n(int ca, int cb, int cout) {
  if (ca % 8 || cb % 8 || cout % 8) return 0;
  const int kp = pad_k(ca) + pad_k(cb);
  if (cout > 64 && smem_bytes<128>(kp) <= kSmemMax) return 128;
  return smem_bytes<64>(kp) <= kSmemMax ? 64 : 0;
}

// The note at the top: persistent blocks over 128-row tiles, the weight
// slice resident, A through a cp.async ring with BN + ReLU applied in shared
// memory, mma.sync, a staged epilogue.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
concat_bn_relu_conv1x1_mma_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                                  const float* __restrict__ gamma,
                                  const float* __restrict__ beta,
                                  const bf16* __restrict__ wp, bf16* __restrict__ out,
                                  int64_t rows, int ca, int cb, int cout) {
  constexpr int kBS = BN + 8;              // weight and output-tile row stride
  constexpr int kWN = BN / 2;              // columns a warp
  constexpr int kNT = kWN / 8;             // n8 tiles a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ka = pad_k(ca), kp = ka + pad_k(cb);
  const int npad = (cout + 15) & ~15;
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);                  // [kp][kBS]
  bf16* ring = ws + kp * kBS;                                     // [kStages][kBM][kAS]
  bf16* tile_out = ring + kStages * kBM * kAS;                    // [kBM][kBS]
  float* gs = reinterpret_cast<float*>(tile_out + kBM * kBS);     // [kp]
  float* bs = gs + kp;                                            // [kp]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.y * BN;          // the block's first output column
  const int64_t tiles = (rows + kBM - 1) / kBM;
  const int my_tiles =
      tiles > blockIdx.x ? static_cast<int>((tiles - 1 - blockIdx.x) / gridDim.x) + 1 : 0;
  const int nk = kp / kBK;                 // chunks a tile
  const int total = my_tiles * nk;

  // smem row r of K_p <- row g of the packed weight / gamma / beta, or -1 (a zero row)
  auto k_row = [&](int r) {
    return r < ka ? (r < ca ? r : -1) : (r - ka < cb ? ca + r - ka : -1);
  };

  // ---- the weight slice (one cp.async group), gamma and beta, once ----------
  for (int e = tid; e < kp * (BN / 8); e += kThreads) {
    const int r = e / (BN / 8);
    const int col = n0 + 8 * (e - r * (BN / 8));
    const int g = k_row(r);
    const bool valid = g >= 0 && col < npad;
    cp_async16(ws + r * kBS + (col - n0), valid ? wp + static_cast<int64_t>(g) * npad + col : wp,
               valid);
  }
  cp_async_commit();
  for (int r = tid; r < kp; r += kThreads) {
    const int g = k_row(r);
    gs[r] = g >= 0 ? gamma[g] : 0.f;
    bs[r] = g >= 0 ? beta[g] : 0.f;
  }

  // ---- chunk c of the block's stream: tile c / nk, K chunk c % nk ------------
  auto row0_of = [&](int lt) {
    return static_cast<int64_t>(blockIdx.x + static_cast<int64_t>(lt) * gridDim.x) * kBM;
  };
  auto load = [&](int c) {
    if (c < total) {
      const int lt = c / nk;
      const int k0 = (c - lt * nk) * kBK;
      const int64_t row0 = row0_of(lt);
      const bool in_a = k0 < ka;
      const bf16* src = in_a ? a : b;
      const int width = in_a ? ca : cb;
      const int col0 = in_a ? k0 : k0 - ka;
      bf16* st = ring + (c % kStages) * kBM * kAS;
#pragma unroll
      for (int i = 0; i < kPieces; ++i) {
        const int p = thread_index() + i * kThreads;
        const int r = p >> 2;
        const int col = col0 + 8 * (p & 3);
        const bool valid = row0 + r < rows && col < width;
        cp_async16(st + r * kAS + 8 * (p & 3), valid ? src + (row0 + r) * width + col : src,
                   valid);
      }
    }
    cp_async_commit();
  };
  // BN + ReLU, rounded once to bf16, on this thread's own pieces of chunk c
  auto prologue = [&](int c) {
    const int lt = c / nk;
    const int k0 = (c - lt * nk) * kBK;
    const int64_t row0 = row0_of(lt);
    bf16* st = ring + (c % kStages) * kBM * kAS;
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      const int p = thread_index() + i * kThreads;
      const int r = p >> 2;
      if (row0 + r >= rows) continue;
      const int k = k0 + 8 * (p & 3);
      uint4* piece = reinterpret_cast<uint4*>(st + r * kAS + 8 * (p & 3));
      uint4 v = *piece;
      float g[8], be[8];
      *reinterpret_cast<float4*>(g) = *reinterpret_cast<const float4*>(gs + k);
      *reinterpret_cast<float4*>(g + 4) = *reinterpret_cast<const float4*>(gs + k + 4);
      *reinterpret_cast<float4*>(be) = *reinterpret_cast<const float4*>(bs + k);
      *reinterpret_cast<float4*>(be + 4) = *reinterpret_cast<const float4*>(bs + k + 4);
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float2 x = __bfloat1622float2(pairs(v)[h]);
        const float y0 = fmaxf(__fadd_rn(__fmul_rn(x.x, g[2 * h]), be[2 * h]), 0.f);
        const float y1 = fmaxf(__fadd_rn(__fmul_rn(x.y, g[2 * h + 1]), be[2 * h + 1]), 0.f);
        pairs(v)[h] = __floats2bfloat162_rn(y0, y1);
      }
      *piece = v;
    }
  };

  for (int c = 0; c < kStages - 1; ++c) load(c);
  __syncthreads();                         // gamma and beta staged

  const int wm = warp & 3;                 // rows 32 wm + [0, 32) of the tile
  const int wcol = (warp >> 2) * kWN;      // columns wcol + [0, kWN) of the slice
  const int arow = lane & 15;              // the lane's ldmatrix row
  const int acol = (lane >> 4) * 8;        // and column
  // the warp's n16 pairs that hold columns below N_pad
  const int live = min(max((npad - n0 - wcol) / 16, 0), kNT / 2);
  float acc[2][kNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int t = 0; t < kNT; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][t][q] = 0.f;

  for (int c = 0; c < total; ++c) {
    cp_async_wait<kStages - 2>();          // this thread's copies of chunk c landed
    prologue(c);
    __syncthreads();                       // chunk c normalized; chunk c - 1's stage free
    load(c + kStages - 1);
    const int lt = c / nk;
    const int j = c - lt * nk;
    const bf16* st = ring + (c % kStages) * kBM * kAS;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) ldsm_x4(af[i], st + (wm * 32 + i * 16 + arow) * kAS + ks * 16 + acol);
      const bf16* wrow = ws + (j * kBK + ks * 16 + arow) * kBS + wcol + acol;
#pragma unroll
      for (int pr = 0; pr < kNT / 2; ++pr) {
        if (pr >= live) break;
        uint32_t bf[4];
        ldsm_x4_trans(bf, wrow + 16 * pr);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * pr], af[i], bf[0], bf[1]);
          mma_bf16(acc[i][2 * pr + 1], af[i], bf[2], bf[3]);
        }
      }
    }
    if (j != nk - 1) continue;

    // ---- the tile's epilogue: one rounding, staged, 16-byte stores -----------
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        bf16* o = tile_out + (wm * 32 + i * 16 + (lane >> 2)) * kBS + wcol + 8 * t + 2 * (lane & 3);
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(acc[i][t][0], acc[i][t][1]);
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * kBS) =
            __floats2bfloat162_rn(acc[i][t][2], acc[i][t][3]);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][t][q] = 0.f;
      }
    __syncthreads();                       // the output tile complete
    const int64_t row0 = row0_of(lt);
    const int nvec = min(BN, cout - n0) / 8;
    for (int e = thread_index(); e < kBM * nvec; e += kThreads) {
      const int r = e / nvec;
      const int v = e - r * nvec;
      if (row0 + r < rows)
        *reinterpret_cast<uint4*>(out + (row0 + r) * cout + n0 + 8 * v) =
            *reinterpret_cast<const uint4*>(tile_out + r * kBS + 8 * v);
    }
    // the next write of tile_out comes after the next chunk's barrier
  }
  cp_async_wait<0>();
}

template <int BN>
int run(const void* a, const void* b, const float* gamma, const float* beta, const void* wp,
        void* out, int64_t rows, int ca, int cb, int cout, cudaStream_t s) {
  const int kp = pad_k(ca) + pad_k(cb);
  const size_t smem = smem_bytes<BN>(kp);
  cudaError_t err = cudaFuncSetAttribute(concat_bn_relu_conv1x1_mma_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  const int slices = (((cout + 15) & ~15) + BN - 1) / BN;
  const int64_t tiles = (rows + kBM - 1) / kBM;
  const int blocks = static_cast<int>(std::min<int64_t>(tiles, std::max(1, sms / slices)));
  concat_bn_relu_conv1x1_mma_kernel<BN><<<dim3(blocks, slices), kThreads, smem, s>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), gamma, beta,
      static_cast<const bf16*>(wp), static_cast<bf16*>(out), rows, ca, cb, cout);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace tc

}  // namespace

// dtype: 0 = float32, with w the (Cout, Ca+Cb) float weight; 1 = bfloat16,
// with w the packed (Ca+Cb, N_pad) bf16 weight. bfloat16 runs the
// tensor-core body where tc::tile_n takes the widths and a, b, w and out are
// 16-byte aligned, else the CUDA-core body (chosen by shape and alignment
// alone, never on a failure). Returns the cudaError_t of the
// launch (0 on success). Launches on `stream` and does not synchronise.
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
  const float* g = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  switch (dtype) {
    case 0:
      launch<float>(a, b, gamma, beta, w, out, rows, ca, cb, cout, ca + cb, 1, s);
      break;
    case 1: {
      const int bn = tc::tile_n(ca, cb, cout);
      const bool aligned =
          tc::aligned16(a) && tc::aligned16(b) && tc::aligned16(w) && tc::aligned16(out);
      if (bn == 128 && aligned) return tc::run<128>(a, b, g, be, w, out, rows, ca, cb, cout, s);
      if (bn == 64 && aligned) return tc::run<64>(a, b, g, be, w, out, rows, ca, cb, cout, s);
      launch<__nv_bfloat16>(a, b, gamma, beta, w, out, rows, ca, cb, cout, 1,
                            (cout + 15) & ~15, s);
      break;
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The N slice of the bf16 tensor-core body for these widths (128 or 64), or
// 0 where a bf16 call runs the CUDA-core body.
extern "C" int dmm_concat_bn_relu_conv1x1_tile_n(int ca, int cb, int cout) {
  return ca < 0 || cb < 0 || cout <= 0 ? 0 : tc::tile_n(ca, cb, cout);
}

// The bf16 tensor-core body's dynamic shared memory per block for these
// widths (0 where it does not take them).
extern "C" int dmm_concat_bn_relu_conv1x1_mma_smem(int ca, int cb, int cout) {
  const int bn = dmm_concat_bn_relu_conv1x1_tile_n(ca, cb, cout);
  const int kp = tc::pad_k(ca) + tc::pad_k(cb);
  return static_cast<int>(bn == 128 ? tc::smem_bytes<128>(kp)
                                    : bn == 64 ? tc::smem_bytes<64>(kp) : 0);
}
