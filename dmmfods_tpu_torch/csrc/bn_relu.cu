// Eval BatchNorm + ReLU in one pass over an activation, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: in the JAX package XLA fuses the eval BN's
// affine transform and the ReLU into one elementwise pass. The port ran them
// as three PyTorch passes (a broadcast mul and a broadcast add in the
// activation dtype, then a ReLU) on operands folded again at every call; this
// kernel is the one pass, on (scale, shift) the model folds once per fold
// (models/dense_unet_lidar.py). It computes
//
//   out = max(0, x * scale[c] + shift[c])
//
// with x and out NCHW in shape and channels_last in memory, so (rows, C) row
// major with rows = B * H * W; scale and shift float (C); the arithmetic in
// f32 (one FMA) and one rounding to T. NaN passes through, as torch.relu's.
//
// What bounds it on an H100: bytes. It reads x once and writes out once, and
// does one FMA and one compare an element: in bf16 0.5 FLOP a byte, where
// the card needs ~295 before its tensor cores, or ~20 before its f32 units,
// are the limit. A DenseNet-121 forward at 128x192, b256, in bf16 has 142
// sites of 3,254,255,616 elements in all: 6.51 GB read and as much written,
// 3.886 ms at 3.35 TB/s; DenseNet-161 at 1280x1920, b1 (blocks 1-2 in K2,
// the head in K3), 135 sites of 1,187,712,000 elements: 1.418 ms.
//
// Design, for a pass bound by bytes:
//   * 16-byte loads and stores, V = 16 / sizeof(T) values (8 bf16, 4 f32),
//     neighbouring threads on neighbouring 16-byte vectors;
//   * a grid-stride loop over the vectors with as many threads as the card
//     holds resident at this kernel's block count (SMs x kThreadsPerSm),
//     fewer for a small tensor, rounded up to a multiple of L = C / gcd(C,
//     V). Vector v starts at element v V, of channel (v V) mod C, and a
//     stride of a multiple of L vectors is a multiple of C elements, so a
//     thread meets the same V channels at every step: it loads their scale
//     and shift once, into registers, and reads nothing but x after that;
//   * two vectors in flight a thread (v and v + stride);
//   * where C is not a multiple of V a vector spans two rows and its
//     channels wrap past C, and the fewer than V elements past the last
//     whole vector are done one at a time: any C >= 1 runs.
// x and out must start on a 16-byte boundary; the wrapper checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dtype.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kThreadsPerSm = 1024;

// V values of T in one 16-byte vector, as f32 and back
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int kV = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int kV = 8;
  static __device__ __forceinline__ float2 pair(unsigned int w) {
    __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&w);
    return __bfloat1622float2(h);
  }
  static __device__ __forceinline__ unsigned int word(float a, float b) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<unsigned int*>(&h);
  }
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    float2 p;
    p = pair(u.x); f[0] = p.x; f[1] = p.y;
    p = pair(u.y); f[2] = p.x; f[3] = p.y;
    p = pair(u.z); f[4] = p.x; f[5] = p.y;
    p = pair(u.w); f[6] = p.x; f[7] = p.y;
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(word(f[0], f[1]), word(f[2], f[3]), word(f[4], f[5]), word(f[6], f[7]));
  }
};

__device__ __forceinline__ float bn_relu1(float x, float s, float b) {
  const float y = fmaf(x, s, b);
  return y < 0.f ? 0.f : y;   // NaN stays NaN
}

template <typename T>
__device__ __forceinline__ uint4 apply(const uint4& u, const float* s, const float* b) {
  constexpr int V = Vec<T>::kV;
  float f[V];
  Vec<T>::unpack(u, f);
#pragma unroll
  for (int k = 0; k < V; ++k) f[k] = bn_relu1(f[k], s[k], b[k]);
  return Vec<T>::pack(f);
}

// threads: the grid's thread count, a multiple of L (see the top); n = rows * C
template <typename T>
__global__ void __launch_bounds__(kBlock)
bn_relu_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ shift, T* __restrict__ out, int64_t n, int C,
               int64_t threads) {
  constexpr int V = Vec<T>::kV;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (t >= threads) return;
  const int64_t nvec = n / V;
  float s[V], b[V];
  int c = static_cast<int>((t * V) % C);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    s[k] = scale[c];
    b[k] = shift[c];
    if (++c == C) c = 0;
  }
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(out);
  int64_t v = t;
  for (; v + threads < nvec; v += 2 * threads) {
    const uint4 u0 = xv[v];
    const uint4 u1 = xv[v + threads];
    ov[v] = apply<T>(u0, s, b);
    ov[v + threads] = apply<T>(u1, s, b);
  }
  if (v < nvec) ov[v] = apply<T>(xv[v], s, b);
  for (int64_t e = nvec * V + t; e < n; e += threads) {
    const int ce = static_cast<int>(e % C);
    out[e] = from_f32<T>(bn_relu1(to_f32(x[e]), scale[ce], shift[ce]));
  }
}

int gcd(int a, int b) {
  while (b) {
    const int r = a % b;
    a = b;
    b = r;
  }
  return a;
}

int sm_count(int device) {
  static int counts[64] = {};
  if (device < 0 || device >= 64) return 132;
  if (counts[device] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
        sms <= 0) {
      return 132;
    }
    counts[device] = sms;
  }
  return counts[device];
}

template <typename T>
int run(const void* x, const float* scale, const float* shift, void* out, int64_t n, int C,
        int device, cudaStream_t stream) {
  constexpr int V = Vec<T>::kV;
  const int64_t L = C / gcd(C, V);
  int64_t want = static_cast<int64_t>(sm_count(device)) * kThreadsPerSm;
  const int64_t nvec = n / V;
  if (nvec < want) want = nvec > 0 ? nvec : 1;
  const int64_t threads = (want + L - 1) / L * L;
  const int64_t blocks = (threads + kBlock - 1) / kBlock;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  bn_relu_kernel<T><<<static_cast<unsigned int>(blocks), kBlock, 0, stream>>>(
      static_cast<const T*>(x), scale, shift, static_cast<T*>(out), n, C, threads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out = max(0, x * scale[c] + shift[c]) over n = rows * C elements of a
// channels-last activation; dtype 0 float32, 1 bfloat16. Launches on
// `stream` of `device` (made current for the launch) and returns the launch's
// cudaError_t: cudaErrorInvalidValue, with nothing launched, for arguments
// it does not take (n not a multiple of C, x or out off a 16-byte boundary).
extern "C" int dmm_bn_relu(const void* x, const void* scale, const void* shift, void* out,
                           int64_t n, int C, int dtype, int device, void* stream) {
  if (n < 0 || C <= 0 || n % C != 0 || (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & 15) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const int rc = dtype == 0 ? run<float>(x, sc, sh, out, n, C, device, s)
                            : run<__nv_bfloat16>(x, sc, sh, out, n, C, device, s);
  if (current != device) cudaSetDevice(current);
  return rc;
}
