// Kernel I: per-tensor symmetric int8 quantization of an NHWC activation.
//
// The JAX package leaves this to XLA (ops/quant.py::quantize_activation,
// inside int8_conv before every quantized convolution; no Pallas kernel):
//   scale = max(amax, 1e-12) / 127
//   q     = clip(round(x.astype(f32) / scale), -127, 127).astype(int8)
// with round half to even. XLA compiles the division by the constant 127 as a
// multiply by f32(1/127) (the jitted graph on the CPU, as the JAX Colorizer
// and command line run it), and keeps x / scale a division; so does this
// kernel: scale = __fmul_rn(fmaxf(amax, 1e-12f), f32(1/127)), then
// rintf(__fdiv_rn(x, scale)), no fast math. scale is computed on the card from
// a device pointer to amax (the calibrated act_amax * 1.1 or a live max|x|),
// so no value crosses to the host, and q equals the plain version's
// (ops/quant.py::quantize_activation_plain) and JAX's bit for bit.
//
// The output has cp channels, c rounded up to a multiple of 32 and the rest
// zero, so that kernel H's TMA boxes (int8_conv.cu) see byte strides that are
// multiples of 16 and K slices of 32, 64 or 128 bytes; the enhancer's first
// convolution has c = 65 (1 + d_model), cp = 96.
//
// Bound: bytes. x is read once (4 or 2 bytes a value) and q written once
// (1 byte, padding included); at the serving shape (8, 256, 256, 64) f32 that
// is 168 MB, 0.050 ms at 3.35 TB/s. So:
//  * The rounding takes a multiply by the reciprocal, a clip and a rintf; the
//    division runs only for a group of values of which one lies within 2^-13
//    of a half-integer (near_rint below: the same bits, proven there and
//    checked on 1.8e8 values and every card test).
//  * The vector path (c == cp, x 16-byte aligned): 64 input bytes in flight a
//    thread (4 float4, or 4 uint4 of bf16 for two groups of 16 values), the
//    bytes packed in registers (byte_perm) and stored 16 at a time.
//  * Otherwise (c = 65, 1 + d_model, the enhancer's first convolution; views
//    at odd offsets), the word path: a thread makes 4-byte output words,
//    reading each word's 4 channels with scalar loads that a warp's
//    neighbours share in L1 (64 input bytes a thread in flight), the padding
//    made in registers.
// Both paths run one grid sized to what stays resident (tile_stream.cuh).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_stream.cuh"

namespace {

constexpr float kInv127 = 0x1.020408p-7f;  // f32(1/127) = 0.00787401572, bits 0x3c010204
constexpr int kThreads = 256;
constexpr long long kKeepBytes = 48LL << 20;  // input and output bytes that stay in L2 (50 MB) together

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// The rounding, bit for bit clip(rintf(__fdiv_rn(v, scale)), -127, 127), mostly
// without the division. q = v * r, with r = __fdiv_rn(1, scale), lies within
// 2.5 ulps of __fdiv_rn(v, scale) (two roundings of relative error 2^-24 each).
// Clipping first changes nothing: clip and rint commute at integer bounds, and
// both sides of +-127.5 clip to +-127 (inf and NaN clip as the division's
// result does). So where the clipped q is more than 2^-13 (16 ulps of any
// |q| <= 127) from a half-integer, rintf(q) is the answer. near_rint returns
// rintf(q) and keeps the largest |q - rintf(q)| of a group in `worst`; a group
// where it reaches 0.5 - 2^-13 (one value in about 10^4 lies so near) is
// rounded again by the IEEE division (exact_rint), value by value.
__device__ __forceinline__ float near_rint(float v, float r, float& worst) {
  const float q = fminf(fmaxf(__fmul_rn(v, r), -127.f), 127.f);
  const float n = rintf(q);
  worst = fmaxf(worst, fabsf(__fsub_rn(q, n)));
  return n;
}

constexpr float kNear = 0x1.ffcp-2f;  // 0.5 - 2^-13

__device__ __forceinline__ float exact_rint(float v, float scale) {
  return fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f);
}

// Four integer-valued floats in [-127, 127] as their int8 bytes: n + 1.5 * 2^23
// holds n modulo 2^8 in its low byte.
__device__ __forceinline__ unsigned pack4(float a, float b, float c, float d) {
  const unsigned ua = __float_as_uint(__fadd_rn(a, 0x1.8p23f)), ub = __float_as_uint(__fadd_rn(b, 0x1.8p23f));
  const unsigned uc = __float_as_uint(__fadd_rn(c, 0x1.8p23f)), ud = __float_as_uint(__fadd_rn(d, 0x1.8p23f));
  return __byte_perm(__byte_perm(ua, ub, 0x0040), __byte_perm(uc, ud, 0x0040), 0x5410);
}

// The vector path, for c == cp and x 16-byte aligned: output byte i is input
// value i. A thread quantizes groups of 16 values (4 float4 or 2 uint4 loads,
// one 16-byte store), kGroups of them at once (f32 1, bf16 2): 64 input bytes
// in flight a thread, consecutive threads on consecutive groups. KEEP: x and q
// fit in L2 together, and x is read with the default policy, so that a later
// reader of x (a residual add) finds it there; else x streams (evict-first)
// and does not push the output out.
template <typename T, bool KEEP>
__global__ void __launch_bounds__(kThreads, 4)
quantize_vec_kernel(const T* __restrict__ x, const float* __restrict__ amax, int8_t* __restrict__ q,
                    long long groups) {
  constexpr int kGroups = 64 / (16 * (int)sizeof(T));
  constexpr int kLoads = 16 * (int)sizeof(T) / 16;  // uint4 loads a group
  const float scale = __fmul_rn(fmaxf(__ldg(amax), 1e-12f), kInv127);
  const float r = __fdiv_rn(1.f, scale);
  const long long step = (long long)gridDim.x * blockDim.x * kGroups;
  for (long long g0 = (long long)blockIdx.x * blockDim.x * kGroups + threadIdx.x; g0 < groups; g0 += step) {
    alignas(16) T in[kGroups][16];
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const long long g = g0 + (long long)u * blockDim.x;
      if (g < groups) {
        const uint4* src = reinterpret_cast<const uint4*>(x + g * 16);
#pragma unroll
        for (int k = 0; k < kLoads; ++k) reinterpret_cast<uint4*>(in[u])[k] = KEEP ? __ldg(src + k) : __ldcs(src + k);
      }
    }
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const long long g = g0 + (long long)u * blockDim.x;
      if (g < groups) {
        float n[16], worst = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) n[j] = near_rint(to_f32(in[u][j]), r, worst);
        if (worst >= kNear) {  // rare
#pragma unroll
          for (int j = 0; j < 16; ++j) n[j] = exact_rint(to_f32(in[u][j]), scale);
        }
        uint4 out;
        out.x = pack4(n[0], n[1], n[2], n[3]);
        out.y = pack4(n[4], n[5], n[6], n[7]);
        out.z = pack4(n[8], n[9], n[10], n[11]);
        out.w = pack4(n[12], n[13], n[14], n[15]);
        __stcs(reinterpret_cast<uint4*>(q + g * 16), out);
      }
    }
  }
}

// The word path (where c != cp or x is not 16-byte aligned): a thread
// makes 4-byte words of the output, word w of a pixel holding channels
// 4w..4w+3 (zeros at and past c), kWords of them at once (64 input bytes in
// flight), consecutive threads on consecutive words. Its scalar loads of a
// pixel's 4 channels, 16 bytes apart across a warp, meet in L1: each input
// byte leaves memory once.
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
quantize_word_kernel(const T* __restrict__ x, const float* __restrict__ amax, unsigned* __restrict__ q,
                     int total, int c, const FastDiv by_row) {
  constexpr int kWords = 16 / (int)sizeof(T);
  const float scale = __fmul_rn(fmaxf(__ldg(amax), 1e-12f), kInv127);
  const float r = __fdiv_rn(1.f, scale);
  const int row = by_row.d;  // output words a pixel
  for (int w0 = blockIdx.x * blockDim.x * kWords + threadIdx.x; w0 < total; w0 += gridDim.x * blockDim.x * kWords) {
    float v[kWords][4];
#pragma unroll
    for (int u = 0; u < kWords; ++u) {
      const int w = w0 + u * blockDim.x;
      const int p = by_row.div(w), ch = 4 * (w - p * row);
      const T* src = x + (long long)p * c + ch;
#pragma unroll
      for (int j = 0; j < 4; ++j) v[u][j] = w < total && ch + j < c ? to_f32(__ldg(src + j)) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kWords; ++u) {
      const int w = w0 + u * blockDim.x;
      float n[4], worst = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) n[j] = near_rint(v[u][j], r, worst);
      if (worst >= kNear) {  // rare
#pragma unroll
        for (int j = 0; j < 4; ++j) n[j] = exact_rint(v[u][j], scale);
      }
      if (w < total) __stcs(q + w, pack4(n[0], n[1], n[2], n[3]));
    }
  }
}

template <typename T>
int launch_quantize(const T* x, const float* amax, int8_t* q, long long npix, int c, int cp, void* stream) {
  if (npix == 0) return 0;
  if (c < 1 || cp % 32 != 0 || cp < c || reinterpret_cast<uintptr_t>(q) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaGetDevice(&dev);
  if (c == cp && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    const long long groups = npix * c / 16, per_block = kThreads * (64 / (16 * (long long)sizeof(T)));
    const int grid = balanced_grid((groups + per_block - 1) / per_block, 4, dev);
    if (groups * 16 * (long long)(sizeof(T) + 1) <= kKeepBytes)
      quantize_vec_kernel<T, true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(x, amax, q, groups);
    else
      quantize_vec_kernel<T, false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(x, amax, q, groups);
    return (int)cudaGetLastError();
  }
  const long long total = npix * (cp / 4);
  if (total >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const long long per_block = kThreads * (16 / (long long)sizeof(T));
  const int grid = balanced_grid((total + per_block - 1) / per_block, 4, dev);
  quantize_word_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(x, amax, reinterpret_cast<unsigned*>(q),
                                                                      (int)total, c, FastDiv(cp / 4));
  return (int)cudaGetLastError();
}

}  // namespace

// x (npix, c) f32 NHWC, amax a device scalar, q (npix, cp) int8 NHWC; contiguous.
extern "C" int disco_quantize(const float* x, const float* amax, int8_t* q, long long npix, int c, int cp,
                              void* stream) {
  return launch_quantize(x, amax, q, npix, c, cp, stream);
}

// The bf16 instance: x (npix, c) bf16.
extern "C" int disco_quantize_bf16(const __nv_bfloat16* x, const float* amax, int8_t* q, long long npix, int c,
                                   int cp, void* stream) {
  return launch_quantize(x, amax, q, npix, c, cp, stream);
}
