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
// (1 byte); at the serving shape (8, 256, 256, 64) f32 that is 168 MB, 0.050
// ms at 3.35 TB/s. Design: a thread makes 16 output bytes (one 16-byte
// store); when c == cp its 16 inputs are contiguous and 16-byte aligned and
// are read as 4 float4 (f32) or 2 uint4 (bf16) loads, else one by one.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInv127 = 0x1.020408p-7f;  // f32(1/127) = 0.00787401572, bits 0x3c010204

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int8_t quant(float v, float scale) {
  float r = rintf(__fdiv_rn(v, scale));
  r = fminf(fmaxf(r, -127.f), 127.f);
  return (int8_t)__float2int_rn(r);
}

template <typename T, bool VEC>
__global__ void quantize_kernel(const T* __restrict__ x, const float* __restrict__ amax,
                                int8_t* __restrict__ q, long long groups, int c, int cp) {
  const float scale = __fmul_rn(fmaxf(__ldg(amax), 1e-12f), kInv127);
  const int per_pixel = cp / 16;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < groups;
       i += (long long)gridDim.x * blockDim.x) {
    const long long p = i / per_pixel;
    const int c0 = (int)(i % per_pixel) * 16;
    alignas(16) int8_t v[16];
    if (VEC) {
      alignas(16) T in[16];
      const uint4* src = reinterpret_cast<const uint4*>(x + p * c + c0);
      uint4* dst = reinterpret_cast<uint4*>(in);
#pragma unroll
      for (int k = 0; k < (int)(16 * sizeof(T) / 16); ++k) dst[k] = __ldg(src + k);
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = quant(to_f32(in[j]), scale);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int ch = c0 + j;
        v[j] = ch < c ? quant(to_f32(x[p * c + ch]), scale) : (int8_t)0;
      }
    }
    *reinterpret_cast<int4*>(q + p * cp + c0) = *reinterpret_cast<const int4*>(v);
  }
}

template <typename T>
int launch_quantize(const T* x, const float* amax, int8_t* q, long long npix, int c, int cp,
                    void* stream) {
  if (npix == 0) return 0;
  if (cp % 32 != 0 || cp < c) return (int)cudaErrorInvalidValue;
  const long long groups = npix * (cp / 16);
  const int threads = 256;
  long long blocks = (groups + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 blocks an SM
  cudaStream_t s = (cudaStream_t)stream;
  if (c == cp && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    quantize_kernel<T, true><<<(unsigned)blocks, threads, 0, s>>>(x, amax, q, groups, c, cp);
  else
    quantize_kernel<T, false><<<(unsigned)blocks, threads, 0, s>>>(x, amax, q, groups, c, cp);
  return (int)cudaGetLastError();
}

}  // namespace

// x (npix, c) f32 NHWC, amax a device scalar, q (npix, cp) int8 NHWC; contiguous.
extern "C" int disco_quantize(const float* x, const float* amax, int8_t* q, long long npix, int c,
                              int cp, void* stream) {
  return launch_quantize(x, amax, q, npix, c, cp, stream);
}

// The bf16 instance: x (npix, c) bf16.
extern "C" int disco_quantize_bf16(const __nv_bfloat16* x, const float* amax, int8_t* q,
                                   long long npix, int c, int cp, void* stream) {
  return launch_quantize(x, amax, q, npix, c, cp, stream);
}
