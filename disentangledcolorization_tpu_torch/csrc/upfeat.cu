// Kernel C: soft unpooling of superpixel tokens back to pixels.
//
// Replaces disentangledcolorization_tpu/ops/pallas_superpixel.py::upfeat (_up_kernel).
//   out[n,y,x,c] = sum_d prob[n,y,x,d] * s[n,i+dy_d,j+dx_d] * tokens[n,i+dy_d,j+dx_d,c]
// with (i, j) = (y / up_h, x / up_w), d = 0..8 the row-major offsets (-1,-1)..(1,1),
// tokens zero outside the hc x wc grid, and s an optional per-token factor
// (tok_scale; 1 where the pointer is null). Pooling's backward passes
// 1 / ((mass + 1e-8) * up_h * up_w) there, so no pass over the pixels follows
// the kernel. f32 throughout; the 9 terms are added in the order of d.
//
// Bound: bytes. It reads prob once and writes C floats per pixel (about
// 19.1 MB per 256x256 image at C=64); the token grid is tiny and stays in L2.
// Design: one block per cell. A thread owns one vector of channels (16 bytes
// where C % 4 == 0, 8 where C % 2 == 0, else 4; narrower where a pointer is
// not aligned to the vector) and holds the cell's 9 neighbour token vectors,
// already scaled, in registers for all its pixels: an output vector costs the
// pixel's 9 affinities (one address per pixel, broadcast to the threads that
// share it) and 9 x width multiply-adds. Threads run over (pixel, vector) with
// the vector fastest, so a warp stores one contiguous run (512 bytes at C=64:
// two pixels). The output exceeds L2 at every batch size of the paths and is
// not read again by this kernel: streaming stores (st.global.cs).
//
// The bf16 instance (disco_upfeat_bf16) takes bf16 tokens with the f32
// affinities (and f32 tok_scale) and writes bf16: the unpooling of the bf16
// serving forward, whose f32 sums JAX rounds to bf16 (ops/superpixel.py::
// upfeat). The sums are the f32 instance's, in the order of d, rounded once
// to nearest even (__float2bfloat16_rn, XLA's convert and torch's .to()). A
// vector holds 8 channels (16 bytes) where C % 8 == 0, so at C=64 eight
// threads share a pixel; the stores stay streaming. The output, the kernel's
// dominant traffic, halves.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vector_loads.cuh"

namespace {

constexpr int kThreads = 256;  // threads a block, at most

template <int VEC>
__device__ __forceinline__ void store_vec_streaming(float* __restrict__ p, const float (&r)[VEC]) {
  if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(r[0], r[1], r[2], r[3]));
  } else if constexpr (VEC == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(r[0], r[1]));
  } else {
    __stcs(p, r[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec_streaming(__nv_bfloat16* __restrict__ p, const float (&r)[VEC]) {
  if constexpr (VEC == 8 || VEC == 4) {
    unsigned int u[VEC / 2];  // channel pairs, the lower channel in the low half
#pragma unroll
    for (int k = 0; k < VEC / 2; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(r[2 * k], r[2 * k + 1]);
      u[k] = *reinterpret_cast<const unsigned int*>(&h);
    }
    if constexpr (VEC == 8) {
      __stcs(reinterpret_cast<uint4*>(p), make_uint4(u[0], u[1], u[2], u[3]));
    } else {
      __stcs(reinterpret_cast<uint2*>(p), make_uint2(u[0], u[1]));
    }
  } else if constexpr (VEC == 2) {
    __stcs(reinterpret_cast<__nv_bfloat162*>(p), __floats2bfloat162_rn(r[0], r[1]));
  } else {
    __stcs(p, __float2bfloat16_rn(r[0]));
  }
}

// blockDim.x threads share a pixel and split its channel vectors; blockDim.y
// pixels of the cell (row-major) are in flight at once. T: the tokens' and
// the output's type (float or __nv_bfloat16); sums are f32.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
upfeat_kernel(const T* __restrict__ tok, const float* __restrict__ tok_scale,
              const float* __restrict__ prob, T* __restrict__ out, int hc, int wc, int C,
              int up_h, int up_w) {
  const int cell = blockIdx.x;
  const int j = cell % wc;
  const int i = (cell / wc) % hc;
  const long long n = cell / (wc * hc);
  const int W = wc * up_w;
  const long long pix0 = ((n * hc + i) * up_h) * W + (long long)j * up_w;  // the cell's first pixel
  const int step_y = blockDim.y / up_w, step_x = blockDim.y % up_w;

  for (int c = threadIdx.x * VEC; c < C; c += blockDim.x * VEC) {
    float tk[9][VEC];
#pragma unroll
    for (int d = 0; d < 9; ++d) {
      const int ti = i + d / 3 - 1, tj = j + d % 3 - 1;
      if (ti >= 0 && ti < hc && tj >= 0 && tj < wc) {
        const long long at = (n * hc + ti) * wc + tj;
        load_vec<VEC>(tok + at * C + c, tk[d]);
        if (tok_scale != nullptr) {
          const float s = __ldg(tok_scale + at);
#pragma unroll
          for (int e = 0; e < VEC; ++e) tk[d][e] *= s;
        }
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) tk[d][e] = 0.f;
      }
    }
    int py = threadIdx.y / up_w, px = threadIdx.y % up_w;
    while (py < up_h) {
      const long long pix = pix0 + (long long)py * W + px;
      const float* pp = prob + pix * 9;
      float p[9];
#pragma unroll
      for (int d = 0; d < 9; ++d) p[d] = __ldg(pp + d);
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = p[0] * tk[0][e];
#pragma unroll
      for (int d = 1; d < 9; ++d) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(p[d], tk[d][e], acc[e]);
      }
      store_vec_streaming<VEC>(out + pix * C + c, acc);
      px += step_x, py += step_y;
      if (px >= up_w) px -= up_w, ++py;
    }
  }
}

template <typename T, int VEC>
int launch(const T* tok, const float* tok_scale, const float* prob, T* out, int n, int hc,
           int wc, int c, int up_h, int up_w, cudaStream_t stream) {
  const int cv = c / VEC;
  const int bx = cv < kThreads ? cv : kThreads;
  int by = kThreads / bx;
  if (by > up_h * up_w) by = up_h * up_w;
  upfeat_kernel<T, VEC><<<n * hc * wc, dim3(bx, by), 0, stream>>>(tok, tok_scale, prob, out, hc, wc, c,
                                                               up_h, up_w);
  return (int)cudaGetLastError();
}

}  // namespace

// tok (n,hc,wc,c), tok_scale (n,hc,wc) or null, prob (n,hc*up_h,wc*up_w,9),
// out (n,hc*up_h,wc*up_w,c); all f32 and contiguous.
extern "C" int disco_upfeat(const float* tok, const float* tok_scale, const float* prob, float* out,
                            int n, int hc, int wc, int c, int up_h, int up_w, void* stream) {
  if ((long long)n * hc * wc * up_h * up_w * c == 0) return 0;
  const uintptr_t bits = (uintptr_t)tok | (uintptr_t)out;  // the vector loads and stores
  cudaStream_t s = (cudaStream_t)stream;
  if (c % 4 == 0 && bits % 16 == 0) return launch<float, 4>(tok, tok_scale, prob, out, n, hc, wc, c, up_h, up_w, s);
  if (c % 2 == 0 && bits % 8 == 0) return launch<float, 2>(tok, tok_scale, prob, out, n, hc, wc, c, up_h, up_w, s);
  return launch<float, 1>(tok, tok_scale, prob, out, n, hc, wc, c, up_h, up_w, s);
}

// The same with tok (n,hc,wc,c) and out (n,hc*up_h,wc*up_w,c) bf16; tok_scale
// and prob f32.
extern "C" int disco_upfeat_bf16(const void* tok, const float* tok_scale, const float* prob, void* out, int n,
                                 int hc, int wc, int c, int up_h, int up_w, void* stream) {
  if ((long long)n * hc * wc * up_h * up_w * c == 0) return 0;
  const uintptr_t bits = (uintptr_t)tok | (uintptr_t)out;
  const __nv_bfloat16* tk = static_cast<const __nv_bfloat16*>(tok);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  if (c % 8 == 0 && bits % 16 == 0) return launch<__nv_bfloat16, 8>(tk, tok_scale, prob, o, n, hc, wc, c, up_h, up_w, s);
  if (c % 4 == 0 && bits % 8 == 0) return launch<__nv_bfloat16, 4>(tk, tok_scale, prob, o, n, hc, wc, c, up_h, up_w, s);
  if (c % 2 == 0 && bits % 4 == 0) return launch<__nv_bfloat16, 2>(tk, tok_scale, prob, o, n, hc, wc, c, up_h, up_w, s);
  return launch<__nv_bfloat16, 1>(tk, tok_scale, prob, o, n, hc, wc, c, up_h, up_w, s);
}
