// Kernel A: per-cell soft pooling statistics of the 9-neighbour superpixel affinity.
//
// Replaces disentangledcolorization_tpu/ops/pallas_superpixel.py::pool_stats
// (and ::_pool_sums, which poolfeat runs: the same sums without the hard counts).
// For every sp_h x sp_w cell (n, i, j) of the token grid it computes, in f32:
//   t[n,i,j,d,c]  = scale * sum_{p in cell} prob[p,d] * feat[p,c]
//   mass[n,i,j,d] = scale * sum_{p in cell} prob[p,d]                       (where asked for)
//   hard[n,i,j,d] = scale * #{p in cell : prob[p,d] == max_e prob[p,e]}     (where asked for)
// (ties keep every winner, as ops/superpixel.py::hard_assignment does). Pooling
// passes scale = 1 / (sp_h*sp_w); unpooling's backward passes 1 and asks for t
// alone. The 9-direction shift-add over the token grid is csrc/shift_add.cu.
//
// Bound: bytes. One read of feat (N,H,W,C) and prob (N,H,W,9) dominates (about
// 20.3 MB per 256x256 image at C=66); the 9*C multiply-adds per pixel are far
// below the card's f32 rate. Design: one block per cell.
//  - The cell's affinities are staged in shared memory row by row (a cell row
//    is sp_w*9 contiguous floats), each pixel padded to 12 floats so that three
//    16-byte loads fetch its 9 values; the index needs a division by the
//    constant 9 only.
//  - A thread owns one vector of channels (16 bytes where C % 4 == 0, 8 where
//    C % 2 == 0, else 4; narrower where feat is not aligned to the vector) and
//    every G-th pixel, with 9 x width sums in registers. The block's shape
//    follows C / width (16 x 16 at C=64, 33 x 7 at C=66), vectors fastest, so a
//    warp reads one contiguous run. kUnroll read-only vector loads are issued
//    before the first is used.
//  - The G partial sums of each (d, c) are added in a fixed order through
//    shared memory; mass and hard are 18 warp tasks (a lane adds every 32nd
//    pixel, then a shuffle tree). No atomics: the same inputs give the same bits.
//
// The bf16 instance (disco_pool_stats_bf16) reads bf16 features with the f32
// affinities and writes the same f32 outputs: the bf16 serving forward pools
// its bf16 proxy [features | ab] this way, the sums in f32 as the JAX package
// takes them (ops/superpixel.py::poolfeat promotes the operands). A thread's
// vector holds 8 channels (16 bytes) where C % 8 == 0, else 4, 2 or 1; at the
// proxy's C=66 a bf16 pixel is 132 bytes, so its vectors are 4-byte pairs
// (__nv_bfloat162), 33 threads a pixel. Bytes fall from 162 to 93 MB at batch 8.
#include <cuda_runtime.h>
#include <stdint.h>

#include "vector_loads.cuh"

namespace {

constexpr int kThreads = 256;  // threads a block; a multiple of 32
constexpr int kUnroll = 4;     // feature loads a thread has in flight
constexpr int kPad = 12;       // floats a staged pixel: 9 affinities, its winners' bit mask, 2 unused

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&r)[VEC]) {
  if constexpr (VEC == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(r[0], r[1], r[2], r[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(r[4], r[5], r[6], r[7]);
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
  } else {
    p[0] = r[0];
  }
}

// bx threads share a pixel and split its channel vectors; G pixel groups.
// T: the features' type (float or __nv_bfloat16); sums are f32.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
pool_stats_kernel(const T* __restrict__ feat, const float* __restrict__ prob,
                  float* __restrict__ t, float* __restrict__ mass, float* __restrict__ hard, int W,
                  int C, int sp_h, int sp_w, int hc, int wc, float scale, int bx, int G) {
  extern __shared__ float4 smem[];
  const int npix = sp_h * sp_w;
  float* sprob = reinterpret_cast<float*>(smem);  // npix * kPad
  float* spart = sprob + npix * kPad;             // G * 9 * C

  const int cell = blockIdx.x;
  const int j = cell % wc;
  const int i = (cell / wc) % hc;
  const long long n = cell / (wc * hc);
  const long long pix0 = ((n * hc + i) * sp_h) * W + (long long)j * sp_w;  // the cell's first pixel
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;

  for (int py = warp; py < sp_h; py += kWarps) {
    const float* src = prob + (pix0 + (long long)py * W) * 9;
    float* dst = sprob + py * sp_w * kPad;
    for (int e = lane; e < sp_w * 9; e += 32) {
      const int px = e / 9;
      dst[px * kPad + (e - px * 9)] = __ldg(src + e);
    }
  }
  __syncthreads();

  if (hard != nullptr) {  // the same for the whole block
    for (int p = tid; p < npix; p += kThreads) {
      const float* pp = sprob + p * kPad;
      float m = pp[0];
#pragma unroll
      for (int d = 1; d < 9; ++d) m = fmaxf(m, pp[d]);
      int win = 0;
#pragma unroll
      for (int d = 0; d < 9; ++d) win |= (pp[d] == m ? 1 : 0) << d;
      sprob[p * kPad + 9] = __int_as_float(win);
    }
    __syncthreads();
  }
  for (int task = warp; task < 18; task += kWarps) {
    const int d = task % 9;
    const bool count = task >= 9;
    float* dst = count ? hard : mass;
    if (dst == nullptr) continue;
    float s = 0.f;
    for (int p = lane; p < npix; p += 32) {
      const float v = sprob[p * kPad + (count ? 9 : d)];
      s += count ? (float)((__float_as_int(v) >> d) & 1) : v;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) dst[(long long)cell * 9 + d] = s * scale;
  }

  const int tx = tid % bx, ty = tid / bx;
  const int step_y = G / sp_w, step_x = G % sp_w;
  if (ty < G) {
    for (int c = tx * VEC; c < C; c += bx * VEC) {
      float acc[9][VEC];
#pragma unroll
      for (int d = 0; d < 9; ++d) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[d][e] = 0.f;
      }
      int py = ty / sp_w, px = ty % sp_w;
      for (int p = ty; p < npix; p += G * kUnroll) {
        float f[kUnroll][VEC];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (p + u * G < npix) load_vec<VEC>(feat + (pix0 + (long long)py * W + px) * C + c, f[u]);
          px += step_x, py += step_y;
          if (px >= sp_w) px -= sp_w, ++py;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (p + u * G < npix) {
            const float4* q = reinterpret_cast<const float4*>(sprob + (p + u * G) * kPad);
            const float4 a = q[0], b = q[1], cc = q[2];
            const float pr[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, cc.x};
#pragma unroll
            for (int d = 0; d < 9; ++d) {
#pragma unroll
              for (int e = 0; e < VEC; ++e) acc[d][e] = fmaf(pr[d], f[u][e], acc[d][e]);
            }
          }
        }
      }
#pragma unroll
      for (int d = 0; d < 9; ++d) store_vec<VEC>(spart + (ty * 9 + d) * C + c, acc[d]);
    }
  }
  __syncthreads();

  float* tc = t + (long long)cell * 9 * C;
  for (int e = tid; e < 9 * C; e += kThreads) {
    float s = spart[e];
    for (int g = 1; g < G; ++g) s += spart[g * 9 * C + e];
    tc[e] = s * scale;
  }
}

template <typename T, int VEC>
int launch(const T* feat, const float* prob, float* t, float* mass, float* hard, int n, int h,
           int w, int c, int sp_h, int sp_w, float scale, cudaStream_t stream) {
  const int hc = h / sp_h, wc = w / sp_w, npix = sp_h * sp_w;
  const int cv = c / VEC;
  const int bx = cv < kThreads ? cv : kThreads;
  int G = kThreads / bx;
  if (G > npix) G = npix;
  const size_t smem = sizeof(float) * ((size_t)npix * kPad + (size_t)G * 9 * c);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(pool_stats_kernel<T, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pool_stats_kernel<T, VEC><<<n * hc * wc, kThreads, smem, stream>>>(feat, prob, t, mass, hard, w, c,
                                                                  sp_h, sp_w, hc, wc, scale, bx, G);
  return (int)cudaGetLastError();
}

}  // namespace

// feat (n,h,w,c), prob (n,h,w,9), t (n,h/sp_h,w/sp_w,9,c), mass and hard
// (n,h/sp_h,w/sp_w,9) or null; all f32 and contiguous.
extern "C" int disco_pool_stats(const float* feat, const float* prob, float* t, float* mass,
                                float* hard, int n, int h, int w, int c, int sp_h, int sp_w,
                                float scale, void* stream) {
  if ((long long)n * (h / sp_h) * (w / sp_w) * c == 0) return 0;
  const uintptr_t bits = (uintptr_t)feat;  // the vector loads
  cudaStream_t s = (cudaStream_t)stream;
  if (c % 4 == 0 && bits % 16 == 0) return launch<float, 4>(feat, prob, t, mass, hard, n, h, w, c, sp_h, sp_w, scale, s);
  if (c % 2 == 0 && bits % 8 == 0) return launch<float, 2>(feat, prob, t, mass, hard, n, h, w, c, sp_h, sp_w, scale, s);
  return launch<float, 1>(feat, prob, t, mass, hard, n, h, w, c, sp_h, sp_w, scale, s);
}

// The same with feat (n,h,w,c) bf16; prob and the outputs f32.
extern "C" int disco_pool_stats_bf16(const void* feat, const float* prob, float* t, float* mass, float* hard,
                                     int n, int h, int w, int c, int sp_h, int sp_w, float scale, void* stream) {
  if ((long long)n * (h / sp_h) * (w / sp_w) * c == 0) return 0;
  const uintptr_t bits = (uintptr_t)feat;
  const __nv_bfloat16* f = static_cast<const __nv_bfloat16*>(feat);
  cudaStream_t s = (cudaStream_t)stream;
  if (c % 8 == 0 && bits % 16 == 0) return launch<__nv_bfloat16, 8>(f, prob, t, mass, hard, n, h, w, c, sp_h, sp_w, scale, s);
  if (c % 4 == 0 && bits % 8 == 0) return launch<__nv_bfloat16, 4>(f, prob, t, mass, hard, n, h, w, c, sp_h, sp_w, scale, s);
  if (c % 2 == 0 && bits % 4 == 0) return launch<__nv_bfloat16, 2>(f, prob, t, mass, hard, n, h, w, c, sp_h, sp_w, scale, s);
  return launch<__nv_bfloat16, 1>(f, prob, t, mass, hard, n, h, w, c, sp_h, sp_w, scale, s);
}
