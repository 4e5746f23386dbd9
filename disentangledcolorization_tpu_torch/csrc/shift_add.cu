// Kernel F: the 9-direction shift-add over the token grid, after kernel A.
//
// The JAX package leaves this step to XLA (ops/superpixel.py::poolfeat, the
// nine shifted slices after the einsum; pallas_superpixel.py::pool_and_sizes
// after pool_stats), where it fuses; eager PyTorch runs it as a dozen small
// launches, so the port writes it out. Superpixel (i, j) collects direction d
// from the cell at (i, j) - off_d, off_d the row-major offsets (-1,-1)..(1,1),
// zero outside the hc x wc grid:
//   sum_t[n,i,j,c]  = sum_d t[n, i-dy_d, j-dx_d, d, c]
//   mass_sum[n,i,j] = sum_d mass[n, i-dy_d, j-dx_d, d]
//   sizes[n,i,j]    = sum_d hard[n, i-dy_d, j-dx_d, d]
// Two uses, one launch each:
//   pooling's forward    out = sum_t / (mass_sum + 1e-8), mass_sum, sizes (hard may be null)
//   unpooling's backward out = sum_t                       (mass and hard null)
// Gather form, the 9 terms added in the order of d as the plain version
// (ops/superpixel.py::_shift_add) adds its slices: no atomics, and the sums
// are the plain version's bit for bit.
//
// Bound: bytes, and small ones: t is 9*C floats a token (4.9 MB at batch 8,
// C=66), just written by kernel A and still in L2. Design: one block per
// token, a thread per channel; every thread adds the token's 9 masses itself
// (9 broadcast loads) rather than wait for one that does.
//
// The bf16 instance (disco_shift_add_bf16, ``shift_add[bf16]``) is unpooling's
// token gradient in bf16 training: t f32 in, bf16 out, no masses. It rounds
// where the JAX package's jax.vjp of ops/superpixel.py::upfeat rounds, as the
// compiled HLO of that vjp shows it (XLA on the CPU): the transpose of the
// neighbour stack's cast converts each direction's f32 sum to bf16, the
// transpose of the 9 dynamic_slices pads each slab with zeros, and the slabs
// are summed by a chain of add_any, each an f32 add converted to bf16, that
// starts with direction 8 and adds 7, 6, ..., 0:
//   a = bf16(t8); a = bf16(a + bf16(t7)); ...; a = bf16(a + bf16(t0))
// (a zero slab term leaves a unchanged). The same order and roundings are
// ops/superpixel.py::_shift_add_rounded, so the kernel equals its plain
// version bit for bit. Same bound and design as the f32 instance: at the
// training shape (batch 24, C=64) it reads 14.2 MB of t and writes 0.8 MB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__global__ void shift_add_kernel(const float* __restrict__ t, const float* __restrict__ mass,
                                 const float* __restrict__ hard, float* __restrict__ out,
                                 float* __restrict__ mass_sum, float* __restrict__ sizes, int hc,
                                 int wc, int C) {
  const int token = blockIdx.x;
  const int j = token % wc;
  const int i = (token / wc) % hc;
  const long long n = token / (wc * hc);
  long long src[9];  // direction d's slot in its source cell, -1 outside the grid
#pragma unroll
  for (int d = 0; d < 9; ++d) {
    const int si = i - (d / 3 - 1), sj = j - (d % 3 - 1);
    src[d] = (si >= 0 && si < hc && sj >= 0 && sj < wc) ? ((n * hc + si) * wc + sj) * 9 + d : -1;
  }
  float denom = 1.f;
  if (mass != nullptr) {
    float m = src[0] >= 0 ? mass[src[0]] : 0.f;
#pragma unroll
    for (int d = 1; d < 9; ++d) m += src[d] >= 0 ? mass[src[d]] : 0.f;
    if (threadIdx.x == 0) mass_sum[token] = m;
    denom = m + 1e-8f;
  }
  if (hard != nullptr && threadIdx.x == 0) {
    float s = src[0] >= 0 ? hard[src[0]] : 0.f;
#pragma unroll
    for (int d = 1; d < 9; ++d) s += src[d] >= 0 ? hard[src[d]] : 0.f;
    sizes[token] = s;
  }
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = src[0] >= 0 ? t[src[0] * C + c] : 0.f;
#pragma unroll
    for (int d = 1; d < 9; ++d) a += src[d] >= 0 ? t[src[d] * C + c] : 0.f;
    out[(long long)token * C + c] = mass != nullptr ? a / denom : a;
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void shift_add_bf16_kernel(const float* __restrict__ t, __nv_bfloat16* __restrict__ out,
                                      int hc, int wc, int C) {
  const int token = blockIdx.x;
  const int j = token % wc;
  const int i = (token / wc) % hc;
  const long long n = token / (wc * hc);
  long long src[9];
#pragma unroll
  for (int d = 0; d < 9; ++d) {
    const int si = i - (d / 3 - 1), sj = j - (d % 3 - 1);
    src[d] = (si >= 0 && si < hc && sj >= 0 && sj < wc) ? ((n * hc + si) * wc + sj) * 9 + d : -1;
  }
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = src[8] >= 0 ? round_bf16(t[src[8] * C + c]) : 0.f;
#pragma unroll
    for (int d = 7; d >= 0; --d) {
      if (src[d] >= 0) a = round_bf16(a + round_bf16(t[src[d] * C + c]));
    }
    out[(long long)token * C + c] = __float2bfloat16_rn(a);
  }
}

}  // namespace

// t (n,hc,wc,9,c), mass and hard (n,hc,wc,9) or null, out (n,hc,wc,c),
// mass_sum and sizes (n,hc,wc), written where mass and hard are given; all
// f32 and contiguous.
extern "C" int disco_shift_add(const float* t, const float* mass, const float* hard, float* out,
                               float* mass_sum, float* sizes, int n, int hc, int wc, int c,
                               void* stream) {
  if ((long long)n * hc * wc == 0) return 0;
  int threads = ((c + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  if (threads < 32) threads = 32;
  shift_add_kernel<<<n * hc * wc, threads, 0, (cudaStream_t)stream>>>(t, mass, hard, out, mass_sum,
                                                                     sizes, hc, wc, c);
  return (int)cudaGetLastError();
}

// t (n,hc,wc,9,c) f32 -> out (n,hc,wc,c) bf16, contiguous: the bf16 instance.
extern "C" int disco_shift_add_bf16(const float* t, __nv_bfloat16* out, int n, int hc, int wc, int c,
                                    void* stream) {
  if ((long long)n * hc * wc == 0) return 0;
  int threads = ((c + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  if (threads < 32) threads = 32;
  shift_add_bf16_kernel<<<n * hc * wc, threads, 0, (cudaStream_t)stream>>>(t, out, hc, wc, c);
  return (int)cudaGetLastError();
}
