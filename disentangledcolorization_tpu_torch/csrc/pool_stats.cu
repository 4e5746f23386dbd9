// Kernel A: per-cell soft pooling statistics of the 9-neighbour superpixel affinity.
//
// Replaces disentangledcolorization_tpu/ops/pallas_superpixel.py::pool_stats
// (and ::_pool_sums, which poolfeat runs: the same sums without the hard counts).
// For every sp_h x sp_w cell (n, i, j) of the token grid it computes, in f32:
//   t[n,i,j,d,c]  = sum_{p in cell} prob[p,d] * feat[p,c] / (sp_h*sp_w)
//   mass[n,i,j,d] = sum_{p in cell} prob[p,d]             / (sp_h*sp_w)
//   hard[n,i,j,d] = #{p in cell : prob[p,d] == max_e prob[p,e]} / (sp_h*sp_w)
// (ties keep every winner, as ops/superpixel.py::hard_assignment does). The
// 9-direction shift-add and the division by mass + 1e-8 on the tiny token grid
// stay torch ops in the wrapper (ops/superpixel.py), as they stay XLA in JAX.
//
// Bound: bytes. One read of feat (N,H,W,C) and prob (N,H,W,9) dominates (about
// 20.3 MB per 256x256 image at C=66); the 9*C multiply-adds per pixel are far
// below the card's f32 rate. Design: one block per cell stages the cell's
// sp_h*sp_w x 9 affinities (and each pixel's max) in shared memory; threads
// along x own channels, so a warp reads one pixel's channels contiguously;
// kGroups thread rows split the pixels and their partial sums are added in a
// fixed order in shared memory: no atomics, the result is deterministic.
#include <cuda_runtime.h>

namespace {

constexpr int kGroups = 4;

__global__ void pool_stats_kernel(const float* __restrict__ feat, const float* __restrict__ prob,
                                  float* __restrict__ t, float* __restrict__ mass,
                                  float* __restrict__ hard, int H, int W, int C, int sp_h,
                                  int sp_w, int hc, int wc) {
  extern __shared__ float smem[];
  const int npix = sp_h * sp_w;
  float* sprob = smem;               // npix * 9
  float* spmax = sprob + npix * 9;   // npix
  float* spart = spmax + npix;       // kGroups * 9 * C

  const int cell = blockIdx.x;
  const int j = cell % wc;
  const int i = (cell / wc) % hc;
  const long n = cell / (wc * hc);
  const int y0 = i * sp_h, x0 = j * sp_w;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  for (int e = tid; e < npix * 9; e += nthreads) {
    const int p = e / 9, d = e - p * 9;
    const int py = p / sp_w, px = p - py * sp_w;
    sprob[e] = prob[((n * H + y0 + py) * W + x0 + px) * 9 + d];
  }
  __syncthreads();
  for (int p = tid; p < npix; p += nthreads) {
    float m = sprob[p * 9];
#pragma unroll
    for (int d = 1; d < 9; ++d) m = fmaxf(m, sprob[p * 9 + d]);
    spmax[p] = m;
  }

  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc[9];
#pragma unroll
    for (int d = 0; d < 9; ++d) acc[d] = 0.f;
    for (int p = threadIdx.y; p < npix; p += kGroups) {
      const int py = p / sp_w, px = p - py * sp_w;
      const float f = feat[((n * H + y0 + py) * W + x0 + px) * C + c];
      const float* pp = sprob + p * 9;
#pragma unroll
      for (int d = 0; d < 9; ++d) acc[d] = fmaf(pp[d], f, acc[d]);
    }
#pragma unroll
    for (int d = 0; d < 9; ++d) spart[(threadIdx.y * 9 + d) * C + c] = acc[d];
  }
  __syncthreads();

  const float norm = 1.f / (float)npix;
  const long obase = (long)cell * 9;
  for (int e = tid; e < 9 * C; e += nthreads) {
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) s += spart[g * 9 * C + e];
    t[obase * C + e] = s * norm;
  }
  if (tid < 9) {
    float s = 0.f;
    for (int p = 0; p < npix; ++p) s += sprob[p * 9 + tid];
    mass[obase + tid] = s * norm;
  } else if (hard != nullptr && tid < 18) {
    const int d = tid - 9;
    float s = 0.f;
    for (int p = 0; p < npix; ++p) s += (sprob[p * 9 + d] == spmax[p]) ? 1.f : 0.f;
    hard[obase + d] = s * norm;
  }
}

}  // namespace

extern "C" int disco_pool_stats(const float* feat, const float* prob, float* t, float* mass,
                                float* hard, int n, int h, int w, int c, int sp_h, int sp_w,
                                void* stream) {
  const int hc = h / sp_h, wc = w / sp_w;
  const int cells = n * hc * wc;
  if (cells == 0) return 0;
  int bx = ((c + 31) / 32) * 32;
  if (bx > 256) bx = 256;
  const dim3 block(bx, kGroups);
  const size_t smem = sizeof(float) * ((size_t)sp_h * sp_w * 10 + (size_t)kGroups * 9 * c);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(pool_stats_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pool_stats_kernel<<<cells, block, smem, (cudaStream_t)stream>>>(feat, prob, t, mass, hard, h, w,
                                                                  c, sp_h, sp_w, hc, wc);
  return (int)cudaGetLastError();
}
