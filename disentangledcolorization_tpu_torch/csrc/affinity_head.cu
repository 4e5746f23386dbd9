// Kernel B: SpixelNet's affinity head, a 3x3 SAME conv C -> 9 + bias + softmax over the 9.
//
// Replaces disentangledcolorization_tpu/ops/pallas_affinity.py::fused_affinity_head.
// x (N,H,W,C) f32 NHWC, kernel (3,3,C,9) HWIO f32, bias (9,) -> out (N,H,W,9) f32,
// zero padding, f32 accumulation, max-subtracted softmax.
//
// Bound: bytes. It reads x once and writes 9 floats per pixel (about 6.6 MB per
// 256x256 image at C=16); 162*C flops per pixel are far below the card's f32
// rate. Design: one thread per pixel keeps its 9 sums in registers; the 81*C
// weights and the bias sit in shared memory and every warp reads them as
// broadcasts; the 3x3 halo comes from L1/L2, since neighbouring threads read
// neighbouring pixels.
#include <cuda_runtime.h>

namespace {

__global__ void affinity_head_kernel(const float* __restrict__ x, const float* __restrict__ wgt,
                                     const float* __restrict__ bias, float* __restrict__ out,
                                     int N, int H, int W, int C) {
  extern __shared__ float sw[];  // 81 * C weights, then 9 biases
  for (int e = threadIdx.x; e < 81 * C; e += blockDim.x) sw[e] = wgt[e];
  if (threadIdx.x < 9) sw[81 * C + threadIdx.x] = bias[threadIdx.x];
  __syncthreads();

  const long pix = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= (long)N * H * W) return;
  const int xq = (int)(pix % W);
  const int yq = (int)((pix / W) % H);
  const long n = pix / ((long)W * H);

  float acc[9];
#pragma unroll
  for (int o = 0; o < 9; ++o) acc[o] = sw[81 * C + o];
  for (int dy = 0; dy < 3; ++dy) {
    const int yy = yq + dy - 1;
    if (yy < 0 || yy >= H) continue;
    for (int dx = 0; dx < 3; ++dx) {
      const int xx = xq + dx - 1;
      if (xx < 0 || xx >= W) continue;
      const float* xp = x + ((n * H + yy) * W + xx) * C;
      const float* wp = sw + (dy * 3 + dx) * C * 9;
      for (int ci = 0; ci < C; ++ci) {
        const float v = xp[ci];
#pragma unroll
        for (int o = 0; o < 9; ++o) acc[o] = fmaf(v, wp[ci * 9 + o], acc[o]);
      }
    }
  }
  float m = acc[0];
#pragma unroll
  for (int o = 1; o < 9; ++o) m = fmaxf(m, acc[o]);
  float s = 0.f;
#pragma unroll
  for (int o = 0; o < 9; ++o) {
    acc[o] = expf(acc[o] - m);
    s += acc[o];
  }
  float* op = out + pix * 9;
#pragma unroll
  for (int o = 0; o < 9; ++o) op[o] = acc[o] / s;
}

}  // namespace

extern "C" int disco_affinity_head(const float* x, const float* wgt, const float* bias, float* out,
                                   int n, int h, int w, int c, void* stream) {
  const long pixels = (long)n * h * w;
  if (pixels == 0) return 0;
  const int threads = 256;
  const long blocks = (pixels + threads - 1) / threads;
  const size_t smem = sizeof(float) * (81 * (size_t)c + 9);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(affinity_head_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  affinity_head_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(x, wgt, bias,
                                                                                  out, n, h, w, c);
  return (int)cudaGetLastError();
}
