// Kernel C: soft unpooling of superpixel tokens back to pixels.
//
// Replaces disentangledcolorization_tpu/ops/pallas_superpixel.py::upfeat (_up_kernel).
//   out[n,y,x,c] = sum_d prob[n,y,x,d] * tokens[n, i+dy_d, j+dx_d, c]
// with (i, j) = (y / up_h, x / up_w), d = 0..8 the row-major offsets (-1,-1)..(1,1),
// and tokens zero outside the hc x wc grid. f32 throughout.
//
// Bound: bytes. It reads prob once and writes C floats per pixel (about
// 19.1 MB per 256x256 image at C=64); the token grid is tiny. Design: one
// block per output row (n, y) stages the three token rows it needs (zero-padded
// to wc+2 columns) and the row's 9 affinities per pixel in shared memory; then
// thread e writes out[n,y,x,c] for e = x*C + c, so consecutive threads write
// consecutive addresses and read shared memory without bank conflicts.
#include <cuda_runtime.h>

namespace {

__global__ void upfeat_kernel(const float* __restrict__ tok, const float* __restrict__ prob,
                              float* __restrict__ out, int H, int W, int C, int up_h, int up_w,
                              int hc, int wc) {
  extern __shared__ float sm[];
  const int tw = wc + 2;
  float* stok = sm;                // 3 * (wc + 2) * C
  float* sprob = sm + 3 * tw * C;  // W * 9

  const int y = blockIdx.x % H;
  const long n = blockIdx.x / H;
  const int i = y / up_h;
  for (int e = threadIdx.x; e < 3 * tw * C; e += blockDim.x) {
    const int r = e / (tw * C);
    const int rem = e - r * tw * C;
    const int jj = rem / C;
    const int c = rem - jj * C;
    const int ti = i + r - 1, tj = jj - 1;
    stok[e] = (ti >= 0 && ti < hc && tj >= 0 && tj < wc) ? tok[((n * hc + ti) * wc + tj) * C + c]
                                                         : 0.f;
  }
  const float* prow = prob + (n * H + y) * (long)W * 9;
  for (int e = threadIdx.x; e < W * 9; e += blockDim.x) sprob[e] = prow[e];
  __syncthreads();

  float* orow = out + (n * H + y) * (long)W * C;
  for (int e = threadIdx.x; e < W * C; e += blockDim.x) {
    const int x = e / C;
    const int c = e - x * C;
    const int j = x / up_w;
    const float* pp = sprob + x * 9;
    float acc = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        acc = fmaf(pp[dy * 3 + dx], stok[(dy * tw + j + dx) * C + c], acc);
      }
    }
    orow[e] = acc;
  }
}

}  // namespace

extern "C" int disco_upfeat(const float* tok, const float* prob, float* out, int n, int hc, int wc,
                            int c, int up_h, int up_w, void* stream) {
  const int h = hc * up_h, w = wc * up_w;
  if ((long)n * h == 0) return 0;
  const size_t smem = sizeof(float) * (3 * (size_t)(wc + 2) * c + (size_t)w * 9);
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(upfeat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  upfeat_kernel<<<n * h, 256, smem, (cudaStream_t)stream>>>(tok, prob, out, h, w, c, up_h, up_w, hc,
                                                            wc);
  return (int)cudaGetLastError();
}
