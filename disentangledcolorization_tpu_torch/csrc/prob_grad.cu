// Kernel G: the gradient of soft pooling and unpooling with respect to the affinity map.
//
// No Pallas kernel computes it: the JAX package differentiates its XLA
// formulation (ops/superpixel.py::poolfeat and ::upfeat under jax.vjp). Pixel p
// of cell (i, j) feeds token (i, j) + off_d in direction d in both ops, d = 0..8
// the row-major offsets (-1,-1)..(1,1), so both gradients take one form:
//   dprob[n,p,d] = sum_c x[n,p,c] * T[n,(i,j)+off_d,c] + beta[n,(i,j)+off_d]
// with T and beta zero off the hc x wc token grid. Unpooling: x is the output's
// gradient, T the tokens, beta absent (null). Pooling: x is the features,
// T = g_pooled * s and beta = -s * sum_c g_pooled * pooled (+ g_mass / (sp_h*sp_w)),
// s = 1 / ((mass + 1e-8) * sp_h*sp_w); the wrapper forms T and beta on the token
// grid. f32 throughout; each dot product is summed in the order of c.
//
// Bound: bytes. It reads x once (C floats a pixel) and writes 9 floats a pixel:
// at (128,256,256,4) 134 + 302 MB, 0.130 ms at 3.35 TB/s, against 18*C flops a
// pixel. Design: kernel C's layout with the reduction turned the other way. One
// block per cell stages the 9 neighbour token vectors and their beta in shared
// memory (zeros off the grid); a thread takes a pixel, reads its features with
// read-only vector loads (16 bytes where C % 4 == 0 and x is aligned, 8 where
// C % 2 == 0, else 4) and forms the 9 dot products against broadcast shared
// reads. A pixel's 36 result bytes do not align to 16, so the results go to
// shared memory (stride 9 floats: no bank conflicts) and leave as whole rows of
// the cell, sp_w*9 contiguous floats, a warp on consecutive addresses, with
// streaming stores: the output exceeds L2 and this kernel does not read it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads a block, at most

template <int VEC>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float (&r)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    r[0] = x.x, r[1] = x.y, r[2] = x.z, r[3] = x.w;
  } else if constexpr (VEC == 2) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(p));
    r[0] = x.x, r[1] = x.y;
  } else {
    r[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void load_shared(const float* p, float (&r)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    r[0] = x.x, r[1] = x.y, r[2] = x.z, r[3] = x.w;
  } else if constexpr (VEC == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    r[0] = x.x, r[1] = x.y;
  } else {
    r[0] = *p;
  }
}

// A pass covers `rows` whole rows of the cell (rows * sp_w pixels); a thread
// takes every blockDim.x-th pixel of the pass.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
prob_grad_kernel(const float* __restrict__ x, const float* __restrict__ tok,
                 const float* __restrict__ beta, float* __restrict__ out, int hc, int wc, int C,
                 int sp_h, int sp_w, int rows) {
  extern __shared__ __align__(16) float smem[];
  float* s_tok = smem;                     // [9][C]
  float* s_beta = smem + 9 * C;            // [9]
  float* s_out = s_beta + 9;               // [rows * sp_w][9]
  const int cell = blockIdx.x;
  const int j = cell % wc;
  const int i = (cell / wc) % hc;
  const long long n = cell / (wc * hc);
  const int W = wc * sp_w;

  for (int k = threadIdx.x; k < 9 * C; k += blockDim.x) {
    const int d = k / C, c = k - d * C;
    const int ti = i + d / 3 - 1, tj = j + d % 3 - 1;
    const bool inside = ti >= 0 && ti < hc && tj >= 0 && tj < wc;
    s_tok[k] = inside ? __ldg(tok + ((n * hc + ti) * wc + tj) * C + c) : 0.f;
  }
  if (threadIdx.x < 9) {
    const int d = threadIdx.x;
    const int ti = i + d / 3 - 1, tj = j + d % 3 - 1;
    const bool inside = ti >= 0 && ti < hc && tj >= 0 && tj < wc;
    s_beta[d] = (beta != nullptr && inside) ? __ldg(beta + (n * hc + ti) * wc + tj) : 0.f;
  }
  __syncthreads();

  const long long pix0 = ((n * hc + i) * sp_h) * W + (long long)j * sp_w;  // the cell's first pixel
  const int span = sp_w * 9;  // floats in one row of the cell's output
  for (int r0 = 0; r0 < sp_h; r0 += rows) {
    const int npix = (r0 + rows <= sp_h ? rows : sp_h - r0) * sp_w;
    for (int q = threadIdx.x; q < npix; q += blockDim.x) {
      const int py = r0 + q / sp_w, px = q % sp_w;
      const float* xp = x + (pix0 + (long long)py * W + px) * C;
      float acc[9];
#pragma unroll
      for (int d = 0; d < 9; ++d) acc[d] = 0.f;
      for (int c = 0; c < C; c += VEC) {
        float v[VEC];
        load_vec<VEC>(xp + c, v);
#pragma unroll
        for (int d = 0; d < 9; ++d) {
          float t[VEC];
          load_shared<VEC>(s_tok + d * C + c, t);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[d] = fmaf(v[e], t[e], acc[d]);
        }
      }
#pragma unroll
      for (int d = 0; d < 9; ++d) s_out[q * 9 + d] = acc[d] + s_beta[d];
    }
    __syncthreads();
    // row r of the pass: span contiguous floats from pixel (r0 + r, 0) of the cell
    int r = threadIdx.x / span, e = threadIdx.x % span;
    for (int k = threadIdx.x; k < npix * 9; k += blockDim.x) {
      __stcs(out + (pix0 + (long long)(r0 + r) * W) * 9 + e, s_out[k]);
      e += blockDim.x;
      while (e >= span) e -= span, ++r;
    }
    __syncthreads();
  }
}

template <int VEC>
int launch(const float* x, const float* tok, const float* beta, float* out, int n, int hc, int wc,
           int c, int sp_h, int sp_w, cudaStream_t stream) {
  int rows = kThreads / sp_w;
  if (rows < 1) rows = 1;
  if (rows > sp_h) rows = sp_h;
  int threads = ((rows * sp_w + 31) / 32) * 32;
  if (threads > kThreads) threads = kThreads;
  const size_t smem = 9 * ((size_t)c + 1 + (size_t)rows * sp_w) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(prob_grad_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  prob_grad_kernel<VEC><<<n * hc * wc, threads, smem, stream>>>(x, tok, beta, out, hc, wc, c, sp_h,
                                                                sp_w, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// x (n,hc*sp_h,wc*sp_w,c), tok (n,hc,wc,c), beta (n,hc,wc) or null,
// out (n,hc*sp_h,wc*sp_w,9); all f32 and contiguous. The wrapper keeps the
// shared memory, 36 * (c + 1 + rows*sp_w) bytes, within 227 KB.
extern "C" int disco_prob_grad(const float* x, const float* tok, const float* beta, float* out, int n,
                               int hc, int wc, int c, int sp_h, int sp_w, void* stream) {
  if ((long long)n * hc * wc * sp_h * sp_w == 0) return 0;
  const uintptr_t bits = (uintptr_t)x;  // the vector loads
  cudaStream_t s = (cudaStream_t)stream;
  if (c % 4 == 0 && bits % 16 == 0) return launch<4>(x, tok, beta, out, n, hc, wc, c, sp_h, sp_w, s);
  if (c % 2 == 0 && bits % 8 == 0) return launch<2>(x, tok, beta, out, n, hc, wc, c, sp_h, sp_w, s);
  return launch<1>(x, tok, beta, out, n, hc, wc, c, sp_h, sp_w, s);
}
