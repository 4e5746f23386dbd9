// Kernel D: multi-head attention core over the superpixel tokens.
//
// Replaces disentangledcolorization_tpu/ops/pallas_attention.py::fused_attention.
// q, k, v (N,T,D) f32 already projected, heads packed along D (hd = D / nhead):
//   out[n,t,h] = softmax_j((q[n,t,h] / sqrt(hd)) . k[n,j,h]) v[n,j,h]
// f32, max-subtracted, no dropout. Optional key-padding mask (N,T) uint8:
// where it is non-zero the logit is replaced by -1e9, as models/transformer.py
// does. The attention weights are not returned.
//
// Bound: bytes (0.26 MB per image per layer at T=256, D=64): each logit is an
// 8-wide dot, too small for tensor cores to pay. Design: one block per
// (query tile, head, n) stages the head's K and V (T x hd each) in shared
// memory; one thread per query keeps q, the running max, the running sum and
// hd accumulators in registers and makes one online-softmax pass over the
// keys, so the T x T logits never leave registers. All threads of a warp read
// the same key row: shared-memory broadcasts.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kQueries = 64;

template <int HD>
__global__ void attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const unsigned char* __restrict__ mask,
                                 float* __restrict__ out, int T, int D, float scale) {
  extern __shared__ float sm[];
  float* sk = sm;               // T * HD
  float* sv = sm + T * HD;      // T * HD
  float* smask = sm + 2 * T * HD;  // T
  const long n = blockIdx.z;
  const int h = blockIdx.y;
  const long base = n * T * D + h * HD;
  for (int e = threadIdx.x; e < T * HD; e += blockDim.x) {
    const int t = e / HD, dd = e - t * HD;
    sk[e] = k[base + (long)t * D + dd];
    sv[e] = v[base + (long)t * D + dd];
  }
  for (int t = threadIdx.x; t < T; t += blockDim.x)
    smask[t] = (mask != nullptr && mask[n * T + t] != 0) ? 1.f : 0.f;
  __syncthreads();

  const int tq = blockIdx.x * blockDim.x + threadIdx.x;
  if (tq >= T) return;
  float qr[HD], acc[HD];
#pragma unroll
  for (int dd = 0; dd < HD; ++dd) {
    qr[dd] = q[base + (long)tq * D + dd] * scale;
    acc[dd] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int j = 0; j < T; ++j) {
    float s = 0.f;
#pragma unroll
    for (int dd = 0; dd < HD; ++dd) s = fmaf(qr[dd], sk[j * HD + dd], s);
    if (smask[j] != 0.f) s = -1e9f;
    if (s > m) {
      const float corr = expf(m - s);
      l *= corr;
#pragma unroll
      for (int dd = 0; dd < HD; ++dd) acc[dd] *= corr;
      m = s;
    }
    const float p = expf(s - m);
    l += p;
#pragma unroll
    for (int dd = 0; dd < HD; ++dd) acc[dd] = fmaf(p, sv[j * HD + dd], acc[dd]);
  }
  float* op = out + base + (long)tq * D;
#pragma unroll
  for (int dd = 0; dd < HD; ++dd) op[dd] = acc[dd] / l;
}

template <int HD>
int launch(const float* q, const float* k, const float* v, const unsigned char* mask, float* out,
           int n, int t, int d, int nhead, cudaStream_t stream) {
  const dim3 grid((t + kQueries - 1) / kQueries, nhead, n);
  const size_t smem = sizeof(float) * (2 * (size_t)t * HD + t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(attention_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const float scale = 1.f / sqrtf((float)HD);
  attention_kernel<HD><<<grid, kQueries, smem, stream>>>(q, k, v, mask, out, t, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int disco_attention(const float* q, const float* k, const float* v,
                               const unsigned char* mask, float* out, int n, int t, int d,
                               int nhead, void* stream) {
  if ((long)n * t == 0) return 0;
  if (nhead <= 0 || d % nhead != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (d / nhead) {
    case 8: return launch<8>(q, k, v, mask, out, n, t, d, nhead, s);
    case 16: return launch<16>(q, k, v, mask, out, n, t, d, nhead, s);
    case 32: return launch<32>(q, k, v, mask, out, n, t, d, nhead, s);
    case 64: return launch<64>(q, k, v, mask, out, n, t, d, nhead, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
