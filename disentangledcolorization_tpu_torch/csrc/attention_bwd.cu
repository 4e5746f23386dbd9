// Backward of kernel D: gradients of the attention core w.r.t. q, k and v.
//
// The JAX package differentiates the attention core with XLA's autodiff
// (models/transformer.py:50-58); ops/pallas_attention.py::fused_attention
// has no backward. This kernel is that gradient for the port's kernel D
// (csrc/attention.cu), with the same optional key-padding mask (logit -1e9)
// and the same optional dropout keep-mask (N,nhead,T,T) uint8 with
// inv_keep = 1/(1-rate). Per (n, head), with s_ij = (scale q_i) . k_j,
// P = softmax_j(s), K_ij = keep_ij * inv_keep (1 without dropout):
//   dP_ij = (dO_i . v_j) K_ij          D_i  = sum_j P_ij dP_ij
//   dS_ij = P_ij (dP_ij - D_i)         (0 for a masked key)
//   dq_i  = scale sum_j dS_ij k_j      dk_j = scale sum_i dS_ij q_i
//   dv_j  = sum_i P_ij K_ij dO_i
// f32 throughout; the softmax statistics are recomputed, not stored by the
// forward.
//
// Bound: operations (about 10 T^2 hd flops per head against 6 T hd floats of
// traffic; at T=256, hd=8 that is 5.2 MFLOP for 49 KB). Design: one block
// per (head, n), so nothing crosses blocks and no atomics are needed: the
// result is deterministic. Pass 1 stages K and V in shared memory and gives
// each thread a query: it recomputes the row max and sum, then D_i, then dq_i,
// and leaves (max, sum, D) in shared memory. Pass 2 re-stages Q (pre-scaled)
// and dO in the same space and gives each thread a key: dk_j and dv_j are
// sums over the queries in registers. Threads of a warp read the same staged
// row: shared-memory broadcasts. In pass 2 consecutive threads read
// consecutive bytes of a keep-mask row.
#include <cuda_runtime.h>
#include <math.h>

namespace {

template <int HD>
__global__ void attention_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                     const float* __restrict__ v, const float* __restrict__ dout,
                                     const unsigned char* __restrict__ mask,
                                     const unsigned char* __restrict__ keep, float* __restrict__ dq,
                                     float* __restrict__ dk, float* __restrict__ dv, int T, int D,
                                     float scale, float inv_keep) {
  extern __shared__ float sm[];
  float* sa = sm;                 // T * HD: K in pass 1, scaled Q in pass 2
  float* sb = sm + T * HD;        // T * HD: V in pass 1, dO in pass 2
  float* smax = sm + 2 * T * HD;  // T per-query row max
  float* ssum = smax + T;         // T per-query row sum of exp
  float* sdel = ssum + T;         // T per-query D_i
  float* smask = sdel + T;        // T key-padding flags
  const int h = blockIdx.x;
  const long n = blockIdx.y;
  const long base = n * T * D + h * HD;
  const unsigned char* kbase = keep == nullptr ? nullptr : keep + (n * gridDim.x + h) * (long)T * T;

  for (int e = threadIdx.x; e < T * HD; e += blockDim.x) {
    const int t = e / HD, dd = e - t * HD;
    sa[e] = k[base + (long)t * D + dd];
    sb[e] = v[base + (long)t * D + dd];
  }
  for (int t = threadIdx.x; t < T; t += blockDim.x)
    smask[t] = (mask != nullptr && mask[n * T + t] != 0) ? 1.f : 0.f;
  __syncthreads();

  // pass 1: one thread per query
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    float qr[HD], dor[HD], acc[HD];
#pragma unroll
    for (int dd = 0; dd < HD; ++dd) {
      qr[dd] = q[base + (long)i * D + dd] * scale;
      dor[dd] = dout[base + (long)i * D + dd];
      acc[dd] = 0.f;
    }
    const unsigned char* krow = kbase == nullptr ? nullptr : kbase + (long)i * T;
    float m = -INFINITY, l = 0.f;
    for (int j = 0; j < T; ++j) {
      float s = 0.f;
#pragma unroll
      for (int dd = 0; dd < HD; ++dd) s = fmaf(qr[dd], sa[j * HD + dd], s);
      if (smask[j] != 0.f) s = -1e9f;
      if (s > m) {
        l *= expf(m - s);
        m = s;
      }
      l += expf(s - m);
    }
    float del = 0.f;
    for (int j = 0; j < T; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int dd = 0; dd < HD; ++dd) {
        s = fmaf(qr[dd], sa[j * HD + dd], s);
        dp = fmaf(dor[dd], sb[j * HD + dd], dp);
      }
      if (smask[j] != 0.f) s = -1e9f;
      if (krow != nullptr) dp = krow[j] != 0 ? dp * inv_keep : 0.f;
      del = fmaf(expf(s - m) / l, dp, del);
    }
    for (int j = 0; j < T; ++j) {
      if (smask[j] != 0.f) continue;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int dd = 0; dd < HD; ++dd) {
        s = fmaf(qr[dd], sa[j * HD + dd], s);
        dp = fmaf(dor[dd], sb[j * HD + dd], dp);
      }
      if (krow != nullptr) dp = krow[j] != 0 ? dp * inv_keep : 0.f;
      const float ds = expf(s - m) / l * (dp - del);
#pragma unroll
      for (int dd = 0; dd < HD; ++dd) acc[dd] = fmaf(ds, sa[j * HD + dd], acc[dd]);
    }
    float* op = dq + base + (long)i * D;
#pragma unroll
    for (int dd = 0; dd < HD; ++dd) op[dd] = acc[dd] * scale;
    smax[i] = m;
    ssum[i] = l;
    sdel[i] = del;
  }
  __syncthreads();

  for (int e = threadIdx.x; e < T * HD; e += blockDim.x) {
    const int t = e / HD, dd = e - t * HD;
    sa[e] = q[base + (long)t * D + dd] * scale;
    sb[e] = dout[base + (long)t * D + dd];
  }
  __syncthreads();

  // pass 2: one thread per key
  for (int j = threadIdx.x; j < T; j += blockDim.x) {
    float kr[HD], vr[HD], dkr[HD], dvr[HD];
#pragma unroll
    for (int dd = 0; dd < HD; ++dd) {
      kr[dd] = k[base + (long)j * D + dd];
      vr[dd] = v[base + (long)j * D + dd];
      dkr[dd] = 0.f;
      dvr[dd] = 0.f;
    }
    const bool masked = smask[j] != 0.f;
    for (int i = 0; i < T; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int dd = 0; dd < HD; ++dd) {
        s = fmaf(sa[i * HD + dd], kr[dd], s);
        dp = fmaf(sb[i * HD + dd], vr[dd], dp);
      }
      if (masked) s = -1e9f;
      const float p = expf(s - smax[i]) / ssum[i];
      float pk = p;
      if (kbase != nullptr) {
        const bool kept = kbase[(long)i * T + j] != 0;
        pk = kept ? p * inv_keep : 0.f;
        dp = kept ? dp * inv_keep : 0.f;
      }
      const float ds = masked ? 0.f : p * (dp - sdel[i]);
#pragma unroll
      for (int dd = 0; dd < HD; ++dd) {
        dvr[dd] = fmaf(pk, sb[i * HD + dd], dvr[dd]);
        dkr[dd] = fmaf(ds, sa[i * HD + dd], dkr[dd]);
      }
    }
    float* kp = dk + base + (long)j * D;
    float* vp = dv + base + (long)j * D;
#pragma unroll
    for (int dd = 0; dd < HD; ++dd) {
      kp[dd] = dkr[dd];
      vp[dd] = dvr[dd];
    }
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, const float* dout,
           const unsigned char* mask, const unsigned char* keep, float* dq, float* dk, float* dv,
           int n, int t, int d, int nhead, float inv_keep, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)t * HD + 4 * (size_t)t);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(attention_bwd_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = ((t + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const float scale = 1.f / sqrtf((float)HD);
  attention_bwd_kernel<HD><<<dim3(nhead, n), threads, smem, stream>>>(
      q, k, v, dout, mask, keep, dq, dk, dv, t, d, scale, inv_keep);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int disco_attention_bwd(const float* q, const float* k, const float* v,
                                   const float* dout, const unsigned char* mask,
                                   const unsigned char* keep, float* dq, float* dk, float* dv,
                                   int n, int t, int d, int nhead, float inv_keep, void* stream) {
  if ((long)n * t == 0) return 0;
  if (nhead <= 0 || d % nhead != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (d / nhead) {
    case 8: return launch<8>(q, k, v, dout, mask, keep, dq, dk, dv, n, t, d, nhead, inv_keep, s);
    case 16: return launch<16>(q, k, v, dout, mask, keep, dq, dk, dv, n, t, d, nhead, inv_keep, s);
    case 32: return launch<32>(q, k, v, dout, mask, keep, dq, dk, dv, n, t, d, nhead, inv_keep, s);
    case 64: return launch<64>(q, k, v, dout, mask, keep, dq, dk, dv, n, t, d, nhead, inv_keep, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
