// Kernel D: multi-head attention core over the superpixel tokens.
//
// Replaces disentangledcolorization_tpu/ops/pallas_attention.py::fused_attention.
// q, k, v (N,T,D) f32 already projected, heads packed along D (hd = D / nhead):
//   out[n,t,h] = softmax_j((q[n,t,h] / sqrt(hd)) . k[n,j,h]) v[n,j,h]
// f32, max-subtracted. Optional key-padding mask (N,T) uint8: where it is
// non-zero the logit is replaced by -1e9, as models/transformer.py does.
// Optional dropout on the attention weights: a keep-mask (N,nhead,T,T) uint8
// and inv_keep = 1/(1-rate) give
//   out[n,t,h] = sum_j softmax_tj * keep[n,h,t,j] * inv_keep * v[n,j,h]
// which is flax nn.Dropout on the weights (transformer.py:57). The mask is
// drawn by the caller, so the kernel holds no random state.
// Optional second output, the softmax statistics (N,nhead,T,2) f32: the row
// max m of the logits and the row sum l of exp(s - m). csrc/attention_bwd.cu
// reads them instead of recomputing the softmax. The two are stored apart, not
// as m + log(l): a row whose keys are all masked has m = -1e9, where f32 has
// no room for log(l), and that row must stay uniform.
//
// Bound: operations. Per (n, head) 4 T^2 hd flops and T^2 exp against 4 T hd
// floats of traffic (2.1 MFLOP for 32 KB at T=256, hd=8). The heads are 8
// wide, so a logit is a dot of depth 8.
// Tensor cores are not used: the contract is f32 within 1e-5, and wgmma and
// mma.sync take f32 inputs only as TF32 (about three decimal digits), which
// fails it; splitting each operand in two TF32 terms triples the products of
// a depth-8 dot. A tensor-core version belongs to bf16 inputs with f32
// accumulation and a tolerance of their own.
//
// Design (layout and register tile in attention_common.cuh): a block owns 64
// queries of one (head, n) and stages the head's K and V in shared memory
// with 16-byte asynchronous copies. Each query's keys are split over 4 lanes;
// a lane keeps q, its own running max, running sum and hd accumulators in
// registers (for two queries at hd = 8, which share every K and V row the
// thread loads) and walks its keys in chunks of 8: eight independent dots,
// one chunk max, at most one rescale of the accumulators, eight exp. The
// T x T logits never leave registers. Two shuffle rounds merge the four partial
// softmaxes (rescaled by exp(m_lane - m)). The keep-mask bytes of a lane's 16
// keys come with one 16-byte load, fetched one step ahead; rows of a ragged T
// are not 16-byte aligned and take byte loads. The exponent is <= 0, where
// __expf's absolute error stays below 2e-7.
#include "attention_common.cuh"

namespace {

using namespace disco;

template <int HD, bool KEEP>
__global__ void __launch_bounds__(Shape<HD>::threads, Shape<HD>::min_blocks)
    attention_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const unsigned char* __restrict__ mask, const unsigned char* __restrict__ keep,
                     float* __restrict__ out, float* __restrict__ stats, int T, int D, float scale, float inv_keep,
                     int keep_vec) {
  constexpr int R = Shape<HD>::rows;
  extern __shared__ __align__(16) float sm[];
  const int Tp = round_up(T, kGroup);
  float* sk = sm;
  float* sv = sk + padded_floats<HD>(Tp);
  unsigned char* sflag = reinterpret_cast<unsigned char*>(sv + padded_floats<HD>(Tp));
  const long n = blockIdx.z;
  const int h = blockIdx.y;
  const long base = n * T * D + h * HD;
  // flags are read only where a key can be masked or missing
  const bool flagged = mask != nullptr || Tp != T;
  stage_padded<HD>(sk, k + base, T, Tp, D);
  stage_padded<HD>(sv, v + base, T, Tp, D);
  if (flagged) stage_flags(sflag, mask == nullptr ? nullptr : mask + n * T, T, Tp);

  const int ln = threadIdx.x % kLanes;
  int tq[R];
  float qr[R][HD], acc[R][HD], m[R], l[R];
  const unsigned char* krow[R];
  uint32_t kw[R][4], fw[4] = {0u, 0u, 0u, 0u};
  int j0 = ln * kGroup;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    tq[r] = blockIdx.x * kTile + threadIdx.x / kLanes + r * Shape<HD>::row_step;
    const int tqc = min(tq[r], T - 1);  // a row past the last query computes a copy of it and stores nothing
    load_row<HD>(q + base + (long)tqc * D, qr[r]);
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      qr[r][d] *= scale;
      acc[r][d] = 0.f;
    }
    m[r] = -INFINITY, l[r] = 0.f;
    krow[r] = KEEP ? keep + ((n * gridDim.y + h) * (long)T + tqc) * T : nullptr;
    kw[r][0] = kw[r][1] = kw[r][2] = kw[r][3] = 0u;
    if (KEEP && j0 < T) load_bytes16(krow[r] + j0, T - j0, keep_vec != 0, kw[r]);
  }
  cp_async_wait_all();
  __syncthreads();

  for (; j0 < T; j0 += kLanes * kGroup) {
    uint32_t kw_next[R][4];
    const int j1 = j0 + kLanes * kGroup;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      kw_next[r][0] = kw_next[r][1] = kw_next[r][2] = kw_next[r][3] = 0u;
      if (KEEP && j1 < T) load_bytes16(krow[r] + j1, T - j1, keep_vec != 0, kw_next[r]);
    }
    if (flagged) {
      const uint4 f = *reinterpret_cast<const uint4*>(sflag + j0);
      fw[0] = f.x, fw[1] = f.y, fw[2] = f.z, fw[3] = f.w;
    }
    const float* kp = sk + padded_row<HD>(j0);
    const float* vp = sv + padded_row<HD>(j0);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (j0 + half * 8 < T) {  // its first key exists, so the chunk max is finite
        float s[R][8], cmax[R];
#pragma unroll
        for (int r = 0; r < R; ++r) cmax[r] = -INFINITY;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int b = half * 8 + i;
          float kx[HD];
          lds_row<HD>(kp + b * HD, kx);
          const uint32_t f = flagged ? byte_of(fw, b) : 0u;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            s[r][i] = dot<HD>(qr[r], kx);
            if (flagged) s[r][i] = f == 0u ? s[r][i] : (f == 1u ? -1e9f : -INFINITY);
            cmax[r] = fmaxf(cmax[r], s[r][i]);
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (cmax[r] > m[r]) {
            const float corr = __expf(m[r] - cmax[r]);
            l[r] *= corr;
#pragma unroll
            for (int d = 0; d < HD; ++d) acc[r][d] *= corr;
            m[r] = cmax[r];
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int b = half * 8 + i;
          float vx[HD];
          lds_row<HD>(vp + b * HD, vx);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float p = __expf(s[r][i] - m[r]);
            l[r] += p;
            if (KEEP) p = byte_of(kw[r], b) != 0u ? p * inv_keep : 0.f;
            axpy<HD>(p, vx, acc[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int w = 0; w < 4; ++w) kw[r][w] = kw_next[r][w];
  }

  // merge the four lanes' partial softmaxes; a lane without keys has m = -inf, l = 0
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int off = 1; off < kLanes; off <<= 1) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float m_n = fmaxf(m[r], m_o);
      const float a = m[r] == m_n ? 1.f : __expf(m[r] - m_n);
      const float b = m_o == m_n ? 1.f : __expf(m_o - m_n);
      l[r] = l[r] * a + l_o * b;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[r][d] = acc[r][d] * a + __shfl_xor_sync(0xffffffffu, acc[r][d], off) * b;
      m[r] = m_n;
    }
    if (ln == 0 && tq[r] < T) {
      store_row<HD>(out + base + (long)tq[r] * D, acc[r], 1.f / l[r]);
      if (stats != nullptr)
        *reinterpret_cast<float2*>(stats + ((n * gridDim.y + h) * (long)T + tq[r]) * 2) = make_float2(m[r], l[r]);
    }
  }
}

template <int HD, bool KEEP>
int launch(const float* q, const float* k, const float* v, const unsigned char* mask, const unsigned char* keep,
           float* out, float* stats, int n, int t, int d, int nhead, float inv_keep, cudaStream_t stream) {
  const int tp = round_up(t, kGroup);
  const size_t smem = sizeof(float) * 2 * (size_t)padded_floats<HD>(tp) + tp;
  const cudaError_t e = allow_smem(attention_kernel<HD, KEEP>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((t + kTile - 1) / kTile, nhead, n);
  const float scale = 1.f / sqrtf((float)HD);
  const int keep_vec = KEEP && t % 16 == 0 && aligned16(keep);
  attention_kernel<HD, KEEP><<<grid, Shape<HD>::threads, smem, stream>>>(q, k, v, mask, keep, out, stats, t, d, scale,
                                                               inv_keep, keep_vec);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(const float* q, const float* k, const float* v, const unsigned char* mask,
              const unsigned char* keep, float* out, float* stats, int n, int t, int d, int nhead, float inv_keep,
              cudaStream_t stream) {
  return keep == nullptr ? launch<HD, false>(q, k, v, mask, keep, out, stats, n, t, d, nhead, inv_keep, stream)
                         : launch<HD, true>(q, k, v, mask, keep, out, stats, n, t, d, nhead, inv_keep, stream);
}

}  // namespace

// q, k, v, out: 16-byte aligned. stats may be null (nothing extra is written).
extern "C" int disco_attention(const float* q, const float* k, const float* v, const unsigned char* mask,
                               const unsigned char* keep, float* out, float* stats, int n, int t, int d,
                               int nhead, float inv_keep, void* stream) {
  if ((long)n * t == 0) return 0;
  if (nhead <= 0 || d % nhead != 0) return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out)) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  switch (d / nhead) {
    case 4: return launch_hd<4>(q, k, v, mask, keep, out, stats, n, t, d, nhead, inv_keep, s);
    case 8: return launch_hd<8>(q, k, v, mask, keep, out, stats, n, t, d, nhead, inv_keep, s);
    case 16: return launch_hd<16>(q, k, v, mask, keep, out, stats, n, t, d, nhead, inv_keep, s);
    case 32: return launch_hd<32>(q, k, v, mask, keep, out, stats, n, t, d, nhead, inv_keep, s);
    case 64: return launch_hd<64>(q, k, v, mask, keep, out, stats, n, t, d, nhead, inv_keep, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
