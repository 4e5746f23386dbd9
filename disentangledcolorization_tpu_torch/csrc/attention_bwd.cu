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
// f32 throughout. The softmax is not recomputed: kernel D saved, per row, the
// max m_i and the sum l_i, so P_ij = exp(s_ij - m_i) / l_i takes one exp, and
// 1 / l_i is taken once per row. D_i needs no pass over the keys either: with
// O_i = sum_j P_ij K_ij v_j (kernel D's output, keep-mask included),
// D_i = sum_j P_ij K_ij (dO_i . v_j) = dO_i . O_i, hd multiply-adds. So each
// logit is computed twice per (query, key) pair, once in each phase below.
//
// Bound: operations (about 10 T^2 hd flops per head against 7 T hd floats and
// T^2 keep-mask bytes of traffic; 5.2 MFLOP for 57 KB + 64 KB at T=256, hd=8).
// Tensor cores are not used, for the reason given in csrc/attention.cu: the
// f32 contract (2e-5 here) excludes TF32, the only way f32 enters wgmma or
// mma.sync, and a split in two TF32 terms triples the products of a depth-8
// dot. A tensor-core backward belongs to bf16 inputs with f32 accumulation.
//
// Design (layout and register tile in attention_common.cuh): two kernels
// launched one after the other by one entry point, each over a grid
// (tile, head, n); a tile is 64 rows, and each row has 4 lanes. At hd = 8 a
// thread owns two rows of the tile, which share every row it loads from
// shared memory.
//   dq phase: a block owns 64 queries and stages the head's K and V as kernel
//   D does. A lane keeps q, dO and a partial dq per row in registers (3 hd),
//   walks the keys of its quarter in chunks of 8, and two shuffle rounds add
//   the partials. Its 16 keep-mask bytes per step come with one 16-byte load.
//   dk/dv phase: a block owns 64 keys and stages Q, dO and (m, 1/l, D) of all
//   queries, and its T x 64 tile of the keep-mask, with 16-byte copies. A lane
//   keeps k (scaled), v and partial dk, dv per row in registers (4 hd) and
//   walks the queries i = lane, lane + 4, ...: the four lanes read four
//   consecutive staged rows. Two shuffle rounds add the partials.
// Nothing crosses blocks and there are no atomics: the result is
// deterministic. The exponent is <= 0 wherever the weight is used, where
// __expf's absolute error stays below 2e-7.
#include <initializer_list>

#include "attention_common.cuh"

namespace {

using namespace disco;

template <int HD, bool KEEP>
__global__ void __launch_bounds__(Shape<HD>::threads, Shape<HD>::min_blocks)
    attention_bwd_kernel_dq(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                            const float* __restrict__ dout, const float* __restrict__ out,
                            const float* __restrict__ stats, const unsigned char* __restrict__ mask,
                            const unsigned char* __restrict__ keep, float* __restrict__ dq, int T, int D,
                            float scale, float inv_keep, int keep_vec) {
  constexpr int R = Shape<HD>::rows;
  extern __shared__ __align__(16) float sm[];
  const int Tp = round_up(T, kGroup);
  float* sk = sm;
  float* sv = sk + padded_floats<HD>(Tp);
  unsigned char* sflag = reinterpret_cast<unsigned char*>(sv + padded_floats<HD>(Tp));
  const long n = blockIdx.z;
  const int h = blockIdx.y;
  const long base = n * T * D + h * HD;
  const bool flagged = mask != nullptr || Tp != T;
  stage_padded<HD>(sk, k + base, T, Tp, D);
  stage_padded<HD>(sv, v + base, T, Tp, D);
  if (flagged) stage_flags(sflag, mask == nullptr ? nullptr : mask + n * T, T, Tp);

  const int ln = threadIdx.x % kLanes;
  int tq[R];
  float qr[R][HD], dor[R][HD], acc[R][HD], del[R], m[R], inv_l[R];
  const unsigned char* krow[R];
  uint32_t kw[R][4], fw[4] = {0u, 0u, 0u, 0u};
  int j0 = ln * kGroup;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    tq[r] = blockIdx.x * kTile + threadIdx.x / kLanes + r * Shape<HD>::row_step;
    const int tqc = min(tq[r], T - 1);  // a row past the last query computes a copy of it and stores nothing
    const long row = (n * gridDim.y + h) * (long)T + tqc;
    load_row<HD>(q + base + (long)tqc * D, qr[r]);
    load_row<HD>(dout + base + (long)tqc * D, dor[r]);
    load_row<HD>(out + base + (long)tqc * D, acc[r]);
    del[r] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      del[r] = fmaf(dor[r][d], acc[r][d], del[r]);
      qr[r][d] *= scale;
      acc[r][d] = 0.f;
    }
    const float2 st = __ldg(reinterpret_cast<const float2*>(stats) + row);
    m[r] = st.x, inv_l[r] = 1.f / st.y;
    krow[r] = KEEP ? keep + row * T : nullptr;
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
      if (j0 + half * 8 < T) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int b = half * 8 + i;
          float kx[HD], vx[HD];
          lds_row<HD>(kp + b * HD, kx);
          lds_row<HD>(vp + b * HD, vx);
          // a masked or missing key gets no gradient through its logit, so its
          // weight is not needed (and s - m is not <= 0 there)
          const bool live = !flagged || byte_of(fw, b) == 0u;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float s = dot<HD>(qr[r], kx);
            float dp = dot<HD>(dor[r], vx);
            if (KEEP) dp = byte_of(kw[r], b) != 0u ? dp * inv_keep : 0.f;
            const float ds = __expf(s - m[r]) * inv_l[r] * (dp - del[r]);
            axpy<HD>(live ? ds : 0.f, kx, acc[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int w = 0; w < 4; ++w) kw[r][w] = kw_next[r][w];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    lanes_sum<HD>(acc[r]);
    if (ln == 0 && tq[r] < T) store_row<HD>(dq + base + (long)tq[r] * D, acc[r], scale);
  }
}

// position of keep-mask byte (query i, key jj of the tile) in the staged
// T x 64 tile: the four 16-byte chunks of a row are swapped by the row's bits
// 1-2, so that the four lanes' rows i..i+3 fall into different banks
__device__ __forceinline__ int tile_pos(int i, int jj) {
  return i * kTile + ((((jj >> 4) ^ (i >> 1)) & 3) << 4) + (jj & 15);
}

template <int HD, bool KEEP>
__global__ void __launch_bounds__(Shape<HD>::threads, Shape<HD>::min_blocks)
    attention_bwd_kernel_dkv(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                             const float* __restrict__ dout, const float* __restrict__ out,
                             const float* __restrict__ stats, const unsigned char* __restrict__ mask,
                             const unsigned char* __restrict__ keep, float* __restrict__ dk,
                             float* __restrict__ dv, int T, int D, float scale, float inv_keep, int keep_vec) {
  constexpr int R = Shape<HD>::rows;
  extern __shared__ __align__(16) float sm[];
  const int Tq = round_up(T, kLanes);  // staged query rows; rows past T are zero and add nothing
  float* sq = sm;                      // Tq * HD, unscaled
  float* sdo = sq + Tq * HD;           // Tq * HD
  float4* sst = reinterpret_cast<float4*>(sdo + Tq * HD);  // Tq of (m, 1/l, D, 0)
  unsigned char* skeep = reinterpret_cast<unsigned char*>(sst + Tq);  // Tq * 64 bytes
  const long n = blockIdx.z;
  const int h = blockIdx.y;
  const long base = n * T * D + h * HD;
  const long rows = (n * gridDim.y + h) * (long)T;
  const int jt = blockIdx.x * kTile;  // first key of the tile

  constexpr int V = HD / 4;
  for (int e = threadIdx.x; e < Tq * V; e += blockDim.x) {
    const int t = e / V, c = (e - t * V) * 4;
    if (t < T) {
      cp_async16(sq + t * HD + c, q + base + (long)t * D + c);
      cp_async16(sdo + t * HD + c, dout + base + (long)t * D + c);
    } else {
      *reinterpret_cast<float4*>(sq + t * HD + c) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(sdo + t * HD + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  if (KEEP) {
    for (int e = threadIdx.x; e < Tq * 4; e += blockDim.x) {
      const int i = e >> 2, c = e & 3;
      unsigned char* dst = skeep + tile_pos(i, c * 16);
      const int j = jt + c * 16;
      if (i < T && j < T) {
        const unsigned char* src = keep + (rows + i) * T + j;
        if (keep_vec) {
          cp_async16(dst, src);
        } else {
          uint32_t w[4];
          load_bytes16(src, T - j, false, w);
          *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
        }
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
  for (int i = threadIdx.x; i < Tq; i += blockDim.x) {
    float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < T) {
      float a[HD], b[HD];
      load_row<HD>(dout + base + (long)i * D, a);
      load_row<HD>(out + base + (long)i * D, b);
      const float2 st = __ldg(reinterpret_cast<const float2*>(stats) + rows + i);
      s4 = make_float4(st.x, 1.f / st.y, dot<HD>(a, b), 0.f);
    }
    sst[i] = s4;
  }

  const int ln = threadIdx.x % kLanes;
  int jj[R];
  float kr[R][HD], vr[R][HD], dkr[R][HD], dvr[R][HD];
  bool masked[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    jj[r] = threadIdx.x / kLanes + r * Shape<HD>::row_step;
    const int jc = min(jt + jj[r], T - 1);  // a row past the last key computes a copy of it and stores nothing
    load_row<HD>(k + base + (long)jc * D, kr[r]);
    load_row<HD>(v + base + (long)jc * D, vr[r]);
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      kr[r][d] *= scale;
      dkr[r][d] = 0.f;
      dvr[r][d] = 0.f;
    }
    masked[r] = mask != nullptr && mask[n * T + jc] != 0;
  }
  cp_async_wait_all();
  __syncthreads();

#pragma unroll 2
  for (int i = ln; i < Tq; i += kLanes) {
    const float4 st = sst[i];
    float qx[HD], dox[HD];
    lds_row<HD>(sq + i * HD, qx);
    lds_row<HD>(sdo + i * HD, dox);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float s = masked[r] ? -1e9f : dot<HD>(kr[r], qx);
      float dp = dot<HD>(vr[r], dox);
      const float p = __expf(s - st.x) * st.y;
      float pk = p;
      if (KEEP) {
        const bool kept = skeep[tile_pos(i, jj[r])] != 0;
        pk = kept ? p * inv_keep : 0.f;
        dp = kept ? dp * inv_keep : 0.f;
      }
      const float ds = masked[r] ? 0.f : p * (dp - st.z);
      axpy<HD>(pk, dox, dvr[r]);
      axpy<HD>(ds, qx, dkr[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    lanes_sum<HD>(dkr[r]);
    lanes_sum<HD>(dvr[r]);
    const int j = jt + jj[r];
    if (j < T) {
      if (ln == 0) store_row<HD>(dk + base + (long)j * D, dkr[r], scale);
      if (ln == 1) store_row<HD>(dv + base + (long)j * D, dvr[r], 1.f);
    }
  }
}

template <int HD, bool KEEP>
int launch(const float* q, const float* k, const float* v, const float* dout, const float* out,
           const float* stats, const unsigned char* mask, const unsigned char* keep, float* dq, float* dk,
           float* dv, int n, int t, int d, int nhead, float inv_keep, cudaStream_t stream) {
  const int tp = round_up(t, kGroup), tq = round_up(t, kLanes);
  const size_t smem_dq = sizeof(float) * 2 * (size_t)padded_floats<HD>(tp) + tp;
  const size_t smem_dkv = sizeof(float) * 2 * (size_t)tq * HD + (size_t)tq * (16 + (KEEP ? kTile : 0));
  cudaError_t e = allow_smem(attention_bwd_kernel_dq<HD, KEEP>, smem_dq);
  if (e == cudaSuccess) e = allow_smem(attention_bwd_kernel_dkv<HD, KEEP>, smem_dkv);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((t + kTile - 1) / kTile, nhead, n);
  const float scale = 1.f / sqrtf((float)HD);
  const int keep_vec = KEEP && t % 16 == 0 && aligned16(keep);
  attention_bwd_kernel_dq<HD, KEEP><<<grid, Shape<HD>::threads, smem_dq, stream>>>(q, k, v, dout, out, stats, mask, keep, dq,
                                                                        t, d, scale, inv_keep, keep_vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attention_bwd_kernel_dkv<HD, KEEP><<<grid, Shape<HD>::threads, smem_dkv, stream>>>(q, k, v, dout, out, stats, mask, keep,
                                                                          dk, dv, t, d, scale, inv_keep, keep_vec);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(const float* q, const float* k, const float* v, const float* dout, const float* out,
              const float* stats, const unsigned char* mask, const unsigned char* keep, float* dq, float* dk,
              float* dv, int n, int t, int d, int nhead, float inv_keep, cudaStream_t stream) {
  return keep == nullptr
             ? launch<HD, false>(q, k, v, dout, out, stats, mask, keep, dq, dk, dv, n, t, d, nhead, inv_keep, stream)
             : launch<HD, true>(q, k, v, dout, out, stats, mask, keep, dq, dk, dv, n, t, d, nhead, inv_keep, stream);
}

}  // namespace

// out and stats are kernel D's two outputs for the same q, k, v, masks and
// inv_keep. All float tensors 16-byte aligned.
extern "C" int disco_attention_bwd(const float* q, const float* k, const float* v, const float* dout,
                                   const float* out, const float* stats, const unsigned char* mask,
                                   const unsigned char* keep, float* dq, float* dk, float* dv, int n, int t,
                                   int d, int nhead, float inv_keep, void* stream) {
  if ((long)n * t == 0) return 0;
  if (nhead <= 0 || d % nhead != 0 || out == nullptr || stats == nullptr) return (int)cudaErrorInvalidValue;
  for (const void* p : {(const void*)q, (const void*)k, (const void*)v, (const void*)dout, (const void*)out,
                        (const void*)stats, (const void*)dq, (const void*)dk, (const void*)dv})
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  switch (d / nhead) {
    case 8: return launch_hd<8>(q, k, v, dout, out, stats, mask, keep, dq, dk, dv, n, t, d, nhead, inv_keep, s);
    case 16: return launch_hd<16>(q, k, v, dout, out, stats, mask, keep, dq, dk, dv, n, t, d, nhead, inv_keep, s);
    case 32: return launch_hd<32>(q, k, v, dout, out, stats, mask, keep, dq, dk, dv, n, t, d, nhead, inv_keep, s);
    case 64: return launch_hd<64>(q, k, v, dout, out, stats, mask, keep, dq, dk, dv, n, t, d, nhead, inv_keep, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
