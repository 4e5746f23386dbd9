// Backward of kernel D: gradients of the attention core w.r.t. q, k and v.
//
// The JAX package differentiates the attention core with XLA's autodiff
// (models/transformer.py:50-58); ops/pallas_attention.py::fused_attention
// has no backward. This kernel is that gradient for the port's kernel D
// (csrc/attention.cu), with the same optional key-padding mask (logit -1e9)
// and the same optional dropout keep-mask (N,nhead,Tq,Tk) uint8 with
// inv_keep = 1/(1-rate); q, dO and dq are (N,Tq,D), k, v, dk and dv
// (N,Tk,D). Per (n, head), with s_ij = (scale q_i) . k_j,
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
// Bound: operations (about 10 Tq Tk hd flops per head against (4 Tq + 4 Tk) hd
// floats, 2 Tq statistics and Tq Tk keep-mask bytes of traffic; 5.2 MFLOP for
// 66 KB + 64 KB at T=256, hd=8).
// Tensor cores are not used, for the reason given in csrc/attention.cu: the
// f32 contract (2e-5 here) excludes TF32, the only way f32 enters wgmma or
// mma.sync, and a split in two TF32 terms triples the products of a depth-8
// dot. A tensor-core backward belongs to bf16 inputs with f32 accumulation.
//
// Design (layout, register tile and ring in attention_common.cuh): two
// kernels launched one after the other by one entry point, each over a grid
// (tile, head, n); a tile is 64 rows, and each row has 4 lanes. At hd = 8 a
// thread owns two rows of the tile, which share every row it loads from
// shared memory. Each streams the other dimension through a ring of kStages
// shared-memory tiles filled one tile ahead by 16-byte asynchronous copies,
// so shared memory does not depend on Tq or Tk.
//   dq phase: a block owns 64 queries and streams the head's K and V in tiles
//   of L keys with their flags, as kernel D does. A lane keeps q, dO and a
//   partial dq per row in registers (3 hd), walks the keys of its quarter in
//   chunks of 8, and two shuffle rounds add the partials. Its 16 keep-mask
//   bytes per step come with one 16-byte load.
//   dk/dv phase: a block owns 64 keys and streams tiles of Lq queries: their
//   Q and dO rows, their (m, 1/l, D) and their Lq x 64 tile of the
//   keep-mask. A lane keeps k (scaled), v and partial dk, dv per row in
//   registers (4 hd) and walks the queries i = lane, lane + 4, ...: the four
//   lanes read four consecutive staged rows. Two shuffle rounds add the
//   partials.
// L and Lq are multiples of 64, so a lane meets its keys (or queries) in the
// same order at every tile length, and the gradients equal the one-tile
// design's (a head's K, V or Q, dO staged whole) bit for bit.
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
                            const unsigned char* __restrict__ keep, float* __restrict__ dq, int Tq, int Tk, int D,
                            int L, float scale, float inv_keep, int keep_vec) {
  constexpr int R = Shape<HD>::rows;
  extern __shared__ __align__(16) float sm[];
  const int stage_floats = kv_stage_floats<HD>(L);
  const long n = blockIdx.z;
  const int h = blockIdx.y;
  const long qbase = n * Tq * D + h * HD, kbase = n * Tk * D + h * HD;
  const unsigned char* mask_row = mask == nullptr ? nullptr : mask + n * Tk;
  const bool flagged = mask != nullptr || Tk % kGroup != 0;
  const int ntiles = (Tk + L - 1) / L;
  stage_kv_tile<HD>(sm, k + kbase, v + kbase, mask_row, flagged, 0, Tk, L, D);
  cp_async_commit();

  const int ln = threadIdx.x % kLanes;
  int tq[R];
  float qr[R][HD], dor[R][HD], acc[R][HD], del[R], m[R], inv_l[R];
  const unsigned char* krow[R];
  uint32_t kw[R][4], fw[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int r = 0; r < R; ++r) {
    tq[r] = blockIdx.x * kTile + threadIdx.x / kLanes + r * Shape<HD>::row_step;
    const int tqc = min(tq[r], Tq - 1);  // a row past the last query computes a copy of it and stores nothing
    const long row = (n * gridDim.y + h) * (long)Tq + tqc;
    load_row<HD>(q + qbase + (long)tqc * D, qr[r]);
    load_row<HD>(dout + qbase + (long)tqc * D, dor[r]);
    load_row<HD>(out + qbase + (long)tqc * D, acc[r]);
    del[r] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      del[r] = fmaf(dor[r][d], acc[r][d], del[r]);
      qr[r][d] *= scale;
      acc[r][d] = 0.f;
    }
    const float2 st = __ldg(reinterpret_cast<const float2*>(stats) + row);
    m[r] = st.x, inv_l[r] = 1.f / st.y;
    krow[r] = KEEP ? keep + row * Tk : nullptr;
    kw[r][0] = kw[r][1] = kw[r][2] = kw[r][3] = 0u;
    if (KEEP && ln * kGroup < Tk) load_bytes16(krow[r] + ln * kGroup, Tk - ln * kGroup, keep_vec != 0, kw[r]);
  }

  // One step of a lane: its 16 keys from j0 (jl within the stage at sk, sv, sflag), as two chunks of 8.
  auto step = [&](const float* sk, const float* sv, const unsigned char* sflag, int jl, int j0) {
    uint32_t kw_next[R][4];
    const int j1 = j0 + kLanes * kGroup;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      kw_next[r][0] = kw_next[r][1] = kw_next[r][2] = kw_next[r][3] = 0u;
      if (KEEP && j1 < Tk) load_bytes16(krow[r] + j1, Tk - j1, keep_vec != 0, kw_next[r]);
    }
    if (flagged) {
      const uint4 f = *reinterpret_cast<const uint4*>(sflag + jl);
      fw[0] = f.x, fw[1] = f.y, fw[2] = f.z, fw[3] = f.w;
    }
    const float* kp = sk + padded_row<HD>(jl);
    const float* vp = sv + padded_row<HD>(jl);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (j0 + half * 8 < Tk) {
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
  };

  if (ntiles == 1) {  // the whole head in one stage: the one-tile loop, as in kernel D (csrc/attention.cu)
    cp_async_wait<0>();
    __syncthreads();
    const float* sv = sm + padded_floats<HD>(L);
    for (int j0 = ln * kGroup; j0 < Tk; j0 += kLanes * kGroup)
      step(sm, sv, reinterpret_cast<const unsigned char*>(sv + padded_floats<HD>(L)), j0, j0);
  } else {
    for (int tile = 0; tile < ntiles; ++tile) {
      const int jt = tile * L;
      if (tile + 1 < ntiles)
        stage_kv_tile<HD>(sm + ((tile + 1) % kStages) * stage_floats, k + kbase, v + kbase, mask_row, flagged,
                          jt + L, Tk, L, D);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const float* sk = sm + (tile % kStages) * stage_floats;
      const float* sv = sk + padded_floats<HD>(L);
      const unsigned char* sflag = reinterpret_cast<const unsigned char*>(sv + padded_floats<HD>(L));
      for (int jl = ln * kGroup; jl < L && jt + jl < Tk; jl += kLanes * kGroup) step(sk, sv, sflag, jl, jt + jl);
      __syncthreads();
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    lanes_sum<HD>(acc[r]);
    if (ln == 0 && tq[r] < Tq) store_row<HD>(dq + qbase + (long)tq[r] * D, acc[r], scale);
  }
}

// position of keep-mask byte (query i of the tile, key jj of the block's 64)
// in the staged Lq x 64 tile: the four 16-byte chunks of a row are swapped by
// the row's bits 1-2, so that the four lanes' rows i..i+3 fall into different
// banks
__device__ __forceinline__ int tile_pos(int i, int jj) {
  return i * kTile + ((((jj >> 4) ^ (i >> 1)) & 3) << 4) + (jj & 15);
}

// floats of one ring stage of the dk/dv phase: Q and dO of Lq queries, their
// (m, 1/l, D, 0), and with a keep-mask its Lq x 64 bytes
template <int HD, bool KEEP>
__host__ __device__ inline int dkv_stage_floats(int Lq) {
  return Lq * (2 * HD + 4) + (KEEP ? Lq * kTile / 4 : 0);
}

// One ring stage of the dk/dv phase: queries [i0, i0 + Lq) of one head
// (q and dout point at the head's query 0, `rows` is the head's first row of
// the statistics and the keep-mask, jt the block's first key). Rows past Tq
// are zero and add nothing.
template <int HD, bool KEEP>
__device__ __forceinline__ void stage_q_tile(float* stage, const float* __restrict__ q,
                                             const float* __restrict__ dout, const float* __restrict__ out,
                                             const float* __restrict__ stats, const unsigned char* __restrict__ keep,
                                             long rows, int i0, int jt, int Tq, int Tk, int Lq, int D, int keep_vec) {
  constexpr int V = HD / 4;
  float* sq = stage;                                       // Lq * HD, unscaled
  float* sdo = sq + Lq * HD;                               // Lq * HD
  float4* sst = reinterpret_cast<float4*>(sdo + Lq * HD);  // Lq of (m, 1/l, D, 0)
  unsigned char* skeep = reinterpret_cast<unsigned char*>(sst + Lq);  // Lq * 64 bytes
  for (int e = threadIdx.x; e < Lq * V; e += blockDim.x) {
    const int t = e / V, c = (e - t * V) * 4;
    const int i = i0 + t;
    if (i < Tq) {
      cp_async16(sq + t * HD + c, q + (long)i * D + c);
      cp_async16(sdo + t * HD + c, dout + (long)i * D + c);
    } else {
      *reinterpret_cast<float4*>(sq + t * HD + c) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(sdo + t * HD + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  if (KEEP) {
    for (int e = threadIdx.x; e < Lq * 4; e += blockDim.x) {
      const int t = e >> 2, c = e & 3;
      unsigned char* dst = skeep + tile_pos(t, c * 16);
      const int i = i0 + t, j = jt + c * 16;
      if (i < Tq && j < Tk) {
        const unsigned char* src = keep + (rows + i) * Tk + j;
        if (keep_vec) {
          cp_async16(dst, src);
        } else {
          uint32_t w[4];
          load_bytes16(src, Tk - j, false, w);
          *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
        }
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
  for (int t = threadIdx.x; t < Lq; t += blockDim.x) {
    const int i = i0 + t;
    float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < Tq) {
      float a[HD], b[HD];
      load_row<HD>(dout + (long)i * D, a);
      load_row<HD>(out + (long)i * D, b);
      const float2 st = __ldg(reinterpret_cast<const float2*>(stats) + rows + i);
      s4 = make_float4(st.x, 1.f / st.y, dot<HD>(a, b), 0.f);
    }
    sst[t] = s4;
  }
}

template <int HD, bool KEEP>
__global__ void __launch_bounds__(Shape<HD>::threads, Shape<HD>::min_blocks)
    attention_bwd_kernel_dkv(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                             const float* __restrict__ dout, const float* __restrict__ out,
                             const float* __restrict__ stats, const unsigned char* __restrict__ mask,
                             const unsigned char* __restrict__ keep, float* __restrict__ dk,
                             float* __restrict__ dv, int Tq, int Tk, int D, int Lq, float scale, float inv_keep,
                             int keep_vec) {
  constexpr int R = Shape<HD>::rows;
  extern __shared__ __align__(16) float sm[];
  const int stage_floats = dkv_stage_floats<HD, KEEP>(Lq);
  const int Tq4 = round_up(Tq, kLanes);  // query rows walked; rows past Tq are zero and add nothing
  const long n = blockIdx.z;
  const int h = blockIdx.y;
  const long qbase = n * Tq * D + h * HD, kbase = n * Tk * D + h * HD;
  const long rows = (n * gridDim.y + h) * (long)Tq;
  const int jt = blockIdx.x * kTile;  // first key of the tile
  const int ntiles = (Tq + Lq - 1) / Lq;
  stage_q_tile<HD, KEEP>(sm, q + qbase, dout + qbase, out + qbase, stats, keep, rows, 0, jt, Tq, Tk, Lq, D, keep_vec);
  cp_async_commit();

  const int ln = threadIdx.x % kLanes;
  int jj[R];
  float kr[R][HD], vr[R][HD], dkr[R][HD], dvr[R][HD];
  bool masked[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    jj[r] = threadIdx.x / kLanes + r * Shape<HD>::row_step;
    const int jc = min(jt + jj[r], Tk - 1);  // a row past the last key computes a copy of it and stores nothing
    load_row<HD>(k + kbase + (long)jc * D, kr[r]);
    load_row<HD>(v + kbase + (long)jc * D, vr[r]);
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      kr[r][d] *= scale;
      dkr[r][d] = 0.f;
      dvr[r][d] = 0.f;
    }
    masked[r] = mask != nullptr && mask[n * Tk + jc] != 0;
  }

  for (int tile = 0; tile < ntiles; ++tile) {
    const int i0 = tile * Lq;
    if (tile + 1 < ntiles)
      stage_q_tile<HD, KEEP>(sm + ((tile + 1) % kStages) * stage_floats, q + qbase, dout + qbase, out + qbase, stats,
                             keep, rows, i0 + Lq, jt, Tq, Tk, Lq, D, keep_vec);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* sq = sm + (tile % kStages) * stage_floats;
    const float* sdo = sq + Lq * HD;
    const float4* sst = reinterpret_cast<const float4*>(sdo + Lq * HD);
    const unsigned char* skeep = reinterpret_cast<const unsigned char*>(sst + Lq);
    const int rows_here = min(Lq, Tq4 - i0);
#pragma unroll 2
    for (int i = ln; i < rows_here; i += kLanes) {
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
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    lanes_sum<HD>(dkr[r]);
    lanes_sum<HD>(dvr[r]);
    const int j = jt + jj[r];
    if (j < Tk) {
      if (ln == 0) store_row<HD>(dk + kbase + (long)j * D, dkr[r], scale);
      if (ln == 1) store_row<HD>(dv + kbase + (long)j * D, dvr[r], 1.f);
    }
  }
}

struct Dims {
  int n, tq, tk, d, nhead, tile, q_tile;
};

template <int HD, bool KEEP>
int launch(const float* q, const float* k, const float* v, const float* dout, const float* out,
           const float* stats, const unsigned char* mask, const unsigned char* keep, float* dq, float* dk,
           float* dv, Dims s, float inv_keep, cudaStream_t stream) {
  const size_t smem_dq = sizeof(float) * (size_t)kStages * kv_stage_floats<HD>(s.tile);
  const size_t smem_dkv = sizeof(float) * (size_t)kStages * dkv_stage_floats<HD, KEEP>(s.q_tile);
  cudaError_t e = allow_smem(attention_bwd_kernel_dq<HD, KEEP>, smem_dq);
  if (e == cudaSuccess) e = allow_smem(attention_bwd_kernel_dkv<HD, KEEP>, smem_dkv);
  if (e != cudaSuccess) return (int)e;
  const float scale = 1.f / sqrtf((float)HD);
  const int keep_vec = KEEP && s.tk % 16 == 0 && aligned16(keep);
  const dim3 grid_dq((s.tq + kTile - 1) / kTile, s.nhead, s.n), grid_dkv((s.tk + kTile - 1) / kTile, s.nhead, s.n);
  attention_bwd_kernel_dq<HD, KEEP><<<grid_dq, Shape<HD>::threads, smem_dq, stream>>>(
      q, k, v, dout, out, stats, mask, keep, dq, s.tq, s.tk, s.d, s.tile, scale, inv_keep, keep_vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attention_bwd_kernel_dkv<HD, KEEP><<<grid_dkv, Shape<HD>::threads, smem_dkv, stream>>>(
      q, k, v, dout, out, stats, mask, keep, dk, dv, s.tq, s.tk, s.d, s.q_tile, scale, inv_keep, keep_vec);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(const float* q, const float* k, const float* v, const float* dout, const float* out,
              const float* stats, const unsigned char* mask, const unsigned char* keep, float* dq, float* dk,
              float* dv, Dims s, float inv_keep, cudaStream_t stream) {
  return keep == nullptr
             ? launch<HD, false>(q, k, v, dout, out, stats, mask, keep, dq, dk, dv, s, inv_keep, stream)
             : launch<HD, true>(q, k, v, dout, out, stats, mask, keep, dq, dk, dv, s, inv_keep, stream);
}

}  // namespace

// out and stats are kernel D's two outputs for the same q, k, v, masks and
// inv_keep. q, dout, out, dq (n, tq, d); k, v, dk, dv (n, tk, d); all float
// tensors 16-byte aligned. tile: keys a ring stage of the dq phase holds;
// q_tile: queries a ring stage of the dk/dv phase holds; both positive
// multiples of 64 (ops/attention.py::attention_plan).
extern "C" int disco_attention_bwd(const float* q, const float* k, const float* v, const float* dout,
                                   const float* out, const float* stats, const unsigned char* mask,
                                   const unsigned char* keep, float* dq, float* dk, float* dv, int n, int tq, int tk,
                                   int d, int nhead, int tile, int q_tile, float inv_keep, void* stream) {
  if ((long)n * tq * tk == 0) return 0;
  if (nhead <= 0 || d % nhead != 0 || out == nullptr || stats == nullptr) return (int)cudaErrorInvalidValue;
  if (tile <= 0 || q_tile <= 0 || tile % (kLanes * kGroup) != 0 || q_tile % (kLanes * kGroup) != 0)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {(const void*)q, (const void*)k, (const void*)v, (const void*)dout, (const void*)out,
                        (const void*)stats, (const void*)dq, (const void*)dk, (const void*)dv})
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  const Dims dims{n, tq, tk, d, nhead, tile, q_tile};
  switch (d / nhead) {
    case 4: return launch_hd<4>(q, k, v, dout, out, stats, mask, keep, dq, dk, dv, dims, inv_keep, s);
    case 8: return launch_hd<8>(q, k, v, dout, out, stats, mask, keep, dq, dk, dv, dims, inv_keep, s);
    case 16: return launch_hd<16>(q, k, v, dout, out, stats, mask, keep, dq, dk, dv, dims, inv_keep, s);
    case 32: return launch_hd<32>(q, k, v, dout, out, stats, mask, keep, dq, dk, dv, dims, inv_keep, s);
    case 64: return launch_hd<64>(q, k, v, dout, out, stats, mask, keep, dq, dk, dv, dims, inv_keep, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
