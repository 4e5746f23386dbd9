// Kernel D: multi-head attention core over the superpixel tokens.
//
// Replaces disentangledcolorization_tpu/ops/pallas_attention.py::fused_attention.
// q (N,Tq,D), k and v (N,Tk,D) f32 already projected, heads packed along D
// (hd = D / nhead); Tq = Tk in self-attention, Tq != Tk in the decoder's
// cross-attention:
//   out[n,t,h] = softmax_j((q[n,t,h] / sqrt(hd)) . k[n,j,h]) v[n,j,h]
// f32, max-subtracted. Optional key-padding mask (N,Tk) uint8: where it is
// non-zero the logit is replaced by -1e9, as models/transformer.py does.
// Optional dropout on the attention weights: a keep-mask (N,nhead,Tq,Tk) uint8
// and inv_keep = 1/(1-rate) give
//   out[n,t,h] = sum_j softmax_tj * keep[n,h,t,j] * inv_keep * v[n,j,h]
// which is flax nn.Dropout on the weights (transformer.py:57). The mask is
// drawn by the caller, so the kernel holds no random state.
// Optional second output, the softmax statistics (N,nhead,Tq,2) f32: the row
// max m of the logits and the row sum l of exp(s - m). csrc/attention_bwd.cu
// reads them instead of recomputing the softmax. The two are stored apart, not
// as m + log(l): a row whose keys are all masked has m = -1e9, where f32 has
// no room for log(l), and that row must stay uniform.
//
// Bound: operations. Per (n, head) 4 Tq Tk hd flops and Tq Tk exp against
// 2 (Tq + Tk) hd floats of traffic (2.1 MFLOP for 32 KB at T=256, hd=8). The
// heads are 8 wide, so a logit is a dot of depth 8.
// Tensor cores are not used: the contract is f32 within 1e-5, and wgmma and
// mma.sync take f32 inputs only as TF32 (about three decimal digits), which
// fails it; splitting each operand in two TF32 terms triples the products of
// a depth-8 dot. A tensor-core version belongs to bf16 inputs with f32
// accumulation and a tolerance of their own.
//
// Design (layout, register tile and ring in attention_common.cuh): a block
// owns 64 queries of one (head, n) and streams the head's K and V through a
// ring of kStages shared-memory tiles of L keys (a multiple of 64; the plan of
// ops/attention.py picks it), filled by 16-byte asynchronous copies one tile
// ahead, with the tile's key flags (mask, beyond Tk) beside it. Shared memory
// does not depend on Tk, so any token count runs. Each query's keys are split
// over 4 lanes; a lane keeps q, its own running max, running sum and hd
// accumulators in registers across all tiles (for two queries at hd = 8,
// which share every K and V row the thread loads) and walks its keys in
// chunks of 8: eight independent dots, one chunk max, at most one rescale of
// the accumulators, eight exp. The Tq x Tk logits never leave registers. Two
// shuffle rounds merge the four partial softmaxes (rescaled by
// exp(m_lane - m)). The keep-mask bytes of a lane's 16 keys come with one
// 16-byte load from device memory, fetched one step ahead (across a tile's
// end too); rows of a ragged Tk are not 16-byte aligned and take byte loads.
// A lane meets its keys in the same order at every L, so the result equals
// the one-tile design's (the whole head staged at once) bit for bit. Where
// one tile holds all the keys, a loop of its own walks them without the ring. The
// exponent is <= 0, where __expf's absolute error stays below 2e-7.
#include "attention_common.cuh"

namespace {

using namespace disco;

template <int HD, bool KEEP>
__global__ void __launch_bounds__(Shape<HD>::threads, Shape<HD>::min_blocks)
    attention_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const unsigned char* __restrict__ mask, const unsigned char* __restrict__ keep,
                     float* __restrict__ out, float* __restrict__ stats, int Tq, int Tk, int D, int L, float scale,
                     float inv_keep, int keep_vec) {
  constexpr int R = Shape<HD>::rows;
  extern __shared__ __align__(16) float sm[];
  const int stage_floats = kv_stage_floats<HD>(L);
  const long n = blockIdx.z;
  const int h = blockIdx.y;
  const long qbase = n * Tq * D + h * HD, kbase = n * Tk * D + h * HD;
  const unsigned char* mask_row = mask == nullptr ? nullptr : mask + n * Tk;
  // flags are read only where a key can be masked or missing
  const bool flagged = mask != nullptr || Tk % kGroup != 0;
  const int ntiles = (Tk + L - 1) / L;
  stage_kv_tile<HD>(sm, k + kbase, v + kbase, mask_row, flagged, 0, Tk, L, D);
  cp_async_commit();

  const int ln = threadIdx.x % kLanes;
  int tq[R];
  float qr[R][HD], acc[R][HD], m[R], l[R];
  const unsigned char* krow[R];
  uint32_t kw[R][4], fw[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int r = 0; r < R; ++r) {
    tq[r] = blockIdx.x * kTile + threadIdx.x / kLanes + r * Shape<HD>::row_step;
    const int tqc = min(tq[r], Tq - 1);  // a row past the last query computes a copy of it and stores nothing
    load_row<HD>(q + qbase + (long)tqc * D, qr[r]);
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      qr[r][d] *= scale;
      acc[r][d] = 0.f;
    }
    m[r] = -INFINITY, l[r] = 0.f;
    krow[r] = KEEP ? keep + ((n * gridDim.y + h) * (long)Tq + tqc) * Tk : nullptr;
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
      if (j0 + half * 8 < Tk) {  // its first key exists, so the chunk max is finite
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
  };

  if (ntiles == 1) {
    // The whole head in one stage (the path's T = 256): the one-tile design's loop, which the compiler
    // software-pipelines (the next step's shared loads overlap this step's arithmetic). Inside the tile loop
    // below it does not, and T = 256 takes longer that way (`tools/bench_attention.py --sass`, its
    // `d_ring_at_one_tile` variant).
    cp_async_wait<0>();
    __syncthreads();
    const float* sv = sm + padded_floats<HD>(L);
    for (int j0 = ln * kGroup; j0 < Tk; j0 += kLanes * kGroup)
      step(sm, sv, reinterpret_cast<const unsigned char*>(sv + padded_floats<HD>(L)), j0, j0);
  } else {
    for (int tile = 0; tile < ntiles; ++tile) {
      const int jt = tile * L;
      if (tile + 1 < ntiles)
        stage_kv_tile<HD>(sm + ((tile + 1) % kStages) * stage_floats, k + kbase, v + kbase, mask_row, flagged, jt + L,
                          Tk, L, D);
      cp_async_commit();
      cp_async_wait<1>();  // this thread's copies of tile `tile` have landed
      __syncthreads();     // and everyone's
      const float* sk = sm + (tile % kStages) * stage_floats;
      const float* sv = sk + padded_floats<HD>(L);
      const unsigned char* sflag = reinterpret_cast<const unsigned char*>(sv + padded_floats<HD>(L));
      for (int jl = ln * kGroup; jl < L && jt + jl < Tk; jl += kLanes * kGroup) step(sk, sv, sflag, jl, jt + jl);
      __syncthreads();  // the stage is refilled by the next iteration's copies
    }
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
    if (ln == 0 && tq[r] < Tq) {
      store_row<HD>(out + qbase + (long)tq[r] * D, acc[r], 1.f / l[r]);
      if (stats != nullptr)
        *reinterpret_cast<float2*>(stats + ((n * gridDim.y + h) * (long)Tq + tq[r]) * 2) = make_float2(m[r], l[r]);
    }
  }
}

template <int HD, bool KEEP>
int launch(const float* q, const float* k, const float* v, const unsigned char* mask, const unsigned char* keep,
           float* out, float* stats, int n, int tq, int tk, int d, int nhead, int tile, float inv_keep,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)kStages * kv_stage_floats<HD>(tile);
  const cudaError_t e = allow_smem(attention_kernel<HD, KEEP>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((tq + kTile - 1) / kTile, nhead, n);
  const float scale = 1.f / sqrtf((float)HD);
  const int keep_vec = KEEP && tk % 16 == 0 && aligned16(keep);
  attention_kernel<HD, KEEP><<<grid, Shape<HD>::threads, smem, stream>>>(q, k, v, mask, keep, out, stats, tq, tk, d,
                                                                         tile, scale, inv_keep, keep_vec);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(const float* q, const float* k, const float* v, const unsigned char* mask,
              const unsigned char* keep, float* out, float* stats, int n, int tq, int tk, int d, int nhead, int tile,
              float inv_keep, cudaStream_t stream) {
  return keep == nullptr
             ? launch<HD, false>(q, k, v, mask, keep, out, stats, n, tq, tk, d, nhead, tile, inv_keep, stream)
             : launch<HD, true>(q, k, v, mask, keep, out, stats, n, tq, tk, d, nhead, tile, inv_keep, stream);
}

}  // namespace

// q, out (n, tq, d); k, v (n, tk, d); all 16-byte aligned. stats may be null
// (nothing extra is written). tile: keys a ring stage holds, a positive
// multiple of 64 (ops/attention.py::attention_plan).
extern "C" int disco_attention(const float* q, const float* k, const float* v, const unsigned char* mask,
                               const unsigned char* keep, float* out, float* stats, int n, int tq, int tk, int d,
                               int nhead, int tile, float inv_keep, void* stream) {
  if ((long)n * tq == 0) return 0;
  if (nhead <= 0 || d % nhead != 0 || tk <= 0 || tile <= 0 || tile % (kLanes * kGroup) != 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out)) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  switch (d / nhead) {
    case 4: return launch_hd<4>(q, k, v, mask, keep, out, stats, n, tq, tk, d, nhead, tile, inv_keep, s);
    case 8: return launch_hd<8>(q, k, v, mask, keep, out, stats, n, tq, tk, d, nhead, tile, inv_keep, s);
    case 16: return launch_hd<16>(q, k, v, mask, keep, out, stats, n, tq, tk, d, nhead, tile, inv_keep, s);
    case 32: return launch_hd<32>(q, k, v, mask, keep, out, stats, n, tq, tk, d, nhead, tile, inv_keep, s);
    case 64: return launch_hd<64>(q, k, v, mask, keep, out, stats, n, tq, tk, d, nhead, tile, inv_keep, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
