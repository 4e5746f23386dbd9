// Kernel E: soft encoding of ab chrominance onto the 313-bin color vocabulary.
//
// Replaces disentangledcolorization_tpu/ops/pallas_colorlabel.py::encode_ab2ind.
// For every pixel of ab (M, 2) (normalized, scaled here by 110 to real units):
//   d2[b]  = (a - bin_a[b])^2 + (b - bin_b[b])^2             for the 313 bins
//   K rounds: pick the nearest bin not yet picked (ties -> lower index, as
//             jnp.argmin and lax.top_k do), w_r = norm * exp(-d2 * inv2s2)
//   out[b] = w_r / sum_r w_r for the picked bins, 0 elsewhere  (M, 313) f32.
// d2 is formed with round-to-nearest intrinsics, never a contracted fma, so
// near-tied neighbours order exactly as in the plain version (two separate
// roundings, as torch's elementwise ops and XLA's do).
//
// Bound: bytes. It writes 313 floats per pixel for 8 bytes read (328 MB at
// 4x256x256); the 313 distances and 5 warp argmins per pixel are far below
// the f32 rate. Design: one warp per pixel, the 313 bin centres in shared
// memory. Lane l owns bins l, l+32, ..., keeps their distances in registers
// (10 per lane), and each round is a warp-shuffle argmin on (d2, index); the
// lane that owns the winner excludes it and records its weight. The lanes then
// write the 313-wide row coalesced, zeros included.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBins = 313;
constexpr int kPerLane = (kBins + 31) / 32;  // 10
constexpr int kWarps = 8;

__global__ void encode_ab2ind_kernel(const float* __restrict__ ab, const float* __restrict__ bins,
                                     float* __restrict__ out, long m, int neighbours, float norm,
                                     float inv2s2) {
  __shared__ float sbins[2 * kBins];
  for (int e = threadIdx.x; e < 2 * kBins; e += blockDim.x) sbins[e] = bins[e];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long pix = (long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (pix >= m) return;
  const float a = __fmul_rn(ab[pix * 2], 110.f);
  const float b = __fmul_rn(ab[pix * 2 + 1], 110.f);

  float d[kPerLane], q[kPerLane];
#pragma unroll
  for (int kk = 0; kk < kPerLane; ++kk) {
    const int bi = lane + 32 * kk;
    q[kk] = 0.f;
    if (bi < kBins) {
      const float da = __fsub_rn(a, sbins[2 * bi]);
      const float db = __fsub_rn(b, sbins[2 * bi + 1]);
      d[kk] = __fadd_rn(__fmul_rn(da, da), __fmul_rn(db, db));
    } else {
      d[kk] = INFINITY;
    }
  }

  float wsum = 0.f;
  for (int r = 0; r < neighbours; ++r) {
    // this lane's nearest remaining bin: indices grow with kk, so a strict <
    // keeps the lowest index among equal distances
    float best = INFINITY;
    int bidx = 0x7fffffff;
#pragma unroll
    for (int kk = 0; kk < kPerLane; ++kk) {
      if (d[kk] < best) {
        best = d[kk];
        bidx = lane + 32 * kk;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
      if (ob < best || (ob == best && oi < bidx)) {
        best = ob;
        bidx = oi;
      }
    }
    const float w = norm * expf(__fmul_rn(-best, inv2s2));
    wsum += w;
#pragma unroll
    for (int kk = 0; kk < kPerLane; ++kk) {
      if (lane + 32 * kk == bidx) {
        d[kk] = INFINITY;
        q[kk] = w;
      }
    }
  }

  float* orow = out + pix * kBins;
#pragma unroll
  for (int kk = 0; kk < kPerLane; ++kk) {
    const int bi = lane + 32 * kk;
    if (bi < kBins) orow[bi] = q[kk] / wsum;
  }
}

}  // namespace

extern "C" int disco_encode_ab2ind(const float* ab, const float* bins, float* out, long m,
                                   int neighbours, float norm, float inv2s2, void* stream) {
  if (m == 0) return 0;
  if (neighbours < 1 || neighbours > kBins) return (int)cudaErrorInvalidValue;
  const long blocks = (m + kWarps - 1) / kWarps;
  encode_ab2ind_kernel<<<(unsigned)blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      ab, bins, out, m, neighbours, norm, inv2s2);
  return (int)cudaGetLastError();
}
