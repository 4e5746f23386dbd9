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
// roundings, as torch's elementwise ops and XLA's do). The weights are summed
// in selection order.
//
// Bound: bytes. It writes 313 floats per pixel for 8 bytes read (328 MB at
// 4x256x256, 0.099 ms on an H100); the 313 distances a pixel are about 0.03 ms
// of the card's issue rate. Design, for K <= 8 (every caller asks for 5):
//  - one thread per pixel scans the 313 bins in index order (centres read as
//    broadcast LDS.64) and keeps the K best (distance, index) pairs sorted in
//    registers. A bin enters only below the K-th distance, by an unrolled
//    insertion on a strict <, so it goes behind every equal distance: the
//    earlier index first, which is the plain version's argmin order.
//  - a block of kPixels pixels owns one contiguous span of kPixels*313 floats
//    (16-byte aligned, since kPixels is a multiple of 4). Its threads fill the
//    span with zeros by float4 stores, consecutive threads on consecutive
//    vectors, then (after a barrier) every thread writes its K weights. So no
//    warp stores a 1,252-byte row alone at an unaligned offset, and the K
//    scattered stores land in lines the zeros have just brought into L2. The
//    tail of M that is not a multiple of 4 pixels takes scalar stores. (Zeros
//    issued before the scan, and every element looked up in a shared table
//    and written once by a streaming store, both measured slower: PERF.md.)
// A second kernel keeps the earlier design: one warp per pixel, lane l owns
// bins l, l+32, ..., and each round is a warp-shuffle argmin on (d2, index).
// The host entry runs it for 8 < K <= 313, and for any K where M is too small
// to give every SM half a block of the top-K kernel: there a thread's serial
// scan of 313 bins, not the bytes, sets the time.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBins = 313;
constexpr int kMaxTopK = 8;     // the register top-K kernel's largest K
constexpr int kPixels = 128;    // pixels (threads) a block of the top-K kernel
// below this many blocks of the top-K kernel per SM the warp kernel is faster
// (measured at 4,096 and 8,192 pixels against 16,384 and up on an H100)
constexpr float kTopKMinBlocksPerSM = 0.5f;
static_assert(kPixels % 4 == 0, "a block's span must start at a 16-byte boundary");
constexpr int kPerLane = (kBins + 31) / 32;  // 10, warp kernel
constexpr int kWarps = 8;                    // warps (pixels) a block of the warp kernel

template <int K>
__global__ void __launch_bounds__(kPixels)
    encode_ab2ind_kernel(const float* __restrict__ ab, const float* __restrict__ bins, float* __restrict__ out,
                         long m, float norm, float inv2s2) {
  __shared__ float2 sbins[kBins];
  for (int e = threadIdx.x; e < kBins; e += kPixels) sbins[e] = make_float2(bins[2 * e], bins[2 * e + 1]);
  __syncthreads();

  const long p0 = (long)blockIdx.x * kPixels;
  const long pix = p0 + threadIdx.x;
  const bool live = pix < m;
  float* span = out + p0 * kBins;
  const long left = m - p0;
  const int count = (int)((left < kPixels ? left : kPixels) * kBins);  // floats of this block's span
  const int n4 = count / 4;
  float a = 0.f, b = 0.f;
  if (live) {
    a = __fmul_rn(ab[2 * pix], 110.f);
    b = __fmul_rn(ab[2 * pix + 1], 110.f);
  }

  // the K nearest bins so far, nearest first; equal distances in index order
  float bd[K];
  int bi[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    bd[r] = INFINITY;
    bi[r] = 0;
  }
#pragma unroll 4
  for (int j = 0; j < kBins; ++j) {
    const float2 c = sbins[j];
    const float da = __fsub_rn(a, c.x), db = __fsub_rn(b, c.y);
    const float d = __fadd_rn(__fmul_rn(da, da), __fmul_rn(db, db));
    if (d < bd[K - 1]) {
      // slot s takes slot s-1's pair if d sorts before it, else d itself if d
      // sorts before slot s's pair; d never sorts before an equal distance
#pragma unroll
      for (int s = K - 1; s > 0; --s) {
        const bool shift = d < bd[s - 1], here = d < bd[s];
        bi[s] = shift ? bi[s - 1] : (here ? j : bi[s]);
        bd[s] = shift ? bd[s - 1] : (here ? d : bd[s]);
      }
      if (d < bd[0]) {
        bd[0] = d;
        bi[0] = j;
      }
    }
  }
  float w[K], wsum = 0.f;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    w[r] = norm * expf(__fmul_rn(-bd[r], inv2s2));
    wsum += w[r];
  }

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int v = threadIdx.x; v < n4; v += kPixels) reinterpret_cast<float4*>(span)[v] = zero;
  for (int e = 4 * n4 + threadIdx.x; e < count; e += kPixels) span[e] = 0.f;
  __syncthreads();  // every thread's zeros come before any weight
  if (live) {
#pragma unroll
    for (int r = 0; r < K; ++r) span[threadIdx.x * kBins + bi[r]] = w[r] / wsum;
  }
}

__global__ void encode_ab2ind_warp_kernel(const float* __restrict__ ab, const float* __restrict__ bins,
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

template <int K>
cudaError_t launch_top_k(const float* ab, const float* bins, float* out, long m, float norm, float inv2s2,
                         cudaStream_t s) {
  const long blocks = (m + kPixels - 1) / kPixels;
  encode_ab2ind_kernel<K><<<(unsigned)blocks, kPixels, 0, s>>>(ab, bins, out, m, norm, inv2s2);
  return cudaGetLastError();
}

}  // namespace

extern "C" int disco_encode_ab2ind(const float* ab, const float* bins, float* out, long m,
                                   int neighbours, float norm, float inv2s2, void* stream) {
  if (m == 0) return 0;
  if (neighbours < 1 || neighbours > kBins) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const bool few = (float)m < kTopKMinBlocksPerSM * kPixels * sms;
  switch (few ? 0 : neighbours) {  // the wrapper allocates out, so it is 16-byte aligned
    case 1: return (int)launch_top_k<1>(ab, bins, out, m, norm, inv2s2, s);
    case 2: return (int)launch_top_k<2>(ab, bins, out, m, norm, inv2s2, s);
    case 3: return (int)launch_top_k<3>(ab, bins, out, m, norm, inv2s2, s);
    case 4: return (int)launch_top_k<4>(ab, bins, out, m, norm, inv2s2, s);
    case 5: return (int)launch_top_k<5>(ab, bins, out, m, norm, inv2s2, s);
    case 6: return (int)launch_top_k<6>(ab, bins, out, m, norm, inv2s2, s);
    case 7: return (int)launch_top_k<7>(ab, bins, out, m, norm, inv2s2, s);
    case 8: return (int)launch_top_k<8>(ab, bins, out, m, norm, inv2s2, s);
    default: break;
  }
  static_assert(kMaxTopK == 8, "the switch above covers K = 1..kMaxTopK");
  // K > kMaxTopK, or too few pixels to fill the card with the top-K kernel
  const long blocks = (m + kWarps - 1) / kWarps;
  encode_ab2ind_warp_kernel<<<(unsigned)blocks, 32 * kWarps, 0, s>>>(ab, bins, out, m, neighbours, norm, inv2s2);
  return (int)cudaGetLastError();
}
