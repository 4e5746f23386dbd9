// Kernel H: 3x3 convolution of int8 NHWC activations with int8 weights, int32
// sums, dequantized to f32 or bf16: the serving convolutions under int8
// post-training quantization.
//
// The JAX package leaves this to XLA (ops/quant.py::int8_conv, a
// conv_general_dilated of int8 operands with preferred_element_type=int32,
// then y.astype(f32) * (sx * sw) + bias; no Pallas kernel). XLA's compiled
// graph on the CPU (jitted, as the JAX Colorizer and command line run it)
// rewrites sx * sw = (mx / 127) * (mw[o] / 127), mx = max(amax, 1e-12) and
// mw[o] = max(max|W[o]|, 1e-12), as mw[o] * (mx * f32(1/127^2)), and
// contracts the multiply-add into one fused multiply-add, so the epilogue
// here is
//   out[m, o] = fmaf(float(acc[m, o]), mw[o] * (mx * f32(1/127^2)), bias[o])
// each product rounded to f32, mx from the same device scalar as kernel I
// (quantize.cu); for bf16 output that f32 value is rounded to nearest even
// once. The int32 sums are exact in any order, so the output equals the
// plain version's bit for bit, and JAX's.
//
// Implicit GEMM, no im2col in memory: M = n * ho * wo output pixels, N = O
// output channels, K = 9 * cp (tap-major, channel-minor; cp = the input
// channels padded to a multiple of 32 by kernel I, zeros beyond c). A 32-wide
// slice of K lies in one tap, so a row of an A tile is 32 contiguous bytes of
// one input pixel (zeros where the tap falls in the padding) and a row of a B
// tile 32 contiguous bytes of one output channel's weights (O, 3, 3, cp).
//
// Bound: operations for the wide layers (2*M*N*K at 1,979 TOP/s, 512->512 at
// 32x32, batch 8: 0.020 ms), bytes for the narrow ones (64->2 at 256x256 reads
// 34 MB of activations for 2 channels out). Design: blocks of 128 pixels x 64
// output channels, 4 warps of 64 x 32, each a 4 x 4 grid of
// mma.sync.m16n8k32.s8 (int8 tensor cores, int32 accumulators in registers);
// tiles of 32 bytes of K staged in shared memory by cp.async, 3 stages deep,
// with zero fill for padding taps and ragged edges; shared rows padded to 48
// bytes so that the fragment loads (8 rows x 4 words a warp) hit 32 banks.
// A first design: no wgmma/TMA yet; the ragged cases (c = 65, O = 2, M not a
// multiple of 128) are handled by masks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int ROW = 48;  // bytes of a shared row: 32 of data, 16 of padding
constexpr int STAGES = 3;
constexpr int THREADS = 128;
constexpr float kInv127Sq = 0x1.040c2p-14f;  // f32(1/127^2) = 6.20001229e-05, bits 0x38820610

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = ok ? 16 : 0;  // 0: fill the 16 bytes with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store(float* out, long long i, float v) { out[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* out, long long i, float v) {
  out[i] = __float2bfloat16_rn(v);
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
    int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ amax, const float* __restrict__ mw,
                     const float* __restrict__ bias, OutT* __restrict__ out, int h, int wd, int cp,
                     int ho, int wo, int O, int stride, long long M) {
  __shared__ __align__(16) int8_t As[STAGES][BM * ROW];
  __shared__ __align__(16) int8_t Bs[STAGES][BN * ROW];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma group and thread in group
  const int wm = warp & 1, wn = warp >> 1;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // this thread's A row (one output pixel, two 16-byte chunks) and B chunk
  const long long m = m0 + tid;
  const bool m_ok = m < M;
  int img = 0, oy = 0, ox = 0;
  if (m_ok) {
    ox = (int)(m % wo);
    oy = (int)((m / wo) % ho);
    img = (int)(m / ((long long)wo * ho));
  }
  const int b_row = tid >> 1, b_chunk = tid & 1;
  const int b_o = n0 + b_row;
  const bool b_ok = b_o < O;

  const int cblocks = cp / BK;
  const int KT = 9 * cblocks;

  auto load = [&](int stage, int kt) {
    const int tap = kt / cblocks, cb = kt - tap * cblocks;
    const int ky = tap / 3, kx = tap - ky * 3;
    const int iy = oy * stride - 1 + ky, ix = ox * stride - 1 + kx;
    const bool ok = m_ok && iy >= 0 && iy < h && ix >= 0 && ix < wd;
    const int8_t* src = ok ? x + (((long long)img * h + iy) * wd + ix) * cp + cb * BK : x;
    int8_t* dst = &As[stage][tid * ROW];
    cp_async16(dst, src, ok);
    cp_async16(dst + 16, ok ? src + 16 : x, ok);
    const int8_t* wsrc = b_ok ? w + ((long long)b_o * 9 + tap) * cp + cb * BK + b_chunk * 16 : w;
    cp_async16(&Bs[stage][b_row * ROW + b_chunk * 16], wsrc, b_ok);
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < KT) load(nk % STAGES, nk);
    cp_async_commit();

    const int8_t* a_s = As[kt % STAGES];
    const int8_t* b_s = Bs[kt % STAGES];
    unsigned af[4][4], bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int r = wm * 64 + mi * 16 + g;
      af[mi][0] = *reinterpret_cast<const unsigned*>(a_s + r * ROW + 4 * t);
      af[mi][1] = *reinterpret_cast<const unsigned*>(a_s + (r + 8) * ROW + 4 * t);
      af[mi][2] = *reinterpret_cast<const unsigned*>(a_s + r * ROW + 16 + 4 * t);
      af[mi][3] = *reinterpret_cast<const unsigned*>(a_s + (r + 8) * ROW + 16 + 4 * t);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = wn * 32 + ni * 8 + g;
      bf[ni][0] = *reinterpret_cast<const unsigned*>(b_s + col * ROW + 4 * t);
      bf[ni][1] = *reinterpret_cast<const unsigned*>(b_s + col * ROW + 16 + 4 * t);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
  }
  cp_async_wait<0>();

  const float sx = __fmul_rn(fmaxf(__ldg(amax), 1e-12f), kInv127Sq);
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int o = n0 + wn * 32 + ni * 8 + 2 * t + j;
      if (o >= O) continue;
      const float s = __fmul_rn(__ldg(mw + o), sx);
      const float b = __ldg(bias + o);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long long row = m0 + wm * 64 + mi * 16 + g + half * 8;
          if (row >= M) continue;
          const float v = __fmaf_rn(__int2float_rn(acc[mi][ni][half * 2 + j]), s, b);
          store(out, row * O + o, v);
        }
      }
    }
  }
}

template <typename OutT>
int launch_int8_conv(const int8_t* x, const int8_t* w, const float* amax, const float* mw,
                     const float* bias, OutT* out, int n, int h, int wd, int cp, int O, int stride,
                     void* stream) {
  if (cp % BK != 0 || (stride != 1 && stride != 2) || O < 1) return (int)cudaErrorInvalidValue;
  const int ho = (h - 1) / stride + 1, wo = (wd - 1) / stride + 1;
  const long long M = (long long)n * ho * wo;
  if (M == 0) return 0;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((O + BN - 1) / BN));
  int8_conv_kernel<OutT><<<grid, THREADS, 0, (cudaStream_t)stream>>>(x, w, amax, mw, bias, out, h, wd,
                                                                      cp, ho, wo, O, stride, M);
  return (int)cudaGetLastError();
}

}  // namespace

// x (n, h, w, cp) int8 NHWC, w (O, 3, 3, cp) int8, amax a device scalar, mw
// (the weights' per-channel max(max|W[o]|, 1e-12)) and bias (O,) f32, out (n, ho, wo, O) f32 NHWC; pad 1, stride 1 or 2;
// contiguous, x and w 16-byte aligned.
extern "C" int disco_int8_conv(const int8_t* x, const int8_t* w, const float* amax,
                               const float* mw, const float* bias, float* out, int n, int h, int wd,
                               int cp, int O, int stride, void* stream) {
  return launch_int8_conv(x, w, amax, mw, bias, out, n, h, wd, cp, O, stride, stream);
}

// The bf16 instance: out bf16, the f32 epilogue rounded once.
extern "C" int disco_int8_conv_bf16(const int8_t* x, const int8_t* w, const float* amax,
                                    const float* mw, const float* bias, __nv_bfloat16* out, int n,
                                    int h, int wd, int cp, int O, int stride, void* stream) {
  return launch_int8_conv(x, w, amax, mw, bias, out, n, h, wd, cp, O, stride, stream);
}
