// Kernel B: SpixelNet's affinity head, a 3x3 SAME conv C -> 9 + bias + softmax over the 9.
//
// Replaces disentangledcolorization_tpu/ops/pallas_affinity.py::fused_affinity_head.
// x (N,H,W,C) f32 NHWC, kernel (3,3,C,9) HWIO f32, bias (9,) -> out (N,H,W,9) f32,
// zero padding, f32 accumulation, max-subtracted softmax with expf.
//
// Bound: operations. 81*C multiply-adds per pixel (1,296 at C=16, the model's
// head) against 4*C bytes read and 36 written: at C=16 the FFMAs take about
// 0.021 ms at batch 8 on an H100 at its f32 peak, the bytes about 0.016. So
// the FMA pipe has to set the pace, and every other instruction is overhead
// on it. Design:
//  - the weights sit in the constant bank, not in memory the threads load:
//    the wrapper's HWIO kernel is copied into a __constant__ array on the
//    launch stream (cudaMemcpyToSymbolAsync, device to device, stream-ordered,
//    no host sync). The C=16 instance unrolls taps, channels and outputs, so
//    every weight offset is a compile-time constant. ptxas reads them in pairs
//    into uniform registers (ULDC.64) rather than as FFMA operands; a thread
//    owns kRows = 2 pixels of a column and spends each pair on both, which
//    halves the uniform loads a pixel. Other C run a loop over 16-channel
//    chunks whose weights are uniform loads at run-time offsets. The 9 biases
//    are read once per thread. The array is one per device: calls on two
//    streams with different weights would race; the port launches on one.
//  - a tile is (8*kRows) rows x 32 columns (a warp's lanes are the 32
//    columns) and is staged with its 1-pixel halo in shared memory: each tile
//    row is one contiguous run of 34 pixels in NHWC. A pixel takes 20 floats
//    (80 bytes), so the 8 lanes of a quarter-warp reading float4s of 8
//    neighbouring pixels hit 8 distinct 4-bank groups (a 64-byte stride would
//    make that a 4-way conflict): 24 LDS.128 a pixel against 1,296 FFMAs.
//  - at C=16 with x 16-byte aligned, persistent blocks walk the tiles; every
//    16-byte vector of the next tile is a cp.async (zero-filled outside the
//    image) into the second of two buffers while the block computes the
//    current one. Any other C (or an unaligned x) takes one tile a block and
//    16-channel chunks by plain loads.
//  - the softmax runs in registers; the 9 probabilities of every pixel are
//    staged in shared memory (in the tile's space) and each tile row's 32*9
//    consecutive floats are written by consecutive threads, as float4s where
//    the rows start at 16-byte boundaries.
// On the card the unrolled block runs its FFMAs at about 70% of the rate a
// cuBLAS f32 product reaches; the uniform weight loads and the staging and
// stores that the pipeline does not hide take the rest (PERF.md).
//
// The bf16 instance (disco_affinity_head_bf16) is the head of the bf16
// serving forward: x (N,H,W,C) bf16 with the f32 kernel and bias, output f32,
// the promotion of the JAX head (an f32 conv of the bf16 activations,
// pallas_affinity.py::_xla_affinity_head). It converts x to f32 while it
// stages the tile, into the same 20-float pixel layout, so the unrolled C=16
// block, the constant bank and the softmax are the f32 instance's. A bf16
// pixel of 16 channels is 32 bytes, two 16-byte loads (8 channels each) that
// the staging converts in registers; there is no cp.async pipeline, one tile
// a block (kRows rows a thread at C=16, one row and 16-channel chunks at
// other C). Its bytes fall to 2*C read, 36 written a pixel, so it stays
// bound by its FFMAs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vector_loads.cuh"

namespace {

constexpr int kMaxC = 128;                  // the wrapper raises above (pallas_affinity.py:74)
constexpr int kThreads = 256;
constexpr int kRows = 2;                    // output rows a thread of the C=16 instance
constexpr int kTileW = 32;                  // a warp's columns
constexpr int kChunk = 16;                  // channels staged at once
constexpr int kPix = kChunk + 4;            // floats a staged pixel takes

__constant__ float c_wgt[81 * kMaxC];       // HWIO: ((dy*3 + dx)*C + ci)*9 + o

template <int R>
struct Tile {
  static constexpr int kH = kThreads / kTileW * R, kHaloH = kH + 2, kHaloW = kTileW + 2;
  static constexpr int kFloats = kHaloH * kHaloW * kPix;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
  static_assert(kH * kTileW * 9 <= kFloats, "the output stage reuses the tile");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool inside) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(inside ? 16 : 0));
}

// C=16, x 16-byte aligned: issue every 16-byte vector of the halo tile whose
// top-left pixel is (y0 - 1, x0 - 1) as a cp.async (zeros outside the image),
// none through registers; the caller commits and waits.
template <int R>
__device__ __forceinline__ void issue16(const float* __restrict__ x, float* tile, long n, int y0, int x0, int H,
                                        int W) {
  using T = Tile<R>;
  for (int e = threadIdx.x; e < T::kHaloH * T::kHaloW * 4; e += kThreads) {
    const int r = e / (T::kHaloW * 4), p = (e / 4) % T::kHaloW, q = e % 4;
    const int yy = y0 - 1 + r, xx = x0 - 1 + p;
    const bool inside = yy >= 0 && yy < H && xx >= 0 && xx < W;
    cp_async16(tile + (e / 4) * kPix + 4 * q, inside ? x + ((n * H + yy) * W + xx) * 16 + 4 * q : x, inside);
  }
}

// Any C: channels [c0, c0 + cw) of the halo tile whose top-left pixel is
// (y0 - 1, x0 - 1); zeros outside the image.
template <int R>
__device__ __forceinline__ void stage(const float* __restrict__ x, float* tile, long n, int y0, int x0, int H,
                                      int W, int c, int c0, int cw, bool vec) {
  using T = Tile<R>;
  if (vec) {  // cw % 4 == 0: a float4 never crosses a pixel
    const int per_pix = cw / 4, per_row = T::kHaloW * per_pix;
    for (int e = threadIdx.x; e < T::kHaloH * per_row; e += kThreads) {
      const int r = e / per_row, rem = e - r * per_row;
      const int p = rem / per_pix, q = rem - p * per_pix;
      const int yy = y0 - 1 + r, xx = x0 - 1 + p;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (yy >= 0 && yy < H && xx >= 0 && xx < W)
        v = __ldg(reinterpret_cast<const float4*>(x + ((n * H + yy) * W + xx) * c + c0) + q);
      *reinterpret_cast<float4*>(tile + (r * T::kHaloW + p) * kPix + 4 * q) = v;
    }
  } else {
    const int per_row = T::kHaloW * cw;
    for (int e = threadIdx.x; e < T::kHaloH * per_row; e += kThreads) {
      const int r = e / per_row, rem = e - r * per_row;
      const int p = rem / cw, ci = rem - p * cw;
      const int yy = y0 - 1 + r, xx = x0 - 1 + p;
      float v = 0.f;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W) v = __ldg(x + ((n * H + yy) * W + xx) * c + c0 + ci);
      tile[(r * T::kHaloW + p) * kPix + ci] = v;
    }
  }
}

// The same for bf16 x, converted to f32 into the tile's pixel layout.
// ``vec``: cw % 8 == 0 and every pixel 16-byte aligned, so a 16-byte load of
// 8 channels never crosses a pixel.
template <int R>
__device__ __forceinline__ void stage(const __nv_bfloat16* __restrict__ x, float* tile, long n, int y0, int x0,
                                      int H, int W, int c, int c0, int cw, bool vec) {
  using T = Tile<R>;
  if (vec) {
    const int per_pix = cw / 8, per_row = T::kHaloW * per_pix;
    for (int e = threadIdx.x; e < T::kHaloH * per_row; e += kThreads) {
      const int r = e / per_row, rem = e - r * per_row;
      const int p = rem / per_pix, q = rem - p * per_pix;
      const int yy = y0 - 1 + r, xx = x0 - 1 + p;
      float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (yy >= 0 && yy < H && xx >= 0 && xx < W) load_vec<8>(x + ((n * H + yy) * W + xx) * c + c0 + 8 * q, f);
      float4* dst = reinterpret_cast<float4*>(tile + (r * T::kHaloW + p) * kPix + 8 * q);
      dst[0] = make_float4(f[0], f[1], f[2], f[3]);
      dst[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
  } else {
    const int per_row = T::kHaloW * cw;
    for (int e = threadIdx.x; e < T::kHaloH * per_row; e += kThreads) {
      const int r = e / per_row, rem = e - r * per_row;
      const int p = rem / cw, ci = rem - p * cw;
      const int yy = y0 - 1 + r, xx = x0 - 1 + p;
      float v = 0.f;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W) v = __bfloat162float(x[((n * H + yy) * W + xx) * c + c0 + ci]);
      tile[(r * T::kHaloW + p) * kPix + ci] = v;
    }
  }
}

// A full 16-channel chunk, tap by tap: the 4 channel vectors of the tap for
// each of the thread's R pixels, then each weight into the R sums it feeds.
// With CT > 0 (C known) every weight index is a compile-time constant. (A
// loop over the taps makes the weight offsets per-thread LDCs: slower.)
template <int CT, int R>
__device__ __forceinline__ void accumulate_chunk(const float* tile, int ry, int lane, int c, int c0,
                                                 float (&acc)[R][9]) {
  using T = Tile<R>;
  const int cc = CT > 0 ? CT : c;
#pragma unroll
  for (int ty = 0; ty < 3; ++ty) {
#pragma unroll
    for (int tx = 0; tx < 3; ++tx) {
#pragma unroll
      for (int q = 0; q < kChunk / 4; ++q) {
        float v[R][4];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float4 v4 =
              *reinterpret_cast<const float4*>(tile + ((ry + i + ty) * T::kHaloW + lane + tx) * kPix + 4 * q);
          v[i][0] = v4.x, v[i][1] = v4.y, v[i][2] = v4.z, v[i][3] = v4.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* w = c_wgt + ((ty * 3 + tx) * cc + c0 + 4 * q + j) * 9;
#pragma unroll
          for (int o = 0; o < 9; ++o) {
#pragma unroll
            for (int i = 0; i < R; ++i) acc[i][o] = fmaf(v[i][j], w[o], acc[i][o]);
          }
        }
      }
    }
  }
}

// A partial chunk (the last cw < 16 channels of a generic C): scalar reads.
template <int R>
__device__ __forceinline__ void accumulate_partial(const float* tile, int ry, int lane, int c, int c0, int cw,
                                                   float (&acc)[R][9]) {
  using T = Tile<R>;
#pragma unroll
  for (int ty = 0; ty < 3; ++ty) {
#pragma unroll
    for (int tx = 0; tx < 3; ++tx) {
      for (int ci = 0; ci < cw; ++ci) {
        const float* w = c_wgt + ((ty * 3 + tx) * c + c0 + ci) * 9;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float v = tile[((ry + i + ty) * T::kHaloW + lane + tx) * kPix + ci];
#pragma unroll
          for (int o = 0; o < 9; ++o) acc[i][o] = fmaf(v, w[o], acc[i][o]);
        }
      }
    }
  }
}

// Softmax of the R pixels' sums in registers, the probabilities staged in the
// tile's space (every thread must be done reading the tile), then each tile
// row's 32*9 floats written by consecutive threads.
template <int R>
__device__ __forceinline__ void finish(float (&acc)[R][9], float* tile, float* __restrict__ out, long n, int y0,
                                       int x0, int H, int W, int ry, int lane) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float m = acc[i][0];
#pragma unroll
    for (int o = 1; o < 9; ++o) m = fmaxf(m, acc[i][o]);
    float s = 0.f;
#pragma unroll
    for (int o = 0; o < 9; ++o) {
      acc[i][o] = expf(acc[i][o] - m);
      s += acc[i][o];
    }
    float* st = tile + ((ry + i) * kTileW + lane) * 9;
#pragma unroll
    for (int o = 0; o < 9; ++o) st[o] = acc[i][o] / s;
  }
  __syncthreads();
  constexpr int kRow = kTileW * 9;  // floats of a full tile row
  if (x0 + kTileW <= W && W % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    // every output row starts at a 16-byte boundary: float4 stores
    for (int e = threadIdx.x; e < Tile<R>::kH * kRow / 4; e += kThreads) {
      const int r = e / (kRow / 4), k = e - r * (kRow / 4);
      if (y0 + r < H)
        reinterpret_cast<float4*>(out + ((n * H + y0 + r) * W + x0) * 9)[k] = reinterpret_cast<const float4*>(tile)[e];
    }
  } else {
    const int valid = min(kTileW, W - x0) * 9;  // floats of a tile row inside the image
    for (int e = threadIdx.x; e < Tile<R>::kH * kRow; e += kThreads) {
      const int r = e / kRow, k = e - r * kRow;
      if (y0 + r < H && k < valid) out[((n * H + y0 + r) * W + x0) * 9 + k] = tile[e];
    }
  }
}

// The model's head, C=16 with x 16-byte aligned: persistent blocks walk the
// tiles (R rows a thread), and while a block computes one tile, its
// cp.asyncs fill the other of two buffers with the next. Staging, compute
// and the stores of different tiles so overlap even when every block of an
// SM is in the same phase.
template <int R>
__global__ void __launch_bounds__(kThreads, R == 1 ? 4 : 2)
    affinity_head_pipe_kernel(const float* __restrict__ x, const float* __restrict__ bias,
                              float* __restrict__ out, int H, int W, int tiles_x, int tiles_y, long tiles) {
  using T = Tile<R>;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, ry = (threadIdx.x >> 5) * R;
  float b[9];
#pragma unroll
  for (int o = 0; o < 9; ++o) b[o] = __ldg(bias + o);
  auto origin = [&](long t, long& n, int& y0, int& x0) {
    x0 = (int)(t % tiles_x) * kTileW;
    y0 = (int)((t / tiles_x) % tiles_y) * T::kH;
    n = t / ((long)tiles_x * tiles_y);
  };
  long t = blockIdx.x, n;  // the grid has no more blocks than tiles
  int y0, x0;
  origin(t, n, y0, x0);
  issue16<R>(x, smem, n, y0, x0, H, W);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int k = 0; t < tiles; ++k, t += gridDim.x) {
    float* tile = smem + (k & 1) * T::kFloats;
    if (t + gridDim.x < tiles) {  // the next tile into the other buffer
      long nn;
      int yy, xx;
      origin(t + gridDim.x, nn, yy, xx);
      issue16<R>(x, smem + ((k + 1) & 1) * T::kFloats, nn, yy, xx, H, W);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this tile's copies have landed
    __syncthreads();
    origin(t, n, y0, x0);
    float acc[R][9];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int o = 0; o < 9; ++o) acc[i][o] = b[o];
    accumulate_chunk<16, R>(tile, ry, lane, 16, 0, acc);
    __syncthreads();
    finish<R>(acc, tile, out, n, y0, x0, H, W, ry, lane);
    __syncthreads();  // the stores have read the stage before the buffer is filled again
  }
}

// Any C <= kMaxC, x of element type E (f32, or bf16 converted as it is
// staged): one tile a block, R rows a thread, 16-channel chunks staged by
// plain loads. CT = 16 (the bf16 model's head) unrolls the chunk with
// compile-time weight offsets, as the f32 pipelined instance does; CT = 0
// loops over C (f32 at C != 16 or an unaligned x, bf16 at C != 16).
template <typename E, int CT, int R>
__global__ void __launch_bounds__(kThreads, R == 1 ? 4 : 2)
    affinity_head_kernel(const E* __restrict__ x, const float* __restrict__ bias, float* __restrict__ out, int H,
                         int W, int C, int tiles_x, int tiles_y, bool vec) {
  using T = Tile<R>;
  extern __shared__ __align__(16) float tile[];
  const int x0 = (int)(blockIdx.x % tiles_x) * kTileW, y0 = (int)((blockIdx.x / tiles_x) % tiles_y) * T::kH;
  const long n = blockIdx.x / ((long)tiles_x * tiles_y);
  const int lane = threadIdx.x & 31, ry = (threadIdx.x >> 5) * R;
  const int cc = CT > 0 ? CT : C;

  float acc[R][9];
#pragma unroll
  for (int o = 0; o < 9; ++o) {
    const float b = __ldg(bias + o);
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i][o] = b;
  }
  for (int c0 = 0; c0 < cc; c0 += kChunk) {
    const int cw = min(kChunk, cc - c0);
    if (c0 > 0) __syncthreads();  // every thread is done with the last chunk
    stage<R>(x, tile, n, y0, x0, H, W, cc, c0, cw, vec);
    __syncthreads();
    if (cw == kChunk)
      accumulate_chunk<CT, R>(tile, ry, lane, cc, c0, acc);
    else
      accumulate_partial<R>(tile, ry, lane, cc, c0, cw, acc);
  }
  __syncthreads();
  finish<R>(acc, tile, out, n, y0, x0, H, W, ry, lane);
}

// The 81*C weights into the constant bank, on the launch stream.
cudaError_t load_weights(const float* wgt, int c, cudaStream_t s) {
  return cudaMemcpyToSymbolAsync(c_wgt, wgt, sizeof(float) * 81 * (size_t)c, 0, cudaMemcpyDeviceToDevice, s);
}

}  // namespace

extern "C" int disco_affinity_head(const float* x, const float* wgt, const float* bias, float* out,
                                   int n, int h, int w, int c, void* stream) {
  if ((long)n * h * w == 0) return 0;
  if (c < 1 || c > kMaxC) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = load_weights(wgt, c, s);
  if (e != cudaSuccess) return (int)e;
  const bool vec = c % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  if (c == 16 && vec) {
    using T = Tile<kRows>;
    const auto kernel = affinity_head_pipe_kernel<kRows>;
    const int smem = 2 * (int)T::kBytes;
    int dev = 0, sms = 0, per_sm = 0;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    const int tiles_x = (w + kTileW - 1) / kTileW, tiles_y = (h + T::kH - 1) / T::kH;
    const long tiles = (long)n * tiles_x * tiles_y;
    const long blocks = tiles < (long)per_sm * sms ? tiles : (long)per_sm * sms;
    kernel<<<(unsigned)blocks, kThreads, smem, s>>>(x, bias, out, h, w, tiles_x, tiles_y, tiles);
    return (int)cudaGetLastError();
  }
  const int tiles_x = (w + kTileW - 1) / kTileW, tiles_y = (h + Tile<1>::kH - 1) / Tile<1>::kH;
  const long blocks = (long)n * tiles_x * tiles_y;
  affinity_head_kernel<float, 0, 1><<<(unsigned)blocks, kThreads, Tile<1>::kBytes, s>>>(x, bias, out, h, w, c,
                                                                                        tiles_x, tiles_y, vec);
  return (int)cudaGetLastError();
}

// x (n,h,w,c) bf16, wgt (3,3,c,9) and bias (9,) f32 -> out (n,h,w,9) f32.
extern "C" int disco_affinity_head_bf16(const void* x, const float* wgt, const float* bias, float* out, int n,
                                        int h, int w, int c, void* stream) {
  if ((long)n * h * w == 0) return 0;
  if (c < 1 || c > kMaxC) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = load_weights(wgt, c, s);
  if (e != cudaSuccess) return (int)e;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const bool vec = c % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  if (c == 16) {
    using T = Tile<kRows>;
    static_assert(T::kBytes <= 48 * 1024, "one tile a block fits the default shared memory");
    const int tiles_x = (w + kTileW - 1) / kTileW, tiles_y = (h + T::kH - 1) / T::kH;
    const long blocks = (long)n * tiles_x * tiles_y;
    affinity_head_kernel<__nv_bfloat16, 16, kRows><<<(unsigned)blocks, kThreads, T::kBytes, s>>>(
        xb, bias, out, h, w, c, tiles_x, tiles_y, vec);
    return (int)cudaGetLastError();
  }
  const int tiles_x = (w + kTileW - 1) / kTileW, tiles_y = (h + Tile<1>::kH - 1) / Tile<1>::kH;
  const long blocks = (long)n * tiles_x * tiles_y;
  affinity_head_kernel<__nv_bfloat16, 0, 1><<<(unsigned)blocks, kThreads, Tile<1>::kBytes, s>>>(
      xb, bias, out, h, w, c, tiles_x, tiles_y, vec);
  return (int)cudaGetLastError();
}
