// Shared by csrc/attention.cu (kernel D) and csrc/attention_bwd.cu: the block
// shape, the padded shared-memory layout of a head's K and V, the 16-byte
// asynchronous copies that stage them, and the loads of keep-mask bytes.
//
// Block shape. A block owns a tile of kTile = 64 rows (queries, or keys in the
// dk/dv phase) of one (head, n) and gives each row kLanes = 4 neighbouring
// threads of a warp. The lanes split the other dimension and add their
// partial results with two __shfl_xor_sync rounds.
//
// Register tile. The kernels are bound by shared-memory bandwidth, not by
// arithmetic: a 16-byte shared load costs a warp four cycles whether or not
// its threads read the same address, and at hd = 8 a pair (query, key) needs
// four of them for 16 to 32 multiply-adds. So at hd = 8 a thread owns
// Shape::rows = 2 rows of the tile (row and row + 32) and every K, V, Q or dO
// row it loads from shared memory serves both; a block then has 128 threads.
// Wider heads keep one row a thread (their row vectors fill the registers) and
// 256 threads.
//
// Key split in kernel D and in the dq phase. Per step, lane `ln` takes the
// kGroup = 16 consecutive keys [j0, j0 + 16), j0 = step * 64 + ln * 16, so one
// 16-byte load brings the lane's keep-mask bytes and the four lanes of a row
// read 64 consecutive bytes of it. The lanes then read K (and V) rows that lie
// 16 rows apart; padded_row() puts 8 floats of padding after every 16 rows so
// that these four rows fall into different shared-memory banks.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace disco {

constexpr int kTile = 64;
constexpr int kLanes = 4;
constexpr int kGroup = 16;
constexpr int kMaxSmem = 227 * 1024;

template <int HD>
struct Shape {
  static constexpr int rows = HD <= 8 ? 2 : 1;            // rows of the tile a thread owns
  static constexpr int row_step = kTile / rows;           // its rows lie this far apart
  static constexpr int threads = row_step * kLanes;       // 128 or 256
  // blocks per SM that __launch_bounds__ asks for: 512 threads an SM cap a
  // thread at 128 registers, which holds the row vectors of hd = 8 (two rows
  // of 3 or 4) without spills; the wider heads get all 255
  static constexpr int min_blocks = HD <= 8 ? 4 : 1;
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

template <int HD>
__host__ __device__ inline int padded_row(int j) {
  return j * HD + (j / kGroup) * 8;
}

// floats of a padded (rows x HD) matrix; rows is a multiple of kGroup
template <int HD>
__host__ __device__ inline int padded_floats(int rows) {
  return rows * HD + (rows / kGroup) * 8;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Rows [0, T) of one head (src points at its first float, rows D floats apart)
// go to padded shared memory; rows [T, rows) are zero-filled, so a lane may
// multiply through the ragged end of its last group.
template <int HD>
__device__ __forceinline__ void stage_padded(float* dst, const float* __restrict__ src, int T, int rows, int D) {
  constexpr int V = HD / 4;
  for (int e = threadIdx.x; e < rows * V; e += blockDim.x) {
    const int t = e / V, c = (e - t * V) * 4;
    float* d = dst + padded_row<HD>(t) + c;
    if (t < T)
      cp_async16(d, src + (long)t * D + c);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Per-key flags of a block, Tp bytes: 0 = attend, 1 = key-padding mask set
// (logit -1e9), 2 = beyond T (no key).
__device__ __forceinline__ void stage_flags(unsigned char* dst, const unsigned char* __restrict__ mask_row, int T,
                                            int Tp) {
  for (int t = threadIdx.x; t < Tp; t += blockDim.x)
    dst[t] = t >= T ? 2 : (mask_row != nullptr && mask_row[t] != 0) ? 1 : 0;
}

// 16 consecutive bytes at p as four words, byte b in bits 8 * (b % 4) of word
// b / 4. `vec`: p is 16-byte aligned and all 16 are valid (one load); else the
// first `valid` bytes are read one by one and the rest are 0.
__device__ __forceinline__ void load_bytes16(const unsigned char* __restrict__ p, int valid, bool vec,
                                             uint32_t w[4]) {
  if (vec) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
  } else {
    w[0] = w[1] = w[2] = w[3] = 0u;
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (b < valid) w[b >> 2] |= (uint32_t)p[b] << (8 * (b & 3));
  }
}

// byte b of the 16 loaded above; b is a compile-time constant after unrolling
__device__ __forceinline__ uint32_t byte_of(const uint32_t w[4], int b) { return (w[b >> 2] >> (8 * (b & 3))) & 0xffu; }

// a thread's row of HD floats from global memory, 16 bytes a load
template <int HD>
__device__ __forceinline__ void load_row(const float* __restrict__ p, float r[HD]) {
#pragma unroll
  for (int c = 0; c < HD / 4; ++c) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p) + c);
    r[4 * c] = x.x, r[4 * c + 1] = x.y, r[4 * c + 2] = x.z, r[4 * c + 3] = x.w;
  }
}

template <int HD>
__device__ __forceinline__ void store_row(float* p, const float r[HD], float scale) {
#pragma unroll
  for (int c = 0; c < HD / 4; ++c)
    reinterpret_cast<float4*>(p)[c] =
        make_float4(r[4 * c] * scale, r[4 * c + 1] * scale, r[4 * c + 2] * scale, r[4 * c + 3] * scale);
}

// a row of HD floats from shared memory into registers, 16 bytes a load
template <int HD>
__device__ __forceinline__ void lds_row(const float* s, float r[HD]) {
#pragma unroll
  for (int c = 0; c < HD / 4; ++c) {
    const float4 x = reinterpret_cast<const float4*>(s)[c];
    r[4 * c] = x.x, r[4 * c + 1] = x.y, r[4 * c + 2] = x.z, r[4 * c + 3] = x.w;
  }
}

template <int HD>
__device__ __forceinline__ float dot(const float a[HD], const float b[HD]) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

// r += a * x
template <int HD>
__device__ __forceinline__ void axpy(float a, const float x[HD], float r[HD]) {
#pragma unroll
  for (int d = 0; d < HD; ++d) r[d] = fmaf(a, x[d], r[d]);
}

// sum of r over the kLanes lanes of a row, left in every lane
template <int HD>
__device__ __forceinline__ void lanes_sum(float r[HD]) {
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1)
#pragma unroll
    for (int d = 0; d < HD; ++d) r[d] += __shfl_xor_sync(0xffffffffu, r[d], off);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// dynamic shared memory above 48 KB needs the attribute; above 227 KB no block fits
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace disco
