// Shared by csrc/attention.cu (kernel D) and csrc/attention_bwd.cu: the block
// shape, the padded shared-memory layout of a tile of K and V, the ring of
// tiles that 16-byte asynchronous copies fill, and the loads of keep-mask bytes.
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
// 256 threads. Head width 4 (d_model 32 over 8 heads) takes hd = 8's shape: a
// row is one 16-byte load, every loop below runs with HD / 4 = 1, and the
// padded layout keeps rows 16-byte aligned (4 j + 8 floats per 16 rows).
//
// Key split in kernel D and in the dq phase. Per step, lane `ln` takes the
// kGroup = 16 consecutive keys [j0, j0 + 16), j0 = step * 64 + ln * 16, so one
// 16-byte load brings the lane's keep-mask bytes and the four lanes of a row
// read 64 consecutive bytes of it. The lanes then read K (and V) rows that lie
// 16 rows apart; padded_row() puts 8 floats of padding after every 16 rows so
// that these four rows fall into different shared-memory banks.
//
// Tiles. The other dimension streams through shared memory in tiles of L rows
// (keys in kernel D and the dq phase, queries in the dk/dv phase), kStages
// tiles in a ring: while the block works on tile t, the copies of tile t + 1
// are in flight. L is a multiple of 64 rows (one step of the four lanes), so
// a lane meets its keys (or queries) in the same order whatever L is, and a
// result does not depend on the tile length: the tiles change where a row
// waits, not the arithmetic. The plan (L and the bytes of the ring) is
// computed by ops/attention.py::attention_plan and checked here again.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace disco {

constexpr int kTile = 64;
constexpr int kLanes = 4;
constexpr int kGroup = 16;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kStages = 2;  // tiles in the ring

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

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most N of this thread's most recent copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// bytes of one ring stage of kernel D and of the dq phase: K and V of L keys
// in the padded layout, then the keys' flags (L bytes)
template <int HD>
__host__ __device__ inline int kv_stage_floats(int L) {
  return 2 * padded_floats<HD>(L) + L / 4;
}

// Rows [0, valid) of a tile (src points at its first row's head slice, rows D
// floats apart) go to padded shared memory; rows [valid, L) are zero-filled,
// so a lane may multiply through the ragged end of its last group.
template <int HD>
__device__ __forceinline__ void stage_padded(float* dst, const float* __restrict__ src, int valid, int L, int D) {
  constexpr int V = HD / 4;
  for (int e = threadIdx.x; e < L * V; e += blockDim.x) {
    const int t = e / V, c = (e - t * V) * 4;
    float* d = dst + padded_row<HD>(t) + c;
    if (t < valid)
      cp_async16(d, src + (long)t * D + c);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Per-key flags of a tile of L keys starting at key j0, L bytes: 0 = attend,
// 1 = key-padding mask set (logit -1e9), 2 = beyond T (no key).
__device__ __forceinline__ void stage_flags(unsigned char* dst, const unsigned char* __restrict__ mask_row, int j0,
                                            int T, int L) {
  for (int t = threadIdx.x; t < L; t += blockDim.x) {
    const int j = j0 + t;
    dst[t] = j >= T ? 2 : (mask_row != nullptr && mask_row[j] != 0) ? 1 : 0;
  }
}

// One ring stage of kernel D or the dq phase: the K and V rows and the flags
// of keys [j0, j0 + L) of one head (k and v point at the head's key 0).
template <int HD>
__device__ __forceinline__ void stage_kv_tile(float* stage, const float* __restrict__ k, const float* __restrict__ v,
                                              const unsigned char* __restrict__ mask_row, bool flagged, int j0,
                                              int T, int L, int D) {
  const int valid = min(L, T - j0);
  float* sk = stage;
  float* sv = sk + padded_floats<HD>(L);
  stage_padded<HD>(sk, k + (long)j0 * D, valid, L, D);
  stage_padded<HD>(sv, v + (long)j0 * D, valid, L, D);
  if (flagged) stage_flags(reinterpret_cast<unsigned char*>(sv + padded_floats<HD>(L)), mask_row, j0, T, L);
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
