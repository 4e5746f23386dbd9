// Streaming helpers of kernels G (prob_grad.cu) and I (quantize.cu: FastDiv
// and balanced_grid only).
//
// Both kernels are bound by bytes: they read a contiguous NHWC tensor once and
// write another once. G's blocks stream tiles of whole pixels through a ring
// of shared-memory stages with 16-byte cp.async copies (several tiles in
// flight while one is computed), and both C entry points size one persistent
// grid to what stays resident. A tile's bytes start anywhere (a view at an odd offset,
// a channel count whose pixels are not 16-byte multiples): the copy takes the
// 16-byte-aligned chunks that cover them and reports where the tile starts in
// the stage.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Dynamic shared memory a block may have on an H100 (227 KB).
constexpr int kSmemLimit = 232448;

// 16 bytes from global `src` to shared `dst`, both 16-byte aligned; bytes at
// and past `valid` (1..16) are written as zeros and not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(valid) : "memory");
}

// 4 bytes from global `src` to shared `dst`, both 4-byte aligned; with
// `valid` 0 the 4 bytes are written as zeros and `src` is not read.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(valid) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Waits until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The shared writes of this thread, ordered before a later bulk copy's
// reads of them (the generic and the async proxy); then a barrier.
__device__ __forceinline__ void fence_async_shared() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// One thread stores `bytes` (a multiple of 16) from shared `src` to global
// `dst`, both 16-byte aligned, as one bulk copy (TMA) in a group of its own.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(src);
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(s), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Waits until all of this thread's bulk groups are complete.
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// The block's threads issue the copy of global bytes [a, a + len) into `dst`
// as the 16-byte-aligned chunks that cover them (len >= 1); returns a % 16,
// where byte a lands in dst. dst needs room for len rounded up to 16, plus 16.
// Chunk bytes at or past `end` (the tensor's end) are zero-filled, not read;
// those before a share a's aligned 16 bytes, so they lie in the same
// allocation (whose start is aligned).
__device__ __forceinline__ int copy_span_async(unsigned char* dst, uintptr_t a, long long len, uintptr_t end) {
  const uintptr_t a0 = a & ~(uintptr_t)15;
  const int chunks = (int)((a + len - a0 + 15) >> 4);
  for (int k = threadIdx.x; k < chunks; k += blockDim.x) {
    const uintptr_t src = a0 + 16 * (uintptr_t)k;
    const long long left = (long long)(end - src);
    cp_async16(dst + 16 * k, reinterpret_cast<const void*>(src), left >= 16 ? 16 : (int)left);
  }
  return (int)(a - a0);
}

// n / d for 0 <= n < 2^31 by a multiply-high and a shift (CUTLASS's
// FastDivmod): for d >= 2, with l = ceil(log2 d), mul = ceil(2^(31 + l) / d)
// and shift = l - 1.
struct FastDiv {
  int d;
  unsigned mul, shift;
  __host__ explicit FastDiv(int d_ = 1) : d(d_), mul(0), shift(0) {
    if (d < 2) return;
    unsigned l = 0;
    while ((1u << l) < (unsigned)d) ++l;
    mul = (unsigned)(((1ull << (31 + l)) + (unsigned)d - 1) / (unsigned)d);
    shift = l - 1;
  }
  __device__ __forceinline__ int div(int n) const { return d == 1 ? n : (int)(__umulhi((unsigned)n, mul) >> shift); }
};

// The grid of a persistent kernel over `units` equal pieces of work, block b
// taking units b, b + grid, ...: at most `per_sm` blocks an SM, and no more
// blocks than keep the most units a block takes at ceil(units / capacity),
// so every block takes that many or one fewer and none finishes a unit late.
inline int balanced_grid(long long units, int per_sm, int device) {
  constexpr int kMaxDevices = 64;
  static int sms[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return 0;
  if (sms[device] == 0) cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
  const long long cap = (long long)per_sm * sms[device];
  const long long each = (units + cap - 1) / cap;
  return (int)((units + each - 1) / each);
}

}  // namespace
