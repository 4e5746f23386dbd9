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
// Implicit GEMM, no im2col in memory: M = output pixels, N = O output
// channels, K = 9 taps x cp (cp = the input channels padded to a multiple of
// 32 by kernel I, zeros beyond c). Bound: int8 operations for the wide layers
// (2*M*N*K at 1,979 TOP/s: 512->512 at 32x32, batch 8, 0.020 ms), bytes for
// the narrow ones (64->2 at 256x256 reads 34 MB of activations for 2 channels
// out).
//
// Design (Hopper: TMA, mbarriers, wgmma, warp specialisation):
//  * A tile is a box of th x tw = 128 output pixels of one image (tw = 128
//    for wo >= 128, else the power of two >= wo, th = 128 / tw) by BN output
//    channels, BN the smallest wgmma width in {8, 16, 32, 64, 128, 256} that
//    holds O (256 above; one instance each). Boxes at the right and bottom
//    edges run past the map: their extra rows are computed and never stored.
//  * A operand: for each tap (ky, kx) and slice of BK channels, one TMA load
//    of the box (BK, tw, th, 1) of x seen as the 4-D tensor (cp, w, h, n), at
//    (slice, ox0*s + kx - 1, oy0*s + ky - 1, img). TMA writes zeros for
//    coordinates outside the tensor, negative ones too, so the padding and the
//    ragged edges cost no instruction. Stride 2 is the map's element strides
//    (2 on w and h; the box then spans 2*tw x 2*th elements and loads every
//    second one). B operand: the box (BK, 1, BN) of w seen as (cp, 9, O) at
//    (slice, tap, n0); rows at or beyond O load as zeros, and so do channels
//    at or beyond cp in both operands, so a slice may run past cp (cp = 96
//    takes one 128-byte slice a tap, a quarter zeros: on an H100 faster than
//    three 32-byte ones, whose 32-byte rows TMA moves slowly). BK (32, 64 or
//    128 bytes, from the plan) is also the TMA swizzle's width, so a pixel's BK
//    bytes are one swizzled shared row and the wgmma descriptors (K-major, the
//    same swizzle, 8-row groups 8*BK bytes apart) read them without bank
//    conflicts. Every tile lies on a 1024-byte boundary, the period of the
//    widest swizzle; a descriptor steps 32 bytes along K by its start address.
//  * Pipeline: a ring of 2-8 stages (as many as shared memory holds beside
//    the staging buffer) with a full and an empty mbarrier each. Warpgroup 2
//    gives back registers (setmaxnreg) and one of its threads issues the TMA
//    loads; warpgroups 0 and 1 take 64 rows of the tile each and issue
//    wgmma.m64nBNk32.s32.s8.s8, BK / 32 a stage, one commit group a stage, and
//    free a stage once the group after it is in flight (wait_group 1).
//  * Persistent blocks: one block of 384 threads an SM walks the tiles
//    (pixel boxes outer, channel tiles inner), so the producer loads the next
//    tile's stages while the consumers store this one's.
//  * Epilogue: the f32 fused multiply-add above, rounded once to bf16 for the
//    bf16 instance, staged through shared memory 128 bytes of each row at a
//    time (rows padded by 8 elements: a warp's 8 rows of 4 pairs cover the
//    banks), then written as 16-byte stores, consecutive threads on
//    consecutive bytes of a pixel's channels; element stores where O is not
//    a multiple of 16 bytes (O = 2, 70, 130).
// The tensor maps are encoded on the host at each launch by
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (no -lcuda),
// and passed as __grid_constant__ parameters. The tile plan (BK, BN, tw, th,
// stages) comes from ops/quant.py::int8_conv_plan and is checked here.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // output pixels a tile
constexpr int THREADS = 384;   // warpgroups 0 and 1 compute, warpgroup 2 loads
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may have on an H100
constexpr int BAR_BYTES = 2 * MAX_STAGES * 8;
constexpr float kInv127Sq = 0x1.040c2p-14f;  // f32(1/127^2) = 6.20001229e-05, bits 0x38820610

// shared bytes of a plan: alignment slack, the ring, the staging buffer, the barriers
__host__ __device__ constexpr int stage_bytes(int bn, int bk) { return ((BM + bn) * bk + 1023) / 1024 * 1024; }
__host__ __device__ constexpr int staging_cols(int bn, int out_bytes) { return bn * out_bytes < 128 ? bn : 128 / out_bytes; }
__host__ __device__ constexpr int staging_bytes(int bn, int out_bytes) {
  return BM * (staging_cols(bn, out_bytes) + 8) * out_bytes;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A shared-memory matrix descriptor of a K-major operand: start address,
// leading byte offset 1 (unused by the swizzled K-major layouts), 8-row groups
// `sbo` bytes apart, swizzle `layout` (1: 128 bytes, 2: 64, 3: 32).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t layout, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(sbo >> 4) << 32) |
         ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x N s32, the warpgroup's accumulator fragment) += A (64 x 32 s8, desc a) * B^T (N x 32 s8, desc b);
// scale_d == 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<8>(int* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<16>(int* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<32>(int* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Keeps the compiler from moving reads of the accumulators above a wgmma wait.
template <int R>
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

struct Tile {
  int img, oy0, ox0, n0;
};

// tile t -> its pixel box and first channel: boxes of an image row-major, images outer, channel tiles innermost
__device__ __forceinline__ Tile decode(int t, int tiles_n, int bn, int boxes_w, int boxes_img, int th, int tw_log2) {
  const int mt = t / tiles_n;
  const int img = mt / boxes_img, r = mt - img * boxes_img;
  const int by = r / boxes_w;
  return Tile{img, by * th, (r - by * boxes_w) << tw_log2, (t - mt * tiles_n) * bn};
}

template <int BN, typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
    int8_conv_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
                     const float* __restrict__ amax, const float* __restrict__ mw, const float* __restrict__ bias,
                     OutT* __restrict__ out, int ho, int wo, int O, int cp, int stride, int bk, int tw_log2, int th,
                     int boxes_w, int boxes_img, int tiles_n, int tiles, int stages) {
  constexpr int CW = staging_cols(BN, sizeof(OutT));  // columns staged at a time: 128 bytes of a row
  constexpr int PITCH = CW + 8;         // a staged row, in elements
  constexpr int V = 16 / (int)sizeof(OutT);
  constexpr int CPR = CW / V;  // 16-byte pieces of a staged row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t a_bytes = BM * bk, sbytes = stage_bytes(BN, bk);
  OutT* staging = reinterpret_cast<OutT*>(smem + stages * sbytes);
  const uint32_t ring = smem_u32(smem);
  const uint32_t full0 = smem_u32(smem + stages * sbytes + staging_bytes(BN, sizeof(OutT)));
  const uint32_t empty0 = full0 + MAX_STAGES * 8;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);       // the producer's arrive with the stage's bytes
      mbar_init(empty0 + 8 * s, 8);      // one arrive from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int per_tap = (cp + bk - 1) / bk, KT = 9 * per_tap;

  if (warp >= 8) {  // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"((uint64_t)&x_map) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"((uint64_t)&w_map) : "memory");
      const uint32_t tx_bytes = a_bytes + BN * bk;  // whole boxes: TMA counts the zeros it fills
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Tile tl = decode(t, tiles_n, BN, boxes_w, boxes_img, th, tw_log2);
        for (int kt = 0; kt < KT; ++kt) {
          const int tap = kt / per_tap, k0 = (kt - tap * per_tap) * bk;
          const int ky = tap / 3, kx = tap - 3 * ky;
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage, a = ring + stage * sbytes;
          mbar_expect_tx(full, tx_bytes);
          tma_load_4d(a, &x_map, full, k0, tl.ox0 * stride + kx - 1, tl.oy0 * stride + ky - 1, tl.img);
          tma_load_3d(a + a_bytes, &w_map, full, k0, tap, tl.n0);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // consumer warpgroups 0 and 1: rows 64g .. 64g + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int g = warp >> 2, tg = tid & 127;
    const uint32_t layout = bk == 128 ? 1 : bk == 64 ? 2 : 3, sbo = 8 * bk;
    const int ksteps = bk / 32;
    const float sx = __fmul_rn(fmaxf(__ldg(amax), 1e-12f), kInv127Sq);
    const bool vec = O % V == 0;  // 16-byte stores stay aligned and within a pixel's channels
    OutT* stg = staging + g * 64 * PITCH;
    const int row0 = (warp & 3) * 16 + (lane >> 2), q2 = 2 * (lane & 3);  // fragment rows row0, row0 + 8
    const int tw = 1 << tw_log2;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;  // the first wgmma of a tile overwrites them (scale_d 0)
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int prev = 0;
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t a = ring + stage * sbytes;
        const uint64_t da = smem_desc(a + g * 64 * bk, layout, sbo), db = smem_desc(a + a_bytes, layout, sbo);
        wgmma_fence();
        for (int kk = 0; kk < ksteps; ++kk) wgmma_s8<BN>(acc, da + 2 * kk, db + 2 * kk, (kt | kk) != 0);
        wgmma_commit();
        if (kt > 0) {  // the previous stage's group is done: free its stage
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty0 + 8 * prev);
        }
        prev = stage;
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs<BN / 2>(acc);
      if (lane == 0) mbar_arrive(empty0 + 8 * prev);

      const Tile tl = decode(t, tiles_n, BN, boxes_w, boxes_img, th, tw_log2);
#pragma unroll
      for (int c = 0; c < BN / CW; ++c) {
#pragma unroll
        for (int kb = 0; kb < CW / 8; ++kb) {
          const int k = c * (CW / 8) + kb, col = kb * 8 + q2, o = tl.n0 + c * CW + col;
          float s0 = 0.f, s1 = 0.f, b0 = 0.f, b1 = 0.f;
          if (o < O) {
            s0 = __fmul_rn(__ldg(mw + o), sx);
            b0 = __ldg(bias + o);
          }
          if (o + 1 < O) {
            s1 = __fmul_rn(__ldg(mw + o + 1), sx);
            b1 = __ldg(bias + o + 1);
          }
          store_pair(stg + row0 * PITCH + col, __fmaf_rn(__int2float_rn(acc[4 * k]), s0, b0),
                     __fmaf_rn(__int2float_rn(acc[4 * k + 1]), s1, b1));
          store_pair(stg + (row0 + 8) * PITCH + col, __fmaf_rn(__int2float_rn(acc[4 * k + 2]), s0, b0),
                     __fmaf_rn(__int2float_rn(acc[4 * k + 3]), s1, b1));
        }
        bar_sync(1 + g, 128);
        for (int i = tg; i < 64 * CPR; i += 128) {
          const int r = i / CPR, piece = i - r * CPR, m = g * 64 + r;
          const int oy = tl.oy0 + (m >> tw_log2), ox = tl.ox0 + (m & (tw - 1));
          const int o = tl.n0 + c * CW + piece * V;
          if (oy >= ho || ox >= wo || o >= O) continue;
          const OutT* src = stg + r * PITCH + piece * V;
          OutT* dst = out + (((long long)tl.img * ho + oy) * wo + ox) * O + o;
          if (vec) {
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
          } else {
            for (int e = 0; e < V && o + e < O; ++e) dst[e] = src[e];
          }
        }
        bar_sync(1 + g, 128);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

constexpr int kMaxDevices = 64;

template <int BN, typename OutT>
int launch_bn(const CUtensorMap& xm, const CUtensorMap& wm, const float* amax, const float* mw, const float* bias,
              OutT* out, int n, int ho, int wo, int cp, int O, int stride, int bk, int tw, int th, int stages,
              cudaStream_t stream) {
  static bool smem_set[kMaxDevices] = {};
  static int sms[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  auto kernel = int8_conv_kernel<BN, OutT>;
  if (!smem_set[dev]) {  // once a device: the kernel may take up to the whole of an SM's shared memory
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    smem_set[dev] = true;
  }
  const int smem = 1024 + stages * stage_bytes(BN, bk) + staging_bytes(BN, sizeof(OutT)) + BAR_BYTES;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  int tw_log2 = 0;
  while ((1 << tw_log2) < tw) ++tw_log2;
  const int boxes_w = (wo + tw - 1) / tw, boxes_img = boxes_w * ((ho + th - 1) / th);
  const int tiles_n = (O + BN - 1) / BN;
  const long long tiles = (long long)n * boxes_img * tiles_n;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = tiles < sms[dev] ? (int)tiles : sms[dev];
  kernel<<<grid, THREADS, smem, stream>>>(xm, wm, amax, mw, bias, out, ho, wo, O, cp, stride, bk, tw_log2, th, boxes_w,
                                          boxes_img, tiles_n, (int)tiles, stages);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch_int8_conv(const int8_t* x, const int8_t* w, const float* amax, const float* mw, const float* bias,
                     OutT* out, int n, int h, int wd, int cp, int O, int stride, int bk, int bn, int tw, int th,
                     int stages, void* stream) {
  const bool plan_ok = (bk == 32 || bk == 64 || bk == 128) && cp % 32 == 0 && (stride == 1 || stride == 2) &&
                       O >= 1 && tw >= 1 && tw <= BM && (tw & (tw - 1)) == 0 && tw * th == BM && stages >= 2 &&
                       stages <= MAX_STAGES && ((uintptr_t)x & 15) == 0 && ((uintptr_t)w & 15) == 0;
  if (!plan_ok) return (int)cudaErrorInvalidValue;
  const int ho = (h - 1) / stride + 1, wo = (wd - 1) / stride + 1;
  if ((long long)n * h * wd == 0) return 0;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const CUtensorMapSwizzle swz = bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : bk == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
  // x as (cp, w, h, n), boxes of (bk, tw, th, 1) pixels taken every `stride` elements
  const cuuint64_t x_dims[4] = {(cuuint64_t)cp, (cuuint64_t)wd, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t x_strides[3] = {(cuuint64_t)cp, (cuuint64_t)wd * cp, (cuuint64_t)h * wd * cp};
  const cuuint32_t x_box[4] = {(cuuint32_t)bk, (cuuint32_t)(tw * stride), (cuuint32_t)(th * stride), 1};
  const cuuint32_t x_elem[4] = {1, (cuuint32_t)stride, (cuuint32_t)stride, 1};
  // w as (cp, 9, O), boxes of (bk, 1, bn)
  const cuuint64_t w_dims[3] = {(cuuint64_t)cp, 9, (cuuint64_t)O};
  const cuuint64_t w_strides[2] = {(cuuint64_t)cp, (cuuint64_t)9 * cp};
  const cuuint32_t w_box[3] = {(cuuint32_t)bk, 1, (cuuint32_t)bn};
  const cuuint32_t w_elem[3] = {1, 1, 1};
  CUtensorMap xm, wm;
  if (encode(&xm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, (void*)x, x_dims, x_strides, x_box, x_elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, (void*)w, w_dims, w_strides, w_box, w_elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (bn) {
    case 8: return launch_bn<8>(xm, wm, amax, mw, bias, out, n, ho, wo, cp, O, stride, bk, tw, th, stages, s);
    case 16: return launch_bn<16>(xm, wm, amax, mw, bias, out, n, ho, wo, cp, O, stride, bk, tw, th, stages, s);
    case 32: return launch_bn<32>(xm, wm, amax, mw, bias, out, n, ho, wo, cp, O, stride, bk, tw, th, stages, s);
    case 64: return launch_bn<64>(xm, wm, amax, mw, bias, out, n, ho, wo, cp, O, stride, bk, tw, th, stages, s);
    case 128: return launch_bn<128>(xm, wm, amax, mw, bias, out, n, ho, wo, cp, O, stride, bk, tw, th, stages, s);
    case 256: return launch_bn<256>(xm, wm, amax, mw, bias, out, n, ho, wo, cp, O, stride, bk, tw, th, stages, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (n, h, w, cp) int8 NHWC, w (O, 3, 3, cp) int8, amax a device scalar, mw
// (the weights' per-channel max(max|W[o]|, 1e-12)) and bias (O,) f32, out (n,
// ho, wo, O) f32 NHWC; pad 1, stride 1 or 2; contiguous, x and w 16-byte
// aligned, out 16-byte aligned; the tile plan (bk, bn, tw, th, stages) of
// ops/quant.py::int8_conv_plan.
extern "C" int disco_int8_conv(const int8_t* x, const int8_t* w, const float* amax, const float* mw,
                               const float* bias, float* out, int n, int h, int wd, int cp, int O, int stride, int bk,
                               int bn, int tw, int th, int stages, void* stream) {
  return launch_int8_conv(x, w, amax, mw, bias, out, n, h, wd, cp, O, stride, bk, bn, tw, th, stages, stream);
}

// The bf16 instance: out bf16, the f32 epilogue rounded once.
extern "C" int disco_int8_conv_bf16(const int8_t* x, const int8_t* w, const float* amax, const float* mw,
                                    const float* bias, __nv_bfloat16* out, int n, int h, int wd, int cp, int O,
                                    int stride, int bk, int bn, int tw, int th, int stages, void* stream) {
  return launch_int8_conv(x, w, amax, mw, bias, out, n, h, wd, cp, O, stride, bk, bn, tw, th, stages, stream);
}
