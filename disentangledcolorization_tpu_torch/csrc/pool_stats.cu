// Kernel A: per-cell soft pooling statistics of the 9-neighbour superpixel
// affinity, with kernel F's 9-direction shift-add as the epilogue of the same
// launch.
//
// Replaces disentangledcolorization_tpu/ops/pallas_superpixel.py::pool_stats
// (and ::_pool_sums, which poolfeat runs: the same sums without the hard
// counts), and the shift-add that follows both (pallas_superpixel.py:187,
// called at :206-208; ops/superpixel.py::poolfeat :81-85: XLA ops, no Pallas
// kernel). For every sp_h x sp_w cell (n, i, j) of the token grid, in f32:
//   t[n,i,j,d,c]  = scale * sum_{p in cell} prob[p,d] * feat[p,c]
//   mass[n,i,j,d] = scale * sum_{p in cell} prob[p,d]                       (where asked for)
//   hard[n,i,j,d] = scale * #{p in cell : prob[p,d] == max_e prob[p,e]}     (where asked for)
// (ties keep every winner, as ops/superpixel.py::hard_assignment does). Then,
// token (i, j) collects direction d from cell (i, j) - off_d, off_d the
// row-major offsets (-1,-1)..(1,1), zero off the hc x wc grid:
//   sum_t[n,i,j,c]  = sum_d t[n, (i,j) - off_d, d, c]      (and mass_sum, sizes from mass, hard)
// The epilogue's modes (ops/superpixel.py::pool_shift_add):
//   kPoolF32, kPoolBf16  pooling's forward: out = sum_t / (mass_sum + 1e-8), mass_sum, sizes
//                        (where hard is asked for); out and mass_sum bf16 in kPoolBf16 (serving),
//                        rounded to nearest even from the same f32 values
//   kSumF32              unpooling's token gradient, f32: out = sum_t
//   kSumBf16             the same for bf16 tokens, rounded where the JAX package's jax.vjp of
//                        ops/superpixel.py::upfeat rounds (the compiled HLO of that vjp, XLA on the
//                        CPU): each direction's f32 sum converted to bf16, then a chain of adds, each
//                        an f32 add converted to bf16, that starts at direction 8 and adds 7, ..., 0:
//                        a = bf16(t8); a = bf16(a + bf16(t7)); ...; a = bf16(a + bf16(t0))
//   kNone                kernel A alone (t, mass, hard), for the tests and the comparisons
// The 9 terms are added in the plain versions' order (ops/superpixel.py::_shift_add, d = 0..8, a
// zero term added where the source cell is off the grid; ::_shift_add_rounded), so the epilogue's
// outputs equal the plain shift-add of the kernel's own t, mass and hard bit for bit.
//
// The epilogue. t, mass and hard stay the exchange buffer in global memory
// (they are written anyway and sit in L2 when read back). With the epilogue
// on, both instances run a persistent grid whose blocks walk cells blockIdx.x,
// + gridDim.x, ... After each cell's writes and a block barrier, threads
// 0..8 arrive at the 4 to 9 in-grid tokens the cell feeds (thread d at token
// (i, j) + off_d): an atomic add with release and acquire semantics
// (atom.acq_rel.gpu) on the token's counter (int32, one a token, zero before
// and after every launch). The arrival whose count reaches the number of the
// token's in-grid neighbour cells (9 inside, 6 on an edge, 4 at a corner,
// fewer on grids 1 or 2 cells wide) is the token's last: its thread sets the
// counter back to 0 and records the token in the arrival's slot (else -1). A count is read only one cell after it was asked for, so no thread
// waits for the round trip, which under the streaming loads costs several
// microseconds; and at its end each block, all threads together, finishes
// the tokens its cells' arrivals recorded, their loads in flight at once
// (through L2: ld.global.cg, never the read-only path). No block waits on
// another, so any grid works and no block needs another to be resident. So
// pooling is one launch where kernels A and F were two, and the bf16 serving
// forward loses the two casts of pooled and mass too. The counters are
// scratch the wrapper keeps per (device, stream) and per graph capture, and
// never frees, so a captured CUDA graph keeps a valid pointer; the slots are
// allocated each call. Without the epilogue the f32 instance is one block a
// cell, as before.
//
// Bound: bytes. One read of feat (N,H,W,C) and prob (N,H,W,9) dominates (about
// 20.3 MB per 256x256 image at C=66 in f32); the 9*C multiply-adds a pixel are
// far below the card's f32 rate.
//
// f32 features: one block per cell (a persistent grid of the same per-cell work with the epilogue).
//  - The cell's affinities are staged in shared memory row by row (a cell row
//    is sp_w*9 contiguous floats), each pixel padded to 12 floats so that three
//    16-byte loads fetch its 9 values; the index needs a division by the
//    constant 9 only.
//  - A thread owns one vector of channels (16 bytes where C % 4 == 0, 8 where
//    C % 2 == 0, else 4; narrower where feat is not aligned to the vector) and
//    every G-th pixel, with 9 x width sums in registers. The block's shape
//    follows C / width (16 x 16 at C=64, 33 x 7 at C=66), vectors fastest, so a
//    warp reads one contiguous run. kUnroll read-only vector loads are issued
//    before the first is used.
//  - The G partial sums of each (d, c) are added in a fixed order through
//    shared memory; mass and hard are 18 warp tasks (a lane adds every 32nd
//    pixel, then a shuffle tree). No atomics in the sums: the same inputs give
//    the same bits.
//
// bf16 features (disco_pool_stats_bf16: the bf16 serving proxy at C=66, bf16
// training's unpooling cotangent at C=64, spix_pos at C=130): the same f32
// outputs, the sums in f32 as the JAX package takes them (ops/superpixel.py::
// poolfeat promotes the operands). The loop above, run on bf16, issues one
// 4-byte load and three 16-byte shared loads a pixel per 18 multiply-adds and
// waits on its loads; on the card it takes the f32 instance's time with half
// the bytes, so this instance streams instead (tile_stream.cuh):
//  - One persistent grid walks the cells, at most 4 blocks an SM (3 at two
//    pairs a thread). A unit is `rows` rows of a cell: about 12 KB of features
//    and affinities in a ring of 3 shared stages where the masses or counts are
//    asked for (4 rows at C=66, 2 at C=130), about 24 KB in 2 stages where not
//    (8 rows at C=64), the plans the card measured fastest (PERF.md).
//    Each row's features (sp_w*C*2 bytes) and affinities (sp_w*36) are
//    contiguous spans, copied with 16-byte cp.async; the ring runs on from one
//    cell into the next. A span's bytes start anywhere: the copy takes the
//    16-byte chunks that cover them, so C need not be a multiple of 8.
//  - Each unit's affinities are repacked once (a thread a pixel) into the
//    12-float layout above, with the winners' bit mask; the same threads add
//    each pixel's 9 masses and winner bits to their own slot in shared memory
//    (counts 16 bits each), which 18 warp tasks reduce in a fixed order at the
//    cell's end.
//  - A thread owns kp channel pairs (pairs tx, tx + bx, ...; one where a
//    pixel's pairs fit a block, C <= 512, else two: ops/superpixel.py::
//    pool_bf16_plan) x the 9 directions in registers and every G-th pixel of
//    each unit (G <= 8 pixel groups); a pair is one 4-byte shared load where C
//    is even and feat 4-byte aligned, else two 2-byte loads. At the cell's end
//    the G partials of each output are added in the order of the group (at
//    most 8 terms). The order of the f32 sums is fixed, so the results are
//    deterministic; it is not the f32 instance's.
//  - Past C = 1024 (more than 256 x 2 pairs a pixel) the bf16 features take
//    the f32 kernel's loop with 2-byte loads (no path of the port is that wide).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_stream.cuh"
#include "vector_loads.cuh"

namespace {

constexpr int kThreads = 256;  // threads a block; a multiple of 32
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;     // feature loads a thread has in flight (f32 loop)
constexpr int kPad = 12;       // floats a staged pixel: 9 affinities, its winners' bit mask, 2 unused
constexpr int kMaxGroups = 8;  // the bf16 ring's pixel groups at most: ops/superpixel.py::POOL_GROUPS
constexpr int kStaticSmem = 1280;  // static shared memory a block may take beside the dynamic, at most (the epilogue's)

enum : int { kNone = 0, kPoolF32 = 1, kPoolBf16 = 2, kSumF32 = 3, kSumBf16 = 4 };

struct Epilogue {
  int mode;
  void* out;       // (n,hc,wc,C): the pooled features or the sum; bf16 in kPoolBf16 and kSumBf16, else f32
  void* mass_sum;  // (n,hc,wc): the pooling modes; bf16 in kPoolBf16, else f32
  float* sizes;    // (n,hc,wc) where hard is written, else null
  int* counters;   // (n,hc,wc): zero before and after every launch
  int* slots;      // (n,hc,wc,9): the finisher of each arrival, -1 or the token (written, then read, by one block)
};

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// Adds 1 to *p at GPU scope with acquire and release semantics; returns the value before.
__device__ __forceinline__ int atomic_add_acq_rel(int* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n" : "=r"(old) : "l"(p) : "memory");
  return old;
}

// The block's shared list of the tokens its arrivals were the last of (kFinSlots at most; past that the
// global slots alone hold them, and finish_tokens reads those).
constexpr int kFinSlots = 256;
struct Winners {
  int tok[kFinSlots];
  int n;
};

// A thread's arrival in flight: the token it counted, the count it found, the count that finishes the token,
// and the slot that records the outcome (-1: none in flight).
struct Arrival {
  int slot, tok, old, need;
};

// Records the outcome of arrival a, whose count has long returned: the token where this arrival was its last
// (its counter back to 0 for the next launch, the token on the block's list), else -1.
__device__ __forceinline__ void settle(const Epilogue& e, Arrival& a, Winners& win) {
  if (a.slot < 0) return;
  int fin = -1;
  if (a.tok >= 0 && a.old == a.need - 1) {
    e.counters[a.tok] = 0;
    fin = a.tok;
    const int k = atomicAdd(&win.n, 1);
    if (k < kFinSlots) win.tok[k] = fin;
  }
  __stcg(e.slots + a.slot, fin);
  a.slot = -1;
}

// Called by thread d = 0..8 after a barrier that follows cell (n, i, j)'s writes of t, mass and hard: it
// settles its previous arrival and arrives at the token the cell feeds in direction d, (i, j) + off_d, by an
// atomic add with release and acquire semantics (the release covers the block's writes the barrier ordered
// before it; the acquire, in the token's last arrival, the other cells' writes). The count is read one
// cell later, so no thread waits for it.
__device__ __forceinline__ void arrive(const Epilogue& e, Arrival& a, Winners& win, int cell, int n, int i, int j,
                                       int hc, int wc) {
  settle(e, a, win);
  const int d = threadIdx.x, ti = i + d / 3 - 1, tj = j + d % 3 - 1;
  a.slot = cell * 9 + d;
  a.tok = -1;
  if (ti >= 0 && ti < hc && tj >= 0 && tj < wc) {
    a.tok = (n * hc + ti) * wc + tj;
    a.need = (1 + (ti > 0) + (ti < hc - 1)) * (1 + (tj > 0) + (tj < wc - 1));
    a.old = atomic_add_acq_rel(e.counters + a.tok);
  }
}

// At the block's end, after its last arrival is settled and a barrier: the block's threads finish every
// token whose last contributor was one of the block's cells, together, each token's 9 terms added in the
// order of d with a zero term off the grid. The tokens come from the shared list, or, where it overflowed,
// from the slots of the block's cells (cells blockIdx.x, + gridDim.x, ...) in rounds of kFinSlots.
__device__ void finish_tokens(const Epilogue& e, const float* t, const float* mass, const float* hard, int cells,
                              int hc, int wc, int C, Winners& win) {
  const int slots = (cells - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * 9;  // the block's cells' slots
  const bool pool = e.mode == kPoolF32 || e.mode == kPoolBf16, listed = win.n <= kFinSlots;
  for (int base = 0; base < (listed ? 1 : slots); base += kFinSlots) {
    if (!listed) {
      __syncthreads();
      if (threadIdx.x == 0) win.n = 0;
      __syncthreads();
      for (int q = base + threadIdx.x; q < slots && q < base + kFinSlots; q += blockDim.x) {
        const int k = q / 9;
        const int tok = __ldcg(e.slots + ((long long)blockIdx.x + (long long)k * gridDim.x) * 9 + (q - 9 * k));
        if (tok >= 0) win.tok[atomicAdd(&win.n, 1)] = tok;
      }
      __syncthreads();
    }
    const int nf = win.n;
    for (int w = threadIdx.x; w < nf * C; w += blockDim.x) {
      const int f = w / C, c = w - f * C, tok = win.tok[f];
      const int tj = tok % wc, ti = (tok / wc) % hc, tn = tok / (wc * hc);
      int src[9];  // direction d's source cell, -1 off the grid
#pragma unroll
      for (int d = 0; d < 9; ++d) {
        const int si = ti - (d / 3 - 1), sj = tj - (d % 3 - 1);
        src[d] = si >= 0 && si < hc && sj >= 0 && sj < wc ? (tn * hc + si) * wc + sj : -1;
      }
      float v[9];
#pragma unroll
      for (int d = 0; d < 9; ++d) v[d] = src[d] >= 0 ? __ldcg(t + ((long long)src[d] * 9 + d) * C + c) : 0.f;
      const long long o = (long long)tok * C + c;
      if (e.mode == kSumBf16) {  // an off-grid term is a zero slab in the plain version: a + 0 leaves a as it is
        float a = src[8] >= 0 ? round_bf16(v[8]) : 0.f;
#pragma unroll
        for (int d = 7; d >= 0; --d)
          if (src[d] >= 0) a = round_bf16(a + round_bf16(v[d]));
        static_cast<__nv_bfloat16*>(e.out)[o] = __float2bfloat16_rn(a);
        continue;
      }
      float a = v[0];
#pragma unroll
      for (int d = 1; d < 9; ++d) a += v[d];
      if (!pool) {
        static_cast<float*>(e.out)[o] = a;
        continue;
      }
      float m = src[0] >= 0 ? __ldcg(mass + (long long)src[0] * 9) : 0.f;  // every channel adds the 9 masses
#pragma unroll
      for (int d = 1; d < 9; ++d) m += src[d] >= 0 ? __ldcg(mass + (long long)src[d] * 9 + d) : 0.f;
      if (e.mode == kPoolBf16)
        static_cast<__nv_bfloat16*>(e.out)[o] = __float2bfloat16_rn(a / (m + 1e-8f));
      else
        static_cast<float*>(e.out)[o] = a / (m + 1e-8f);
      if (c == 0) {
        if (e.mode == kPoolBf16)
          static_cast<__nv_bfloat16*>(e.mass_sum)[tok] = __float2bfloat16_rn(m);
        else
          static_cast<float*>(e.mass_sum)[tok] = m;
        if (hard != nullptr) {
          float sz = src[0] >= 0 ? __ldcg(hard + (long long)src[0] * 9) : 0.f;
#pragma unroll
          for (int d = 1; d < 9; ++d) sz += src[d] >= 0 ? __ldcg(hard + (long long)src[d] * 9 + d) : 0.f;
          e.sizes[tok] = sz;
        }
      }
    }
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&r)[VEC]) {
  if constexpr (VEC == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(r[0], r[1], r[2], r[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(r[4], r[5], r[6], r[7]);
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
  } else {
    p[0] = r[0];
  }
}

// One cell (n, i, j): bx threads share a pixel and split its channel vectors;
// G pixel groups. T: the features' type (float, or __nv_bfloat16 past C =
// 1024); sums are f32.
template <typename T, int VEC>
__device__ __forceinline__ void pool_cell(const T* __restrict__ feat, const float* __restrict__ prob,
                                          float* __restrict__ t, float* __restrict__ mass, float* __restrict__ hard,
                                          float* sprob, float* spart, int cell, int W, int C, int sp_h, int sp_w,
                                          int hc, int wc, float scale, int bx, int G, const Epilogue* epi = nullptr,
                                          Arrival* arr = nullptr, Winners* win = nullptr, int prev = -1) {
  const int npix = sp_h * sp_w;
  const int j = cell % wc;
  const int i = (cell / wc) % hc;
  const long long n = cell / (wc * hc);
  const long long pix0 = ((n * hc + i) * sp_h) * W + (long long)j * sp_w;  // the cell's first pixel
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int py = warp; py < sp_h; py += kWarps) {
    const float* src = prob + (pix0 + (long long)py * W) * 9;
    float* dst = sprob + py * sp_w * kPad;
    for (int e = lane; e < sp_w * 9; e += 32) {
      const int px = e / 9;
      dst[px * kPad + (e - px * 9)] = __ldg(src + e);
    }
  }
  __syncthreads();
  // the previous cell's arrival, a barrier after its writes, when this thread has no store in flight
  if (arr != nullptr && prev >= 0 && tid < 9)
    arrive(*epi, arr[tid], *win, prev, prev / (wc * hc), (prev / wc) % hc, prev % wc, hc, wc);

  if (hard != nullptr) {  // the same for the whole block
    for (int p = tid; p < npix; p += kThreads) {
      const float* pp = sprob + p * kPad;
      float m = pp[0];
#pragma unroll
      for (int d = 1; d < 9; ++d) m = fmaxf(m, pp[d]);
      int win = 0;
#pragma unroll
      for (int d = 0; d < 9; ++d) win |= (pp[d] == m ? 1 : 0) << d;
      sprob[p * kPad + 9] = __int_as_float(win);
    }
    __syncthreads();
  }
  for (int task = warp; task < 18; task += kWarps) {
    const int d = task % 9;
    const bool count = task >= 9;
    float* dst = count ? hard : mass;
    if (dst == nullptr) continue;
    float s = 0.f;
    for (int p = lane; p < npix; p += 32) {
      const float v = sprob[p * kPad + (count ? 9 : d)];
      s += count ? (float)((__float_as_int(v) >> d) & 1) : v;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) dst[(long long)cell * 9 + d] = s * scale;
  }

  const int tx = tid % bx, ty = tid / bx;
  const int step_y = G / sp_w, step_x = G % sp_w;
  if (ty < G) {
    for (int c = tx * VEC; c < C; c += bx * VEC) {
      float acc[9][VEC];
#pragma unroll
      for (int d = 0; d < 9; ++d) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[d][e] = 0.f;
      }
      int py = ty / sp_w, px = ty % sp_w;
      for (int p = ty; p < npix; p += G * kUnroll) {
        float f[kUnroll][VEC];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (p + u * G < npix) load_vec<VEC>(feat + (pix0 + (long long)py * W + px) * C + c, f[u]);
          px += step_x, py += step_y;
          if (px >= sp_w) px -= sp_w, ++py;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (p + u * G < npix) {
            const float4* q = reinterpret_cast<const float4*>(sprob + (p + u * G) * kPad);
            const float4 a = q[0], b = q[1], cc = q[2];
            const float pr[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, cc.x};
#pragma unroll
            for (int d = 0; d < 9; ++d) {
#pragma unroll
              for (int e = 0; e < VEC; ++e) acc[d][e] = fmaf(pr[d], f[u][e], acc[d][e]);
            }
          }
        }
      }
#pragma unroll
      for (int d = 0; d < 9; ++d) store_vec<VEC>(spart + (ty * 9 + d) * C + c, acc[d]);
    }
  }
  __syncthreads();

  float* tc = t + (long long)cell * 9 * C;
  for (int e = tid; e < 9 * C; e += kThreads) {
    float s = spart[e];
    for (int g = 1; g < G; ++g) s += spart[g * 9 * C + e];
    tc[e] = s * scale;
  }
}

// Kernel A for f32 features (and bf16 past C = 1024). Without the epilogue:
// one block a cell. With it: a persistent grid whose blocks walk cells
// blockIdx.x, + gridDim.x, ... (the same sums in the same order, so the same
// bits), arrive after each and finish their tokens at the end.
template <typename T, int VEC, bool EPI>
__global__ void __launch_bounds__(kThreads)
pool_stats_kernel(const T* __restrict__ feat, const float* __restrict__ prob,
                  float* __restrict__ t, float* __restrict__ mass, float* __restrict__ hard, const Epilogue epi,
                  int W, int C, int sp_h, int sp_w, int hc, int wc, int cells, float scale, int bx, int G) {
  extern __shared__ float4 smem[];
  float* sprob = reinterpret_cast<float*>(smem);  // npix * kPad
  float* spart = sprob + sp_h * sp_w * kPad;      // G * 9 * C
  if constexpr (!EPI) {
    pool_cell<T, VEC>(feat, prob, t, mass, hard, sprob, spart, blockIdx.x, W, C, sp_h, sp_w, hc, wc, scale, bx, G);
  } else {
    __shared__ Arrival s_arr[9];  // threads 0..8's arrivals in flight, kept out of the registers of the loop
    __shared__ Winners s_win;
    if (threadIdx.x < 9) s_arr[threadIdx.x] = Arrival{-1, -1, 0, 0};
    if (threadIdx.x == 0) s_win.n = 0;
    int prev = -1;
    for (int cell = blockIdx.x; cell < cells; prev = cell, cell += gridDim.x)
      pool_cell<T, VEC>(feat, prob, t, mass, hard, sprob, spart, cell, W, C, sp_h, sp_w, hc, wc, scale, bx, G, &epi,
                        s_arr, &s_win, prev);
    __syncthreads();  // the last cell's t, mass and hard are written
    if (threadIdx.x < 9) {
      arrive(epi, s_arr[threadIdx.x], s_win, prev, prev / (wc * hc), (prev / wc) % hc, prev % wc, hc, wc);
      settle(epi, s_arr[threadIdx.x], s_win);
    }
    __syncthreads();
    finish_tokens(epi, t, mass, hard, cells, hc, wc, C, s_win);
  }
}

// The blocks an SM holds of kernel instance K at `smem` dynamic bytes, cached
// by instance and size. Only the grid's balance rests on it: no block of
// these kernels waits for another.
template <auto K>
int resident_blocks(int threads, size_t smem) {
  static size_t last_smem = (size_t)-1;
  static int last = 0;
  if (smem != last_smem) {
    int nb = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, K, threads, smem) != cudaSuccess) return 0;
    last = nb, last_smem = smem;
  }
  return last;
}

template <typename T, int VEC, bool EPI>
int launch_cells(const T* feat, const float* prob, float* t, float* mass, float* hard, const Epilogue& epi, int n, int h,
                 int w, int c, int sp_h, int sp_w, float scale, cudaStream_t stream) {
  const int hc = h / sp_h, wc = w / sp_w, npix = sp_h * sp_w, cells = n * hc * wc;
  const int cv = c / VEC;
  const int bx = cv < kThreads ? cv : kThreads;
  int G = kThreads / bx;
  if (G > npix) G = npix;
  const size_t smem = sizeof(float) * ((size_t)npix * kPad + (size_t)G * 9 * c);
  if (smem + kStaticSmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(pool_stats_kernel<T, VEC, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)cudaGetLastError();
  }
  int grid = cells;
  if constexpr (EPI) {
    int dev = 0;
    cudaGetDevice(&dev);
    const int per_sm = resident_blocks<pool_stats_kernel<T, VEC, EPI>>(kThreads, smem);
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    grid = balanced_grid(cells, per_sm, dev);
  }
  pool_stats_kernel<T, VEC, EPI><<<grid, kThreads, smem, stream>>>(
      feat, prob, t, mass, hard, epi, w, c, sp_h, sp_w, hc, wc, cells, scale, bx, G);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch(const T* feat, const float* prob, float* t, float* mass, float* hard, const Epilogue& epi, int n, int h,
           int w, int c, int sp_h, int sp_w, float scale, cudaStream_t stream) {
  if (epi.mode == kNone)
    return launch_cells<T, VEC, false>(feat, prob, t, mass, hard, epi, n, h, w, c, sp_h, sp_w, scale, stream);
  return launch_cells<T, VEC, true>(feat, prob, t, mass, hard, epi, n, h, w, c, sp_h, sp_w, scale, stream);
}

// ---- the bf16 instance: a persistent grid streaming cell rows through a ring ----

struct Ring {  // ops/superpixel.py::pool_bf16_plan, and what follows from it
  int kp, bx, groups;  // channel pairs a thread, threads a pixel, pixel groups
  int rows, units;     // cell rows a unit, units a cell
  int stages;          // ring stages, 2 or 3
  int frs, prs;        // bytes a staged feature row, a staged affinity row (a span rounded up to 16, plus 16)
  int stage_bytes;     // rows * (frs + prs)
  int aligned;         // every row span 16-byte aligned and a multiple of 16 bytes: whole chunks, no lead
  FastDiv wc_div, hc_div, spw_div, fch_div, pch_div;  // by wc, hc, sp_w, a row's feature and affinity chunks
};

// Pixel slots of the masses and counts: one a repacking thread.
__host__ __device__ inline int stat_slots(const Ring& r, int sp_w) {
  return r.rows * sp_w < kThreads ? r.rows * sp_w : kThreads;
}

// Dynamic shared memory of a block: the ring, the repacked affinities of a
// unit, the partial sums, and each pixel slot's 9 masses (f32) and 9 winner
// counts (16 bits each, two to a word).
__host__ __device__ inline long long ring_smem(const Ring& r, int C, int sp_w) {
  return (long long)r.stages * r.stage_bytes + 4LL * r.rows * sp_w * kPad + 4LL * r.groups * 9 * C +
         4LL * 14 * stat_slots(r, sp_w);
}

// Channels 2q, 2q+1 of a staged pixel (the second 0 past C): one 4-byte load
// where PAIR (C even, the pixel 4-byte aligned), else two 2-byte loads.
template <bool PAIR>
__device__ __forceinline__ void load_pair(const unsigned char* px, int q, int C, float& a, float& b) {
  if constexpr (PAIR) {
    const unsigned v = *reinterpret_cast<const unsigned*>(px + 4 * q);
    a = __uint_as_float(v << 16), b = __uint_as_float(v & 0xffff0000u);
  } else {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(px) + 2 * q;
    a = __uint_as_float((unsigned)h[0] << 16);
    b = 2 * q + 1 < C ? __uint_as_float((unsigned)h[1] << 16) : 0.f;
  }
}

// Cell c's image, cell row and column, by multiply-high divisions (cells < 2^31).
__device__ __forceinline__ void cell_at(const Ring& rg, int c, int& n, int& i, int& j) {
  const int q = rg.wc_div.div(c);
  j = c - q * rg.wc_div.d;
  n = rg.hc_div.div(q);
  i = q - n * rg.hc_div.d;
}

template <int KP, bool PAIR, bool STATS, bool EPI>
__global__ void __launch_bounds__(kThreads, KP == 1 ? 4 : 3)
pool_bf16_kernel(const __nv_bfloat16* __restrict__ feat, const float* __restrict__ prob, float* __restrict__ t,
                 float* __restrict__ mass, float* __restrict__ hard, const Epilogue epi, int W, int C, int sp_h,
                 int sp_w, int hc, int wc, int cells, float scale, const Ring rg, uintptr_t feat_end,
                 uintptr_t prob_end) {
  extern __shared__ __align__(16) unsigned char sbuf[];
  float* const sprob = reinterpret_cast<float*>(sbuf + (long long)rg.stages * rg.stage_bytes);  // [rows*sp_w][kPad]
  float* const spart = sprob + rg.rows * sp_w * kPad;                                           // [groups][9][C]
  const int S = stat_slots(rg, sp_w);
  float* const smass = spart + rg.groups * 9 * C;                                     // [9][S]
  unsigned* const scount = reinterpret_cast<unsigned*>(smass + 9 * S);                // [5][S]: counts 2k, 2k+1
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % rg.bx, ty = tid / rg.bx;
  const int CP = (C + 1) / 2;
  const int fspan = sp_w * C * 2, pspan = sp_w * 36;           // bytes of a cell row's features, affinities
  const uintptr_t fpitch = (uintptr_t)W * C * 2, ppitch = (uintptr_t)W * 36;  // bytes an image row

  // The producer's cursor runs stages - 1 units ahead of the consumer's,
  // through the same cells: cell pc (image pn, row pi, column pj), unit pu,
  // into stage ps.
  int pc = blockIdx.x, pu = 0, ps = 0, pn = 0, pi = 0, pj = 0;
  if (pc < cells) cell_at(rg, pc, pn, pi, pj);
  auto issue = [&]() {  // always commits a group, empty past the last cell
    if (pc < cells) {
      const int r0 = pu * rg.rows, nr = sp_h - r0 < rg.rows ? sp_h - r0 : rg.rows;
      const long long px0 = ((long long)(pn * hc + pi) * sp_h + r0) * W + (long long)pj * sp_w;
      const uintptr_t fa = reinterpret_cast<uintptr_t>(feat + px0 * C), pa = reinterpret_cast<uintptr_t>(prob + px0 * 9);
      unsigned char* st = sbuf + ps * rg.stage_bytes;
      unsigned char* sp = st + rg.rows * rg.frs;
      if (rg.aligned) {  // whole 16-byte chunks, row by row, all threads over the unit's chunks
        const int fch = rg.fch_div.d, pch = rg.pch_div.d;
        for (int k = tid; k < nr * fch; k += kThreads) {
          const int r = rg.fch_div.div(k), c16 = k - r * fch;
          cp_async16(st + r * rg.frs + 16 * c16, reinterpret_cast<const void*>(fa + r * fpitch + 16 * c16), 16);
        }
        for (int k = tid; k < nr * pch; k += kThreads) {
          const int r = rg.pch_div.div(k), c16 = k - r * pch;
          cp_async16(sp + r * rg.prs + 16 * c16, reinterpret_cast<const void*>(pa + r * ppitch + 16 * c16), 16);
        }
      } else {
        for (int r = 0; r < nr; ++r) {
          copy_span_async(st + r * rg.frs, fa + r * fpitch, fspan, feat_end);
          copy_span_async(sp + r * rg.prs, pa + r * ppitch, pspan, prob_end);
        }
      }
      if (++pu == rg.units) {
        pu = 0, pc += gridDim.x;
        if (pc < cells) cell_at(rg, pc, pn, pi, pj);
      }
      ps = ps + 1 == rg.stages ? 0 : ps + 1;
    }
    cp_async_commit();
  };
  for (int s = 0; s < rg.stages - 1; ++s) issue();

  float acc[9][2 * KP];
#pragma unroll
  for (int d = 0; d < 9; ++d)
#pragma unroll
    for (int e = 0; e < 2 * KP; ++e) acc[d][e] = 0.f;
  __shared__ Arrival s_arr[9];  // EPI: threads 0..8's arrivals in flight, kept out of the registers of the loop
  __shared__ Winners s_win;
  if (EPI && tid < 9) s_arr[tid] = Arrival{-1, -1, 0, 0};
  if (EPI && tid == 0) s_win.n = 0;
  int prev = -1;  // the cell before this one, whose arrival comes after the next barrier

  int stage = 0;
  for (int cell = blockIdx.x; cell < cells; prev = cell, cell += gridDim.x) {
    int n, i, j;
    cell_at(rg, cell, n, i, j);
    for (int u = 0; u < rg.units; ++u, stage = stage + 1 == rg.stages ? 0 : stage + 1) {
      if (rg.stages == 3)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();  // unit u has landed, and every thread is done with the stage issue() refills
      if constexpr (EPI) {  // the previous cell's arrival, a barrier after its writes
        if (u == 0 && prev >= 0 && tid < 9)
          arrive(epi, s_arr[tid], s_win, prev, prev / (wc * hc), (prev / wc) % hc, prev % wc, hc, wc);
      }
      issue();
      const int r0 = u * rg.rows, nr = sp_h - r0 < rg.rows ? sp_h - r0 : rg.rows, npx = nr * sp_w;
      const long long px0 = ((long long)(n * hc + i) * sp_h + r0) * W + (long long)j * sp_w;
      const unsigned char* st = sbuf + stage * rg.stage_bytes;
      const uintptr_t fa0 = reinterpret_cast<uintptr_t>(feat + px0 * C);
      const uintptr_t pa0 = reinterpret_cast<uintptr_t>(prob + px0 * 9);

      for (int p = tid; p < npx; p += kThreads) {  // repack the unit's affinities, a thread a pixel
        const int r = rg.spw_div.div(p), col = p - r * sp_w;
        const float* src = reinterpret_cast<const float*>(st + rg.rows * rg.frs + r * rg.prs +
                                                          (int)((pa0 + r * ppitch) & 15)) + col * 9;
        float v[9];
#pragma unroll
        for (int d = 0; d < 9; ++d) v[d] = src[d];
        float m = v[0];
#pragma unroll
        for (int d = 1; d < 9; ++d) m = fmaxf(m, v[d]);
        int win = 0;
#pragma unroll
        for (int d = 0; d < 9; ++d) win |= (v[d] == m ? 1 : 0) << d;
        float4* dst = reinterpret_cast<float4*>(sprob + p * kPad);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
        dst[2] = make_float4(v[8], __int_as_float(win), 0.f, 0.f);
        if constexpr (STATS) {  // slot tid's sums over the cell's units, restarted at its first
          const bool first = u == 0 && p == tid;
#pragma unroll
          for (int d = 0; d < 9; ++d) smass[d * S + tid] = first ? v[d] : smass[d * S + tid] + v[d];
#pragma unroll
          for (int k = 0; k < 5; ++k) {
            const unsigned add = ((win >> 2 * k) & 1) | (((win >> (2 * k + 1)) & 1) << 16);
            scount[k * S + tid] = first ? add : scount[k * S + tid] + add;
          }
        }
      }
      __syncthreads();

      if (ty < rg.groups) {
        const int sy = rg.spw_div.div(rg.groups), sx = rg.groups - sy * sp_w;
        int r = rg.spw_div.div(ty), col = ty - r * sp_w;
        const unsigned char* row = st + r * rg.frs + (int)((fa0 + r * fpitch) & 15);
        for (int p = ty; p < npx; p += rg.groups) {
          const unsigned char* px = row + col * C * 2;
          const float4* q = reinterpret_cast<const float4*>(sprob + p * kPad);
          const float4 a = q[0], b = q[1], cc = q[2];
          const float pr[9] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, cc.x};
#pragma unroll
          for (int m = 0; m < KP; ++m) {
            const int qq = tx + m * rg.bx;
            if (qq < CP) {
              float f0, f1;
              load_pair<PAIR>(px, qq, C, f0, f1);
#pragma unroll
              for (int d = 0; d < 9; ++d) {
                acc[d][2 * m] = fmaf(pr[d], f0, acc[d][2 * m]);
                acc[d][2 * m + 1] = fmaf(pr[d], f1, acc[d][2 * m + 1]);
              }
            }
          }
          col += sx;
          int dr = sy;
          if (col >= sp_w) col -= sp_w, ++dr;
          if (dr) r += dr, row = st + r * rg.frs + (int)((fa0 + r * fpitch) & 15);
        }
      }
      if (u + 1 < rg.units) continue;

      // the cell's end: partials through shared memory, added in the order of the group
      if (ty < rg.groups) {
#pragma unroll
        for (int m = 0; m < KP; ++m) {
          const int qq = tx + m * rg.bx;
          if (qq < CP) {
#pragma unroll
            for (int d = 0; d < 9; ++d) {
              float* o = spart + (ty * 9 + d) * C + 2 * qq;
              o[0] = acc[d][2 * m];
              if (2 * qq + 1 < C) o[1] = acc[d][2 * m + 1];
            }
          }
        }
      }
#pragma unroll
      for (int d = 0; d < 9; ++d)
#pragma unroll
        for (int e = 0; e < 2 * KP; ++e) acc[d][e] = 0.f;
      __syncthreads();
      float* tc = t + (long long)cell * 9 * C;
      for (int e = tid; e < 9 * C; e += kThreads) {
        float s = spart[e];
        for (int g = 1; g < rg.groups; ++g) s += spart[g * 9 * C + e];
        tc[e] = s * scale;
      }
      if constexpr (STATS) {  // 18 warp tasks over the slots: a lane adds every 32nd, then a shuffle tree
        for (int task = warp; task < 18; task += kWarps) {
          const int d = task % 9;
          float* dst = task < 9 ? mass : hard;
          if (dst == nullptr) continue;
          float s = 0.f;
          for (int q = lane; q < S; q += 32)
            s += task < 9 ? smass[d * S + q] : (float)((scount[(d >> 1) * S + q] >> (16 * (d & 1))) & 0xffffu);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
          if (lane == 0) dst[(long long)cell * 9 + d] = s * scale;
        }
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (EPI) {
    __syncthreads();  // the last cell's t, mass and hard are written
    if (prev >= 0 && tid < 9)
      arrive(epi, s_arr[tid], s_win, prev, prev / (wc * hc), (prev / wc) % hc, prev % wc, hc, wc);
    if (tid < 9) settle(epi, s_arr[tid], s_win);
    __syncthreads();
    finish_tokens(epi, t, mass, hard, cells, hc, wc, C, s_win);
  }
}

template <int KP, bool PAIR, bool STATS, bool EPI>
int launch_ring(const __nv_bfloat16* feat, const float* prob, float* t, float* mass, float* hard, const Epilogue& epi,
                int n, int h, int w, int c, int sp_h, int sp_w, float scale, const Ring& rg, int per_sm,
                cudaStream_t stream) {
  int dev = 0;
  cudaGetDevice(&dev);
  static long long smem_set[64] = {};  // the dynamic shared memory this instance may take, by device
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  const long long smem = ring_smem(rg, c, sp_w);
  if (smem + kStaticSmem > 48 * 1024 && smem > smem_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(pool_bf16_kernel<KP, PAIR, STATS, EPI>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)cudaGetLastError();
    smem_set[dev] = smem;
  }
  const int threads = kThreads;
  const int resident = resident_blocks<pool_bf16_kernel<KP, PAIR, STATS, EPI>>(threads, (size_t)smem);
  if (resident < 1) return (int)cudaErrorInvalidConfiguration;
  const int hc = h / sp_h, wc = w / sp_w;
  const int cells = n * hc * wc;  // below 2^31 (the wrapper's check)
  const int grid = balanced_grid(cells, per_sm < resident ? per_sm : resident, dev);
  const uintptr_t fend = reinterpret_cast<uintptr_t>(feat + (long long)n * h * w * c);
  const uintptr_t pend = reinterpret_cast<uintptr_t>(prob + (long long)n * h * w * 9);
  pool_bf16_kernel<KP, PAIR, STATS, EPI><<<grid, threads, (size_t)smem, stream>>>(
      feat, prob, t, mass, hard, epi, w, c, sp_h, sp_w, hc, wc, cells, scale, rg, fend, pend);
  return (int)cudaGetLastError();
}

template <int KP, bool PAIR>
int launch_ring_stats(const __nv_bfloat16* feat, const float* prob, float* t, float* mass, float* hard, const Epilogue& epi,
                int n, int h, int w, int c, int sp_h, int sp_w, float scale, const Ring& rg, int per_sm,
                cudaStream_t stream) {
  const bool stats = mass != nullptr || hard != nullptr, epi_on = epi.mode != kNone;
  if (stats && epi_on)
    return launch_ring<KP, PAIR, true, true>(feat, prob, t, mass, hard, epi, n, h, w, c, sp_h, sp_w, scale, rg, per_sm, stream);
  if (stats)
    return launch_ring<KP, PAIR, true, false>(feat, prob, t, mass, hard, epi, n, h, w, c, sp_h, sp_w, scale, rg, per_sm, stream);
  if (epi_on)
    return launch_ring<KP, PAIR, false, true>(feat, prob, t, mass, hard, epi, n, h, w, c, sp_h, sp_w, scale, rg, per_sm, stream);
  return launch_ring<KP, PAIR, false, false>(feat, prob, t, mass, hard, epi, n, h, w, c, sp_h, sp_w, scale, rg, per_sm, stream);
}

bool valid_epilogue(const Epilogue& e, const float* mass, long long tokens) {
  if (e.mode == kNone) return true;
  if (e.counters == nullptr || e.slots == nullptr || e.out == nullptr || tokens * 9 >= (1LL << 31)) return false;
  if (e.mode == kPoolF32 || e.mode == kPoolBf16) return mass != nullptr && e.mass_sum != nullptr;
  return e.mode == kSumF32 || e.mode == kSumBf16;
}

}  // namespace

// feat (n,h,w,c), prob (n,h,w,9), t (n,h/sp_h,w/sp_w,9,c), mass and hard
// (n,h/sp_h,w/sp_w,9) or null; all f32 and contiguous. The epilogue (mode,
// the header's kNone .. kSumBf16 as 0 .. 4): out (n,hc,wc,c), mass_sum and
// sizes (n,hc,wc) or null, counters (n,hc,wc) int32, all zero, and slots
// (n,hc,wc,9) int32 scratch.
extern "C" int disco_pool_stats(const float* feat, const float* prob, float* t, float* mass, float* hard, void* out,
                                void* mass_sum, float* sizes, int* counters, int* slots, int mode, int n, int h, int w,
                                int c, int sp_h, int sp_w, float scale, void* stream) {
  if ((long long)n * (h / sp_h) * (w / sp_w) * c == 0) return 0;
  const Epilogue epi{mode, out, mass_sum, sizes, counters, slots};
  if (!valid_epilogue(epi, mass, (long long)n * (h / sp_h) * (w / sp_w))) return (int)cudaErrorInvalidValue;
  const uintptr_t bits = (uintptr_t)feat;  // the vector loads
  cudaStream_t s = (cudaStream_t)stream;
  if (c % 4 == 0 && bits % 16 == 0) return launch<float, 4>(feat, prob, t, mass, hard, epi, n, h, w, c, sp_h, sp_w, scale, s);
  if (c % 2 == 0 && bits % 8 == 0) return launch<float, 2>(feat, prob, t, mass, hard, epi, n, h, w, c, sp_h, sp_w, scale, s);
  return launch<float, 1>(feat, prob, t, mass, hard, epi, n, h, w, c, sp_h, sp_w, scale, s);
}

// The same with feat (n,h,w,c) bf16; prob, t, mass and hard f32. kp, groups,
// rows, stages, per_sm: ops/superpixel.py::pool_bf16_plan (kp 0: past C = 1024,
// the f32 kernel's loop).
extern "C" int disco_pool_stats_bf16(const void* feat, const float* prob, float* t, float* mass, float* hard,
                                     void* out, void* mass_sum, float* sizes, int* counters, int* slots, int mode,
                                     int n, int h, int w, int c, int sp_h, int sp_w, float scale, int kp, int groups,
                                     int rows, int stages, int per_sm, void* stream) {
  if ((long long)n * (h / sp_h) * (w / sp_w) * c == 0) return 0;
  const Epilogue epi{mode, out, mass_sum, sizes, counters, slots};
  if (!valid_epilogue(epi, mass, (long long)n * (h / sp_h) * (w / sp_w))) return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* f = static_cast<const __nv_bfloat16*>(feat);
  cudaStream_t s = (cudaStream_t)stream;
  if (kp == 0) return launch<__nv_bfloat16, 1>(f, prob, t, mass, hard, epi, n, h, w, c, sp_h, sp_w, scale, s);
  Ring rg;
  rg.kp = kp, rg.groups = groups, rg.rows = rows, rg.stages = stages;
  rg.bx = ((c + 1) / 2 + kp - 1) / kp;
  rg.units = (sp_h + rows - 1) / rows;
  rg.frs = (sp_w * c * 2 + 15) / 16 * 16 + 16;
  rg.prs = (sp_w * 36 + 15) / 16 * 16 + 16;
  rg.stage_bytes = rows * (rg.frs + rg.prs);
  rg.aligned = (sp_w * c * 2) % 16 == 0 && (sp_w * 36) % 16 == 0 && (uintptr_t)feat % 16 == 0 &&
               (uintptr_t)prob % 16 == 0;
  rg.wc_div = FastDiv(w / sp_w), rg.hc_div = FastDiv(h / sp_h), rg.spw_div = FastDiv(sp_w);
  rg.fch_div = FastDiv((sp_w * c * 2) / 16 > 0 ? (sp_w * c * 2) / 16 : 1);
  rg.pch_div = FastDiv((sp_w * 36) / 16 > 0 ? (sp_w * 36) / 16 : 1);
  if ((kp != 1 && kp != 2) || groups < 1 || groups > kMaxGroups || rg.bx * groups > kThreads || rows < 1 ||
      (stages != 2 && stages != 3) || per_sm < 1 || ring_smem(rg, c, sp_w) > kSmemLimit - kStaticSmem)
    return (int)cudaErrorInvalidValue;
  const bool pair = c % 2 == 0 && (uintptr_t)feat % 4 == 0;
  if (kp == 1)
    return pair ? launch_ring_stats<1, true>(f, prob, t, mass, hard, epi, n, h, w, c, sp_h, sp_w, scale, rg, per_sm, s)
                : launch_ring_stats<1, false>(f, prob, t, mass, hard, epi, n, h, w, c, sp_h, sp_w, scale, rg, per_sm, s);
  return pair ? launch_ring_stats<2, true>(f, prob, t, mass, hard, epi, n, h, w, c, sp_h, sp_w, scale, rg, per_sm, s)
              : launch_ring_stats<2, false>(f, prob, t, mass, hard, epi, n, h, w, c, sp_h, sp_w, scale, rg, per_sm, s);
}

// The id of the CUDA graph capture under way on `stream`, 0 where none: the
// wrapper keeps one set of counters a capture (each graph zeroes its own once).
extern "C" unsigned long long disco_capture_id(void* stream) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  if (cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, &id) != cudaSuccess) return 0;
  return status == cudaStreamCaptureStatusActive ? id : 0;
}
