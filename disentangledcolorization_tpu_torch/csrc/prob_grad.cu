// Kernel G: the gradient of soft pooling and unpooling with respect to the affinity map.
//
// No Pallas kernel computes it: the JAX package differentiates its XLA
// formulation (ops/superpixel.py::poolfeat and ::upfeat under jax.vjp). Pixel p
// of cell (i, j) feeds token (i, j) + off_d in direction d in both ops, d = 0..8
// the row-major offsets (-1,-1)..(1,1), so both gradients take one form:
//   dprob[n,p,d] = sum_c x[n,p,c] * T[n,(i,j)+off_d,c] + beta[n,(i,j)+off_d]
// with T and beta zero off the hc x wc token grid. Unpooling: x is the output's
// gradient, T the tokens, beta absent (null). Pooling: x is the features,
// T = g_pooled * s and beta = -s * sum_c g_pooled * pooled (+ g_mass / (sp_h*sp_w)),
// s = 1 / ((mass + 1e-8) * sp_h*sp_w); the wrapper forms T and beta on the token
// grid. f32 throughout; each dot product starts at 0, takes fmaf(x_c, T_c, acc)
// in the order of c, then adds beta (0 where absent): the output's bits do not
// depend on how the work is cut.
//
// Bound: bytes. It reads x once (C floats a pixel) and writes 9 floats a pixel:
// at (128,256,256,4) 134 + 302 MB, 0.130 ms at 3.35 TB/s, against 18*C flops a
// pixel. Design (tile_stream.cuh): a unit of work is a band of cells, one row
// i of cells of one image, or a segment of S cells of it where the band's
// tokens would not fit shared memory (ops/superpixel.py::prob_grad_plan). One
// persistent grid, at most 4 blocks of 256 threads an SM, walks the units; a
// block stages the unit's three token rows (S + 2 cells each, with beta;
// zeros off the grid) once, then streams the unit's pixels in tiles of P:
// a whole band is one contiguous span of sp_h * W pixels, a segment sp_h spans
// of S * sp_w. Tiles pass through a ring of 3 shared stages filled by 16-byte
// cp.async copies, which run on from one unit into the next, so two tiles are
// in flight while one is computed; a unit's tokens travel (4-byte cp.async)
// with its first tile into one of 3 token slots, so no unit waits for them. A thread takes a pixel, reads its features
// and the 9 neighbour token vectors from shared memory (16-byte reads where
// C % 4 == 0 and x is aligned, 8 where C % 2 == 0, else 4) and writes its 9
// results to a shared output tile (stride 9 floats: no bank conflicts); the
// tile's P * 9 floats, contiguous in the output, leave as one bulk copy (TMA
// store, issued by one thread; two output tiles alternate), scalar stores
// only at a tile's unaligned ends. Where not even one cell's tokens fit
// beside the ring (C above about 1900; the port's widths are 4 to 130), the
// plan says seg = 0: units are whole bands and a thread reads its 9
// neighbour tokens and betas from global memory (L1) in place of a slot, the
// same sums in the same order.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_stream.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 3;  // ops/superpixel.py::PROB_GRAD_STAGES

template <int VEC>
__device__ __forceinline__ void load_shared(const float* p, float (&r)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    r[0] = x.x, r[1] = x.y, r[2] = x.z, r[3] = x.w;
  } else if constexpr (VEC == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    r[0] = x.x, r[1] = x.y;
  } else {
    r[0] = *p;
  }
}

struct Shape {
  int hc, wc, C, sp_h, sp_w, W;
  int seg, nseg;  // cells a unit spans (S) and units a band; nseg == 1: the whole band
  int tile_px;    // P
  int stage_bytes, out_floats;
  FastDiv w_div, spw_div;  // by W and by sp_w
};

struct Unit {  // unit u: image n, cell row i, cells [j0, j0 + s) of it
  long long n;
  int i, j0, s;
  int len, tiles_row, tiles;  // pixels a span, tiles a span, tiles in all
  long long base;             // first pixel (flat index over x)
};

__device__ __forceinline__ Unit unit_at(const Shape& g, long long u) {
  Unit r;
  const int seg = (int)(u % g.nseg);
  const long long band = u / g.nseg;
  r.i = (int)(band % g.hc);
  r.n = band / g.hc;
  r.j0 = seg * g.seg;
  r.s = g.wc - r.j0 < g.seg ? g.wc - r.j0 : g.seg;
  const int spans = g.nseg == 1 ? 1 : g.sp_h;
  r.len = g.nseg == 1 ? g.sp_h * g.W : r.s * g.sp_w;
  r.tiles_row = (r.len + g.tile_px - 1) / g.tile_px;
  r.tiles = spans * r.tiles_row;
  r.base = ((r.n * g.hc + r.i) * g.sp_h) * (long long)g.W + (long long)r.j0 * g.sp_w;
  return r;
}

// Tile t of unit r: its first pixel (flat over x) and pixel count, and its
// first pixel's offset within its span.
__device__ __forceinline__ void tile_at(const Shape& g, const Unit& r, int t, long long& first, int& count,
                                        int& offset) {
  const int span = t / r.tiles_row;
  offset = (t - span * r.tiles_row) * g.tile_px;
  count = r.len - offset < g.tile_px ? r.len - offset : g.tile_px;
  first = r.base + (long long)span * g.W + offset;
}

// Issues the copies of unit r's tokens and betas into one slot: rows i-1..i+1,
// cells j0-1..j0+s, zeros off the grid (and for every beta where beta is null).
__device__ __forceinline__ void stage_tokens(const Shape& g, const Unit& r, const float* __restrict__ tok,
                                             const float* __restrict__ beta, float* s_tok, float* s_beta) {
  const int C = g.C, cols = g.seg + 2;
  for (int e = threadIdx.x; e < 3 * cols * C; e += blockDim.x) {
    const int cell = e / C, ch = e - cell * C;
    const int ti = r.i - 1 + cell / cols, tj = r.j0 - 1 + cell % cols;
    const bool inside = ti >= 0 && ti < g.hc && tj >= 0 && tj < g.wc && cell % cols < r.s + 2;
    cp_async4(s_tok + e, inside ? tok + ((r.n * g.hc + ti) * g.wc + tj) * C + ch : tok, inside ? 4 : 0);
  }
  for (int e = threadIdx.x; e < 3 * cols; e += blockDim.x) {
    const int ti = r.i - 1 + e / cols, tj = r.j0 - 1 + e % cols;
    const bool inside = beta != nullptr && ti >= 0 && ti < g.hc && tj >= 0 && tj < g.wc && e % cols < r.s + 2;
    cp_async4(s_beta + e, inside ? beta + (r.n * g.hc + ti) * g.wc + tj : tok, inside ? 4 : 0);
  }
}

// STAGED: the unit's tokens and betas in a shared slot; else read from global.
template <int VEC, bool STAGED>
__global__ void __launch_bounds__(kThreads, 4)
prob_grad_kernel(const float* __restrict__ x, const float* __restrict__ tok, const float* __restrict__ beta,
                 float* __restrict__ out, long long units, long long npix, const Shape g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = g.C, cols = g.seg + 2, slot_floats = 3 * cols * C;
  float* const s_out = reinterpret_cast<float*>(smem + kStages * g.stage_bytes);  // [2][out_floats]
  float* const s_tok = s_out + 2 * g.out_floats;                                  // [kStages][3][seg + 2][C]
  float* const s_beta = s_tok + kStages * slot_floats;                            // [kStages][3][seg + 2]
  const uintptr_t end = reinterpret_cast<uintptr_t>(x + npix * C);

  // The producer's cursor runs kStages - 1 tiles ahead of the consumer's,
  // through the same units. Entering a unit, it also issues the unit's tokens
  // into slot (units entered) % kStages, in the group of the unit's first
  // tile: it is at most kStages - 1 units ahead, so the slot's last unit is done.
  long long pu = blockIdx.x, kp = 0;
  int pt = 0, pslot = 0;
  Unit pr = unit_at(g, pu < units ? pu : 0);
  auto issue = [&]() {  // always commits a group, empty past the last unit
    if (pu < units) {
      if (STAGED && pt == 0) stage_tokens(g, pr, tok, beta, s_tok + pslot * slot_floats, s_beta + pslot * 3 * cols);
      long long first;
      int count, offset;
      tile_at(g, pr, pt, first, count, offset);
      copy_span_async(smem + (kp % kStages) * g.stage_bytes, reinterpret_cast<uintptr_t>(x + first * C),
                      (long long)count * C * 4, end);
      if (++pt == pr.tiles) {
        pt = 0;
        pu += gridDim.x;
        pslot = pslot + 1 == kStages ? 0 : pslot + 1;
        if (pu < units) pr = unit_at(g, pu);
      }
    }
    cp_async_commit();
    ++kp;
  };
  for (int k = 0; k < kStages - 1; ++k) issue();

  long long k = 0;
  int slot = 0;
  for (long long u = blockIdx.x; u < units; u += gridDim.x, slot = slot + 1 == kStages ? 0 : slot + 1) {
    const Unit r = unit_at(g, u);
    const float* const tk = s_tok + slot * slot_floats;
    const float* const bt = s_beta + slot * 3 * cols;
    for (int t = 0; t < r.tiles; ++t, ++k) {
      issue();
      cp_async_wait<kStages - 1>();
      if (threadIdx.x == 0) bulk_wait_read<1>();  // tile k - 2's output tile is read: reusable
      __syncthreads();
      long long first;
      int count, offset;
      tile_at(g, r, t, first, count, offset);
      const int lead = (int)(reinterpret_cast<uintptr_t>(x + first * C) & 15);
      const float* xs = reinterpret_cast<const float*>(smem + (k % kStages) * g.stage_bytes + lead);
      const long long o0 = first * 9;  // the tile's first output float
      const int shift = (int)(o0 & 3);  // floats past a 16-byte boundary: the tile sits as far into s_out
      float* so = s_out + (k & 1) * g.out_floats;
      for (int p = threadIdx.x; p < count; p += blockDim.x) {
        const int rel = offset + p;  // within the span
        const int col = g.nseg == 1 ? rel - g.w_div.div(rel) * g.W : r.j0 * g.sp_w + rel;
        const int jj = g.spw_div.div(col) - r.j0;  // the pixel's cell, from the unit's first
        const float* xp = xs + p * C;
        float acc[9];
#pragma unroll
        for (int d = 0; d < 9; ++d) acc[d] = 0.f;
        if constexpr (!STAGED) {
          const float* tp[9];  // neighbour d's tokens, null off the grid (zeros)
          float bv[9];
#pragma unroll
          for (int d = 0; d < 9; ++d) {
            const int ti = r.i - 1 + d / 3, tj = r.j0 + jj - 1 + d % 3;
            const bool inside = ti >= 0 && ti < g.hc && tj >= 0 && tj < g.wc;
            const long long cell = (r.n * g.hc + ti) * g.wc + tj;
            tp[d] = inside ? tok + cell * C : nullptr;
            bv[d] = inside && beta != nullptr ? __ldg(beta + cell) : 0.f;
          }
          for (int c = 0; c < C; ++c) {
            const float v = xp[c];
#pragma unroll
            for (int d = 0; d < 9; ++d) acc[d] = fmaf(v, tp[d] != nullptr ? __ldg(tp[d] + c) : 0.f, acc[d]);
          }
#pragma unroll
          for (int d = 0; d < 9; ++d) so[shift + p * 9 + d] = acc[d] + bv[d];
          continue;
        }
        for (int c = 0; c < C; c += VEC) {
          float v[VEC];
          load_shared<VEC>(xp + c, v);
#pragma unroll
          for (int d = 0; d < 9; ++d) {
            float tv[VEC];
            load_shared<VEC>(tk + ((d / 3) * cols + jj + d % 3) * C + c, tv);
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[d] = fmaf(v[e], tv[e], acc[d]);
          }
        }
#pragma unroll
        for (int d = 0; d < 9; ++d) so[shift + p * 9 + d] = acc[d] + bt[(d / 3) * cols + jj + d % 3];
      }
      fence_async_shared();
      __syncthreads();
      // output floats [o0, o0 + 9 * count) from so[shift ...], in the 16-byte groups of the output's address
      // space: the whole groups as one bulk copy, the ends' floats one by one
      const int total = shift + 9 * count, whole_lo = (shift + 3) & ~3, whole_hi = total & ~3;
      float* const dst = out + (o0 - shift);  // 16-byte aligned
      if (threadIdx.x == 0 && whole_hi > whole_lo) bulk_store(dst + whole_lo, so + whole_lo, 4 * (whole_hi - whole_lo));
      for (int e = shift + threadIdx.x; e < total; e += blockDim.x)
        if (e < whole_lo || e >= whole_hi) __stcs(dst + e, so[e]);
    }
  }
  cp_async_wait<0>();
  if (threadIdx.x == 0) bulk_wait_all();
}

template <int VEC, bool STAGED>
int launch(const float* x, const float* tok, const float* beta, float* out, long long units, long long npix,
           const Shape& g, int per_sm, size_t smem, cudaStream_t stream) {
  int dev = 0;
  cudaGetDevice(&dev);
  static bool smem_set[64] = {};
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {  // once a device: up to the whole of a block's shared memory
    const cudaError_t err =
        cudaFuncSetAttribute(prob_grad_kernel<VEC, STAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  const int grid = balanced_grid(units, per_sm, dev);
  prob_grad_kernel<VEC, STAGED><<<grid, kThreads, smem, stream>>>(x, tok, beta, out, units, npix, g);
  return (int)cudaGetLastError();
}

}  // namespace

// x (n,hc*sp_h,wc*sp_w,c), tok (n,hc,wc,c), beta (n,hc,wc) or null,
// out (n,hc*sp_h,wc*sp_w,9), 16-byte aligned; all f32 and contiguous.
// seg, tile_px and per_sm: the plan of ops/superpixel.py::prob_grad_plan, whose
// shared memory the wrapper holds within 227 KB; seg 0: tokens read from
// global memory, whole bands.
extern "C" int disco_prob_grad(const float* x, const float* tok, const float* beta, float* out, int n, int hc,
                               int wc, int c, int sp_h, int sp_w, int seg, int tile_px, int per_sm, void* stream) {
  if ((long long)n * hc * wc * sp_h * sp_w == 0) return 0;
  const long long band_px = (long long)sp_h * wc * sp_w;
  if (c < 1 || seg < 0 || tile_px < 1 || per_sm < 1 || band_px >= (1LL << 31) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Shape g;
  g.hc = hc, g.wc = wc, g.C = c, g.sp_h = sp_h, g.sp_w = sp_w, g.W = wc * sp_w;
  const bool staged = seg > 0;
  g.seg = staged && seg < wc ? seg : wc;
  g.nseg = (wc + g.seg - 1) / g.seg;
  g.tile_px = tile_px;
  g.stage_bytes = (int)(((long long)tile_px * c * 4 + 15) / 16 * 16 + 16);
  g.out_floats = (tile_px * 9 + 4 + 3) / 4 * 4;
  g.w_div = FastDiv(g.W);
  g.spw_div = FastDiv(sp_w);
  const long long slots = staged ? (long long)kStages * 3 * (g.seg + 2) * (c + 1) : 0;
  const long long smem = (long long)kStages * g.stage_bytes + 4LL * (2 * g.out_floats + slots);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const long long units = (long long)n * hc * g.nseg, npix = (long long)n * hc * band_px;
  const uintptr_t bits = (uintptr_t)x;  // the shared reads' width: every tile starts at x's alignment
  cudaStream_t s = (cudaStream_t)stream;
  if (!staged) return launch<1, false>(x, tok, beta, out, units, npix, g, per_sm, (size_t)smem, s);
  if (c % 4 == 0 && bits % 16 == 0) return launch<4, true>(x, tok, beta, out, units, npix, g, per_sm, (size_t)smem, s);
  if (c % 2 == 0 && bits % 8 == 0) return launch<2, true>(x, tok, beta, out, units, npix, g, per_sm, (size_t)smem, s);
  return launch<1, true>(x, tok, beta, out, units, npix, g, per_sm, (size_t)smem, s);
}
