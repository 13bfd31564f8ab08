// Hopper (sm_90a) kernels for the sparse (ELL) KL statistics of the
// consensus-NMF solvers. They replace the Pallas TPU kernels of
// cnmf_torch_tpu/ops/pallas_kl.py:
//
//   h_stats            <- pallas_kl_h_stats   (_h_stats_body)
//   w_numer            <- pallas_kl_w_numer, both passes (_ratio_body,
//                         _w_numer_body)
//   beta_err_partials  <- pallas_kl_beta_err  (_obj_body)
//   h_newton_stats     <- pallas_kl_h_newton_stats (_h_newton_body)
//   wh_at_nz           <- pallas_wh_at_nz     (_wh_body)
//
// The first three serve every MU solve; the last two serve the
// Diagonalized-Newton (dna) recipe of the batch solver.
//
// Layout: the ELL buffers (vals, cols: n x w; rows_t, perm_t: g x wt) are
// shared by every replicate; H (R, n, k), W (R, k, g) and every output
// carry the replicate axis (the (R*n)-row sequence that the row kernels'
// warps walk, or w_numer's (replicate, gene) sequence). Padded slots hold
// value 0 at column 0 (row side, after the row's stored values) or the
// sentinel n*w in perm_t (transpose side, after the gene's stored slots),
// so they add exactly +0.0 or are skipped. Every sum is reduced in a fixed
// order with shuffles, no atomics, so repeated runs are bit-identical (see
// ops/kernels/kl_ell.py for the bound of each kernel).
//
// In bf16 mode (h_stats, w_numer) the kernels round where the JAX bf16
// chain rounds: operands to bf16, WH accumulated in bf16, the ratio in
// bf16, every ratio*W (or ratio*H) product rounded to bf16 and then summed
// in f32.
//
// h_stats is bound by operations (about 4k+1 a nonzero and replicate).
// What keeps it from that bound is gathering W (k random values a slot),
// the padded slots (29% at the main path's shapes) and occupancy; a (k, g)
// table read with scalar loads would gather W twice a slot. Its design:
//   * W[r] is staged as a packed per-gene table, bf16 in bf16 mode (the
//     chain casts W anyway): a lane gathers its slot's k components with
//     ceil(k/8) (bf16) or ceil(k/4) (f32) 16-byte shared loads, once, and
//     keeps them in registers for the WH chain and the k products; the
//     chunks of a gene are XOR-swizzled so random genes spread over banks;
//     staging reads W along genes (coalesced) and writes whole chunks;
//   * bf16 arithmetic runs on bf16x2 pairs: h*w and ratio*w products and
//     the WH sum have one bf16 rounding each, as the f32-then-round chain
//     does, so results equal the plain version's bit for bit per product;
//   * a warp stops at a row's first window of 32 padded slots (padding
//     sits at the row's tail) and skips padded slots in the last window;
//   * per-component sums fold across the warp in 5 fixed-order steps that
//     halve the values each lane holds (16 shuffles at k <= 16, not 5k);
//   * the grid is one wave of resident blocks from the occupancy
//     calculator at the table's size; blocks walk contiguous runs of the
//     (R*n)-row sequence and restage the table when the replicate changes;
//     the f32 k <= 16 table (128 KB at g=2000) leaves one block an SM, so
//     that instance runs 16 warps a block;
//   * a table larger than a block's shared memory is not staged: each lane
//     reads its slot's column from W in device memory, still once a slot.
//
// w_numer is h_stats with H and W swapped, walked from the gene side: at
// each stored slot WH, the ratio and k products ratio*H, about 4k+1
// operations a nonzero and replicate. The TPU split it in two passes
// through a flat ratio buffer (every row's ratio had to exist before a gene
// reduced it); computing WH at the slot from the row's H and the gene's W
// column needs no such barrier, so no ratio buffer exists. With all
// operands in L2, what bounds it is the sectors its gathers touch. Design:
//   * one warp per (replicate, gene), replicate-major, W[r, :, gene] in
//     registers (bf16 pairs in bf16 mode); lanes stride over the gene's
//     slots, reading rows_t and perm_t coalesced;
//   * a prep kernel of the same entry point packs H into whole 16-byte
//     chunks a row (bf16 in bf16 mode, k padded to 8 or 4), so a slot
//     gathers its row's H once, in ceil(k/8) or ceil(k/4) 16-byte loads
//     (one or two 32-byte sectors at k <= 16), for the WH chain and the
//     products; and gathers the stored values into the gene-side layout
//     once for all replicates (one random sector a slot and replicate
//     fewer: 0.20 -> 0.13 ms a chunk, 0.60 -> 0.43 ms on the whole matrix,
//     H100);
//   * h_stats' bf16x2 arithmetic, padded-window stop and warp fold;
//   * blocks of two warps: a long gene (1,136 slots against a mean of 326
//     a chunk) holds one other warp's registers, not seven (1 to 8 warps a
//     block measured within 13% of each other).
//
// wh_at_nz writes WH at every slot of the row side, (R, n, w) f32: the
// bytes of that output bound it (147 MB a call at the batch path's
// shapes). What kept it from that bound was the W gather (k scalar shared
// loads a slot from a (k, g) table, banks colliding across the lanes' random
// genes), a grid of a few blocks a replicate that each restaged the table,
// and the padded slots, gathered like stored ones. Its design is h_stats'
// skeleton:
//   * the packed f32 per-gene table and the persistent grid (walk_rows):
//     a slot gathers its gene's k components once, in ceil(k/4) 16-byte
//     shared loads (or reads the column from device memory where the table
//     does not fit), and runs the WH chain from registers;
//   * every slot whose column is 0 has one value, H[r, i, :] . W[r, :, 0]:
//     the padded slots (value 0 at column 0, 29% of the slots at the batch
//     path's shapes) and gene 0 where it is stored. A warp computes it once
//     a row with the same chain as a gathered slot (one product, then
//     fused multiply-adds in component order, fixed rounding: the same
//     bits) and stores it at those slots without touching the table;
//   * a lane takes four consecutive slots at a time where the row pitch
//     allows (w a multiple of 4, 16-byte aligned buffers): one 16-byte load
//     of their columns (the next four in flight meanwhile), two pairs of
//     independent chains, one 16-byte streaming store; consecutive lanes
//     write consecutive slots;
//   * 32 warps a block at k <= 16, the table's placement (shared or device
//     memory) a template argument, so no gather waits behind a branch.
//
// h_newton_stats is h_stats in strict f32 with a second sum a component:
// at each stored slot WH, ratio = X / max(WH, EPS), r2 = ratio / max(WH,
// EPS), then ratio * W and (r2 * W) * W, about 7k+3 operations a nonzero
// and replicate (bound by operations). What kept it from that bound is
// what kept h_stats from its own: a (k, g) table read with k scalar shared
// loads a slot, twice (once for WH, once for the sums), banks colliding
// across the lanes' random genes; every padded slot gathered; a grid of a
// few blocks a replicate that each restaged the table; 2k warp sums a
// row. Its design:
//   * h_stats' skeleton: the packed f32 per-gene table staged by walk_rows
//     on one wave of persistent blocks (16 warps a block at k <= 16: the
//     128 KB table of k=13, g=2000 leaves one block an SM), or the column
//     read from device memory where the table does not fit; the placement
//     a template argument, as in wh_at_nz;
//   * a stored slot gathers its column once, in ceil(k/4) 16-byte loads,
//     and keeps it in registers for the WH chain and both sums (at KMAX=64
//     h and the two sums hold 192 registers, so that instance gathers each
//     chunk a second time for the sums);
//   * a warp stops at its row's first window of 32 padded slots and skips
//     padded slots in the last window: all-zero rows stay +0.0;
//   * the numerator's and the Hessian's sums fold across the warp as one
//     array of 2*KMAX values in 5 fixed-order steps (31 shuffles at k <=
//     16, not 10k), so repeated launches are bit-identical.
//
// beta_err_partials writes the nonzero part of each row's KL term, (R, n)
// f32: at each stored slot WH, the two-regime term (a division and a
// log1p, or two logs where WH/X < 1e-6) minus WH, about 2k+8 operations a
// nonzero and replicate (bound by operations; the log1p counted as one).
// What kept it from that bound is what kept h_stats from its own: a (k, g)
// table read with k scalar shared loads a slot, every padded slot visited,
// a grid of a few blocks a replicate that each restaged the table, and a
// block reduction that tied the output to the grid. Its design:
//   * h_stats' skeleton: the packed f32 per-gene table staged by walk_rows
//     on one wave of persistent blocks, or the column read from device
//     memory where the table does not fit, the placement a template
//     argument, as in wh_at_nz;
//   * a stored slot gathers its column once, in ceil(k/4) 16-byte loads,
//     and consumes each chunk in the WH chain as it arrives: nothing needs
//     the column after WH, so KMAX=64 holds only h in registers;
//   * a warp stops at its row's first window of 32 padded slots and skips
//     padded slots in the last window; a negative stored value adds
//     nothing, as under the JAX body's where(vals > 0, ...);
//   * a slot's WH and term are rounded as the plain version rounds them
//     (no fused multiply-add), and each lane adds its slots' terms in f64,
//     the warp sums them in 5 fixed-order steps and lane 0 stores the
//     row's value, rounded to f32 once: one value a row, whatever the grid
//     (a block that spans two replicates needs no special case, an
//     all-zero row is exactly +0.0), that matches the plain version's f64
//     row sum also where the row's terms cancel.
//
// Strict IEEE f32 arithmetic (no fast math): where WH underflows, the
// Newton Hessian may overflow to +inf, and the kernel and its plain
// version must then agree (grad / inf = 0 keeps the Newton candidate at H).
// Every term is >= 0, so the fold makes no NaN of it. The KL term's
// division, logf and log1pf are the IEEE ones too, in both regimes.
//
// Plain C interface for ctypes; every entry point returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr float KL_EPS = 1e-16f;
// threads a block of w_numer_prep_kernel
constexpr int PREP_THREADS = 256;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float load_val(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_val(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_val(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// lane 0 gets the warp's sum, in a fixed order
__device__ __forceinline__ double warp_sum(double s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
  }
  return s;
}

// ---------------------------------------------------------------------------
// h_stats: numer[r, i, c] = sum_j ratio[i, j] * W[r, c, cols[i, j]]
//
// The packed table: gene `col` owns nq 16-byte chunks holding its k
// components (bf16 pairs, 8 a chunk, in bf16 mode; f32, 4 a chunk), the
// tail of the last chunk zero; chunk q sits at position q ^ (col & sw)
// (sw = nq - 1 when nq is a power of two, else 0).
// ---------------------------------------------------------------------------

// k components packed as whole 16-byte chunks (the h_stats W table, the
// w_numer H rows): 32-bit words per vector (bf16 pairs or f32) and chunks
template <bool BF16, int KMAX>
struct Packed {
  static constexpr int NW = BF16 ? KMAX / 2 : KMAX;
  static constexpr int NQ = NW / 4;        // 16-byte chunks at most
};

// the chunks k fills: 8 bf16 or 4 f32 components a chunk
__host__ __device__ __forceinline__ int packed_chunks(int k, bool bf16) {
  return bf16 ? (k + 7) / 8 : (k + 3) / 4;
}

template <bool BF16, int KMAX>
struct HStatsShape : Packed<BF16, KMAX> {
  // the f32 k <= 16 table fills most of an SM's shared memory, so one
  // block of 16 warps holds it; the others run 8 warps a block and more
  // blocks an SM
  static constexpr int THREADS = (!BF16 && KMAX <= 16) ? 512 : 256;
  static constexpr int WARPS = THREADS / 32;
};

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  unsigned u;
  memcpy(&u, &p, 4);
  return u;
}

__device__ __forceinline__ __nv_bfloat162 as_bf16x2(unsigned u) {
  __nv_bfloat162 p;
  memcpy(&p, &u, 4);
  return p;
}

// word i of a column: components 2i, 2i+1 (bf16) or component i (f32)
template <bool BF16, int KMAX>
__device__ __forceinline__ unsigned column_word(const float* Wr, int k, int g,
                                                int col, int i) {
  if (BF16) {
    const float lo = (2 * i < k) ? __ldg(Wr + (int64_t)(2 * i) * g + col) : 0.f;
    const float hi =
        (2 * i + 1 < k) ? __ldg(Wr + (int64_t)(2 * i + 1) * g + col) : 0.f;
    return pack_bf16x2(lo, hi);
  }
  return __float_as_uint((i < k) ? __ldg(Wr + (int64_t)i * g + col) : 0.f);
}

// Stage W[r] (k x g, f32) as the packed table: each thread packs whole
// genes, reading W along genes (coalesced across the warp) and writing
// 16-byte chunks.
template <bool BF16, int KMAX>
__device__ __forceinline__ void stage_packed(uint4* tbl, const float* Wr,
                                             int k, int g, int nq, int sw) {
  using S = HStatsShape<BF16, KMAX>;
  for (int gene = threadIdx.x; gene < g; gene += blockDim.x) {
    unsigned wv[S::NW];
#pragma unroll
    for (int i = 0; i < S::NW; ++i)
      wv[i] = column_word<BF16, KMAX>(Wr, k, g, gene, i);
#pragma unroll
    for (int q = 0; q < S::NQ; ++q) {
      if (q < nq) {
        tbl[(int64_t)gene * nq + (q ^ (gene & sw))] =
            make_uint4(wv[4 * q], wv[4 * q + 1], wv[4 * q + 2], wv[4 * q + 3]);
      }
    }
  }
}

// Sum N per-lane values over the warp in a fixed order with N/2 + N/4 + ...
// shuffles instead of 5N: at each offset a lane keeps one half of its
// values and sends its partner the other half. store_folded says which
// lane then holds which component's warp total.
template <int N, int M, int OFF>
__device__ __forceinline__ void warp_fold(float (&a)[N], int lane) {
  if constexpr (OFF > 0) {
    if constexpr (M == 1) {
      a[0] += __shfl_xor_sync(0xffffffffu, a[0], OFF);
      warp_fold<N, 1, OFF / 2>(a, lane);
    } else {
      constexpr int HALF = M / 2;
      const bool up = (lane & OFF) != 0;
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        const float send = up ? a[i] : a[i + HALF];
        const float keep = up ? a[i + HALF] : a[i];
        a[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      warp_fold<N, HALF, OFF / 2>(a, lane);
    }
  }
}

// After warp_fold<KMAX, KMAX, 16>: for KMAX <= 32, lane l holds component
// l / (32 / KMAX) in a[0] (lanes of one group hold the same total); for
// KMAX = 64, lane l holds components 2l and 2l + 1 in a[0] and a[1].
// Component c goes to out[c * stride].
template <int KMAX>
__device__ __forceinline__ void store_folded(const float (&a)[KMAX],
                                             int lane, float* out, int k,
                                             int64_t stride = 1) {
  if constexpr (KMAX >= 32) {
    constexpr int PER = KMAX / 32;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = lane * PER + i;
      if (c < k) out[c * stride] = a[i];
    }
  } else {
    constexpr int GROUP = 32 / KMAX;
    const int c = lane / GROUP;
    if (lane % GROUP == 0 && c < k) out[c * stride] = a[0];
  }
}

// slot(col, v) at each stored slot of a row, the lanes striding over its w
// slots. A row's stored values sit first and its padding (value 0) after
// them, so a window of 32 slots that is all padding ends the row; a padded
// slot in the last window would add exactly +0.0 and is skipped.
template <typename VT, typename SlotFn>
__device__ __forceinline__ void row_slots(const VT* __restrict__ vals_row,
                                          const int* __restrict__ cols_row,
                                          int w, int lane, SlotFn slot) {
  int j = lane;
  int col = 0;
  float v = 0.f;
  if (j < w) {
    col = __ldg(cols_row + j);
    v = load_val(vals_row + j);
  }
  while (__any_sync(0xffffffffu, v != 0.f)) {
    const int jn = j + 32;
    int col_n = 0;
    float v_n = 0.f;
    if (jn < w) {   // the next window's coordinate, in flight meanwhile
      col_n = __ldg(cols_row + jn);
      v_n = load_val(vals_row + jn);
    }
    if (v != 0.f) slot(col, v);
    j = jn;
    col = col_n;
    v = v_n;
  }
}

template <typename VT, bool BF16, int KMAX>
__device__ __forceinline__ void h_stats_row(
    const VT* __restrict__ vals, const int* __restrict__ cols,
    const float* __restrict__ Hrow, const float* __restrict__ Wr,
    const uint4* tbl, float* __restrict__ out, int64_t base, int w, int k,
    int g, int nq, int sw, bool use_smem, int lane) {
  using S = HStatsShape<BF16, KMAX>;
  // the row's H in registers: bf16 pairs or f32
  unsigned hv[S::NW];
#pragma unroll
  for (int i = 0; i < S::NW; ++i) {
    if (BF16) {
      const float lo = (2 * i < k) ? __ldg(Hrow + 2 * i) : 0.f;
      const float hi = (2 * i + 1 < k) ? __ldg(Hrow + 2 * i + 1) : 0.f;
      hv[i] = pack_bf16x2(lo, hi);
    } else {
      hv[i] = __float_as_uint((i < k) ? __ldg(Hrow + i) : 0.f);
    }
  }
  float acc[KMAX];
#pragma unroll
  for (int c = 0; c < KMAX; ++c) acc[c] = 0.f;

  row_slots(vals + base, cols + base, w, lane, [&](int col, float v) {
    unsigned wv[S::NW];
    if (use_smem) {
#pragma unroll
      for (int q = 0; q < S::NQ; ++q) {
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (q < nq) u = tbl[(int64_t)col * nq + (q ^ (col & sw))];
        wv[4 * q] = u.x;
        wv[4 * q + 1] = u.y;
        wv[4 * q + 2] = u.z;
        wv[4 * q + 3] = u.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < S::NW; ++i)
        wv[i] = column_word<BF16, KMAX>(Wr, k, g, col, i);
    }
    // components past k hold 0 in both H and W: their products are +0.0
    // and leave the WH chain unchanged. The loops run to KMAX: stopping
    // them at the last chunk k fills cost registers (a spill at
    // KMAX=16) and time at every k on the H100
    if (BF16) {
      // the JAX chain: each h*w rounded to bf16, the sum rounded to
      // bf16 after every component (one bf16 rounding each, as here)
      __nv_bfloat162 p = __hmul2(as_bf16x2(hv[0]), as_bf16x2(wv[0]));
      __nv_bfloat16 wh = __hadd(__low2bfloat16(p), __high2bfloat16(p));
#pragma unroll
      for (int i = 1; i < S::NW; ++i) {
        p = __hmul2(as_bf16x2(hv[i]), as_bf16x2(wv[i]));
        wh = __hadd(__hadd(wh, __low2bfloat16(p)), __high2bfloat16(p));
      }
      const float den = fmaxf(__bfloat162float(wh), round_bf16(KL_EPS));
      const __nv_bfloat162 r2 =
          __bfloat162bfloat162(__float2bfloat16_rn(round_bf16(v) / den));
#pragma unroll
      for (int i = 0; i < S::NW; ++i) {
        const __nv_bfloat162 p = __hmul2(r2, as_bf16x2(wv[i]));
        acc[2 * i] += __low2float(p);
        acc[2 * i + 1] += __high2float(p);
      }
    } else {
      float wh = 0.f;
#pragma unroll
      for (int c = 0; c < KMAX; ++c) {
        const float hw = __uint_as_float(hv[c]) * __uint_as_float(wv[c]);
        wh = (c == 0) ? hw : wh + hw;
      }
      const float ratio = v / fmaxf(wh, KL_EPS);
#pragma unroll
      for (int c = 0; c < KMAX; ++c) acc[c] += ratio * __uint_as_float(wv[c]);
    }
  });
  warp_fold<KMAX, KMAX, 16>(acc, lane);
  store_folded<KMAX>(acc, lane, out, k);
}

// Blocks are persistent: block b walks the rows [b*per, (b+1)*per) of the
// (R*n)-row sequence, restaging the packed W table when the replicate
// changes (at most twice when per <= n), its warps taking the rows in turn.
// row_fn(gi, row, Wr): gi indexes the (R*n)-row sequence, row the
// replicate's rows, Wr its W.
template <bool BF16, int KMAX, int WARPS, typename RowFn>
__device__ __forceinline__ void walk_rows(const float* __restrict__ W,
                                          uint4* tbl, int R, int n, int k,
                                          int g, int nq, int sw,
                                          bool use_smem, RowFn row_fn) {
  const int warp = threadIdx.x >> 5;
  const int64_t total = (int64_t)R * n;
  const int64_t per = (total + gridDim.x - 1) / gridDim.x;
  int64_t lo = (int64_t)blockIdx.x * per;
  const int64_t hi = lo + per < total ? lo + per : total;
  while (lo < hi) {
    const int r = (int)(lo / n);
    const int64_t rend = (int64_t)(r + 1) * n < hi ? (int64_t)(r + 1) * n : hi;
    const float* Wr = W + (int64_t)r * k * g;
    if (use_smem) {
      __syncthreads();   // the previous replicate's rows are done
      stage_packed<BF16, KMAX>(tbl, Wr, k, g, nq, sw);
      __syncthreads();
    }
    for (int64_t gi = lo + warp; gi < rend; gi += WARPS)
      row_fn(gi, gi - (int64_t)r * n, Wr);
    lo = rend;
  }
}

template <typename VT, bool BF16, int KMAX>
__global__ void __launch_bounds__(HStatsShape<BF16, KMAX>::THREADS)
h_stats_kernel(const VT* __restrict__ vals, const int* __restrict__ cols,
               const float* __restrict__ H, const float* __restrict__ W,
               float* __restrict__ numer, int R, int n, int w, int k, int g,
               int nq, int use_smem) {
  extern __shared__ uint4 Wt[];
  const int sw = (nq & (nq - 1)) ? 0 : nq - 1;
  const int lane = threadIdx.x & 31;
  walk_rows<BF16, KMAX, HStatsShape<BF16, KMAX>::WARPS>(
      W, Wt, R, n, k, g, nq, sw, use_smem != 0,
      [&](int64_t gi, int64_t row, const float* Wr) {
        h_stats_row<VT, BF16, KMAX>(vals, cols, H + gi * k, Wr, Wt,
                                    numer + gi * k, row * w, w, k, g, nq, sw,
                                    use_smem != 0, lane);
      });
}

// ---------------------------------------------------------------------------
// w_numer: numer[r, c, gene] = sum over the gene's stored slots (i, gene) of
// ratio(r, i, gene) * H[r, i, c], ratio = X[i, gene] / max(WH, EPS), in one
// gene-side traversal: no ratio buffer.
//
// w_numer_prep_kernel, launched first from the same entry point, writes
// two scratch arrays the traversal reads instead of scattered data:
//   Hp: row `row` of the (R*n)-row sequence of H as nq 16-byte chunks,
//       components 8q..8q+7 as bf16 pairs (bf16 mode: the chain casts H
//       anyway) or 4q..4q+3 as f32, the tail of the last chunk zero;
//   Xt: the value of each stored slot in the gene-side layout of perm_t
//       (g x wt, bf16 in bf16 mode), gathered once for all replicates, so
//       the traversal reads it along with rows_t and perm_t. Padded slots
//       are not written and never read.
// ---------------------------------------------------------------------------

// warps a block of w_numer_kernel, one (replicate, gene) each
constexpr int W_NUMER_WARPS = 2;

template <typename VT, typename XT, bool BF16>
__global__ void __launch_bounds__(PREP_THREADS)
w_numer_prep_kernel(const VT* __restrict__ vals,
                    const int* __restrict__ perm_t,
                    const float* __restrict__ H, uint4* __restrict__ Hp,
                    XT* __restrict__ Xt, int64_t rows, int k, int nq,
                    int64_t slots, int sentinel) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t i = first; i < rows * nq; i += stride) {
    const int64_t row = i / nq;
    const int q = (int)(i - row * nq);
    const float* h = H + row * k;
    unsigned u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (BF16) {
        const int c = 8 * q + 2 * j;
        u[j] = pack_bf16x2(c < k ? __ldg(h + c) : 0.f,
                           c + 1 < k ? __ldg(h + c + 1) : 0.f);
      } else {
        const int c = 4 * q + j;
        u[j] = __float_as_uint(c < k ? __ldg(h + c) : 0.f);
      }
    }
    Hp[i] = make_uint4(u[0], u[1], u[2], u[3]);
  }
  for (int64_t i = first; i < slots; i += stride) {
    const int p = __ldg(perm_t + i);
    if (p < sentinel) store_val(Xt + i, load_val(vals + p));
  }
}

// One warp per (replicate, gene), replicate-major (the warps in flight share
// a replicate's H); W[r, :, gene] in registers; lanes stride over the gene's
// slots.
template <typename XT, bool BF16, int KMAX>
__global__ void __launch_bounds__(W_NUMER_WARPS * 32)
w_numer_kernel(const XT* __restrict__ Xt, const int* __restrict__ rows_t,
               const int* __restrict__ perm_t, const uint4* __restrict__ Hp,
               const float* __restrict__ W, float* __restrict__ numer,
               int n, int k, int g, int wt, int nq, int sentinel,
               int64_t items) {
  using P = Packed<BF16, KMAX>;
  const int lane = threadIdx.x & 31;
  const int64_t item =
      (int64_t)blockIdx.x * W_NUMER_WARPS + (threadIdx.x >> 5);
  if (item >= items) return;     // the whole warp
  const int r = (int)(item / g);
  const int gene = (int)(item - (int64_t)r * g);
  const float* Wr = W + (int64_t)r * k * g;
  unsigned wv[P::NW];
#pragma unroll
  for (int i = 0; i < P::NW; ++i)
    wv[i] = column_word<BF16, KMAX>(Wr, k, g, gene, i);
  const uint4* Hr = Hp + (int64_t)r * n * nq;
  float acc[KMAX];
#pragma unroll
  for (int c = 0; c < KMAX; ++c) acc[c] = 0.f;

  const int64_t base = (int64_t)gene * wt;
  int t = lane;
  int row = 0;
  int p = sentinel;              // perm_t of a padded slot
  if (t < wt) {
    row = __ldg(rows_t + base + t);
    p = __ldg(perm_t + base + t);
  }
  // A gene's stored slots sit first and its padding (the sentinel) after
  // them, so a window of 32 padded slots ends the gene; a padded slot in
  // the last window would add exactly +0.0 and is skipped.
  while (__any_sync(0xffffffffu, p < sentinel)) {
    const int tn = t + 32;
    int row_n = 0;
    int p_n = sentinel;
    if (tn < wt) {   // the next window's slot, in flight meanwhile
      row_n = __ldg(rows_t + base + tn);
      p_n = __ldg(perm_t + base + tn);
    }
    if (p < sentinel) {
      const float v = load_val(Xt + base + t);
      // the slot's H row, once, for the WH chain and the k products
      unsigned hv[P::NW];
      const uint4* hrow = Hr + (int64_t)row * nq;
#pragma unroll
      for (int q = 0; q < P::NQ; ++q) {
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (q < nq) u = __ldg(hrow + q);
        hv[4 * q] = u.x;
        hv[4 * q + 1] = u.y;
        hv[4 * q + 2] = u.z;
        hv[4 * q + 3] = u.w;
      }
      // components past k hold 0 in both H and W: +0.0 products that leave
      // the WH chain unchanged (h_stats' loops, with H and W swapped)
      if (BF16) {
        // the JAX chain: each h*w rounded to bf16, the sum rounded to bf16
        // after every component, the ratio bf16 (v is bf16 already), each
        // ratio*h rounded to bf16 and summed in f32
        __nv_bfloat162 pr = __hmul2(as_bf16x2(hv[0]), as_bf16x2(wv[0]));
        __nv_bfloat16 wh = __hadd(__low2bfloat16(pr), __high2bfloat16(pr));
#pragma unroll
        for (int i = 1; i < P::NW; ++i) {
          pr = __hmul2(as_bf16x2(hv[i]), as_bf16x2(wv[i]));
          wh = __hadd(__hadd(wh, __low2bfloat16(pr)), __high2bfloat16(pr));
        }
        const float den = fmaxf(__bfloat162float(wh), round_bf16(KL_EPS));
        const __nv_bfloat162 r2 =
            __bfloat162bfloat162(__float2bfloat16_rn(v / den));
#pragma unroll
        for (int i = 0; i < P::NW; ++i) {
          pr = __hmul2(r2, as_bf16x2(hv[i]));
          acc[2 * i] += __low2float(pr);
          acc[2 * i + 1] += __high2float(pr);
        }
      } else {
        float wh = 0.f;
#pragma unroll
        for (int c = 0; c < KMAX; ++c) {
          const float hw = __uint_as_float(hv[c]) * __uint_as_float(wv[c]);
          wh = (c == 0) ? hw : wh + hw;
        }
        const float ratio = v / fmaxf(wh, KL_EPS);
#pragma unroll
        for (int c = 0; c < KMAX; ++c)
          acc[c] += ratio * __uint_as_float(hv[c]);
      }
    }
    t = tn;
    row = row_n;
    p = p_n;
  }
  warp_fold<KMAX, KMAX, 16>(acc, lane);
  store_folded<KMAX>(acc, lane, numer + (int64_t)r * k * g + gene, k, g);
}

// ---------------------------------------------------------------------------
// wh_at_nz: out[r, i, j] = sum_c H[r, i, c] * W[r, c, cols[i, j]] at every
// slot of the row side (the SDDMM), padded slots included: the DNA row
// objective multiplies every slot by its value (0 where padded), so an
// unwritten slot would poison it with 0 * NaN.
// ---------------------------------------------------------------------------

// wh_at_nz's block: 32 warps at k <= 16 (the f32 table of k=13, g=2000
// leaves one block an SM, and the gathers need the warps in flight: 16 warps
// ran 4-12% slower at k = 5, 9 and 13 on the H100), else 8
template <int KMAX>
struct WhShape {
  static constexpr int THREADS = KMAX <= 16 ? 1024 : 256;
  static constexpr int WARPS = THREADS / 32;
};

// Chunk q (components 4q..4q+3) of gene `col`'s W column: from the packed
// table (SMEM), or read from W[r] in device memory where it does not fit.
template <bool SMEM>
__device__ __forceinline__ float4 w_chunk(const uint4* tbl,
                                          const float* __restrict__ Wr,
                                          int k, int g, int nq, int sw,
                                          int col, int q) {
  if (SMEM) {
    const uint4 u = tbl[(int64_t)col * nq + (q ^ (col & sw))];
    return make_float4(__uint_as_float(u.x), __uint_as_float(u.y),
                       __uint_as_float(u.z), __uint_as_float(u.w));
  }
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = 4 * q + i;
    v[i] = c < k ? __ldg(Wr + (int64_t)c * g + col) : 0.f;
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

// WH at N slots at once, N independent chains: h . W[:, col[s]] as one
// product and then fused multiply-adds in component order (explicit
// roundings, so a gene gets the same bits at every slot and call site).
// Components past k are 0 in h and in the table and leave a chain as it
// is. With skip0, a slot whose column is 0 reads nothing (its chain gives
// 0): the caller stores the row's column-0 value there instead.
template <int KMAX, int N, bool SMEM>
__device__ __forceinline__ void slots_wh(const float (&h)[KMAX],
                                         const uint4* tbl,
                                         const float* __restrict__ Wr,
                                         int k, int g, int nq, int sw,
                                         const int (&col)[N], bool skip0,
                                         float (&wh)[N]) {
#pragma unroll
  for (int q = 0; q < KMAX / 4; ++q) {
    if (q < nq) {
#pragma unroll
      for (int s = 0; s < N; ++s) {
        float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
        if (!skip0 || col[s] != 0)
          u = w_chunk<SMEM>(tbl, Wr, k, g, nq, sw, col[s], q);
        wh[s] = (q == 0) ? __fmul_rn(h[0], u.x)
                         : __fmaf_rn(h[4 * q], u.x, wh[s]);
        wh[s] = __fmaf_rn(h[4 * q + 1], u.y, wh[s]);
        wh[s] = __fmaf_rn(h[4 * q + 2], u.z, wh[s]);
        wh[s] = __fmaf_rn(h[4 * q + 3], u.w, wh[s]);
      }
    }
  }
}

// One row, one warp: the row's H in registers, its column-0 value once,
// then the slots, four consecutive ones a lane where vec (w % 4 == 0 and
// 16-byte aligned cols and out; the next four columns in flight while
// these are computed), else one.
template <int KMAX, bool SMEM>
__device__ __forceinline__ void wh_at_nz_row(
    const int* __restrict__ cols_row, const float* __restrict__ Hrow,
    const float* __restrict__ Wr, const uint4* tbl,
    float* __restrict__ out_row, int w, int k, int g, int nq, int sw,
    bool vec, int lane) {
  float h[KMAX];
#pragma unroll
  for (int c = 0; c < KMAX; ++c) h[c] = c < k ? __ldg(Hrow + c) : 0.f;
  const int col0[1] = {0};
  float wh0[1];
  slots_wh<KMAX, 1, SMEM>(h, tbl, Wr, k, g, nq, sw, col0, false, wh0);
  if (vec) {
    const int4 none = make_int4(0, 0, 0, 0);
    int j = 4 * lane;
    int4 c4 = j < w ? __ldg(reinterpret_cast<const int4*>(cols_row + j))
                    : none;
    while (j < w) {
      const int jn = j + 128;
      const int4 cn =
          jn < w ? __ldg(reinterpret_cast<const int4*>(cols_row + jn))
                 : none;
      const int col[4] = {c4.x, c4.y, c4.z, c4.w};
      float v[4] = {wh0[0], wh0[0], wh0[0], wh0[0]};
      if (c4.x | c4.y | c4.z | c4.w) {
        // two pairs of chains: four at once hold more of the 64 registers
        // a thread of a 1024-thread block has (2-4% slower, H100)
        const int ca[2] = {c4.x, c4.y}, cb[2] = {c4.z, c4.w};
        float ga[2], gb[2];
        slots_wh<KMAX, 2, SMEM>(h, tbl, Wr, k, g, nq, sw, ca, true, ga);
        slots_wh<KMAX, 2, SMEM>(h, tbl, Wr, k, g, nq, sw, cb, true, gb);
        const float g4[4] = {ga[0], ga[1], gb[0], gb[1]};
#pragma unroll
        for (int s = 0; s < 4; ++s)
          if (col[s] != 0) v[s] = g4[s];
      }
      __stcs(reinterpret_cast<float4*>(out_row + j),
             make_float4(v[0], v[1], v[2], v[3]));
      j = jn;
      c4 = cn;
    }
  } else {
    for (int j = lane; j < w; j += 32) {
      const int col[1] = {__ldg(cols_row + j)};
      float v[1] = {wh0[0]};
      if (col[0] != 0)
        slots_wh<KMAX, 1, SMEM>(h, tbl, Wr, k, g, nq, sw, col, true, v);
      __stcs(out_row + j, v[0]);
    }
  }
}

// The table's placement is uniform over a launch and a template argument
// of the row, so no load of the chains waits behind a branch on it.
template <int KMAX>
__global__ void __launch_bounds__(WhShape<KMAX>::THREADS)
wh_at_nz_kernel(const int* __restrict__ cols, const float* __restrict__ H,
                const float* __restrict__ W, float* __restrict__ out, int R,
                int n, int w, int k, int g, int nq, int use_smem, int vec) {
  constexpr int WARPS = WhShape<KMAX>::WARPS;
  extern __shared__ uint4 Wt[];
  const int sw = (nq & (nq - 1)) ? 0 : nq - 1;
  const int lane = threadIdx.x & 31;
  if (use_smem) {
    walk_rows<false, KMAX, WARPS>(
        W, Wt, R, n, k, g, nq, sw, true,
        [&](int64_t gi, int64_t row, const float* Wr) {
          wh_at_nz_row<KMAX, true>(cols + row * w, H + gi * k, Wr, Wt,
                                   out + gi * w, w, k, g, nq, sw, vec != 0,
                                   lane);
        });
  } else {
    walk_rows<false, KMAX, WARPS>(
        W, Wt, R, n, k, g, nq, sw, false,
        [&](int64_t gi, int64_t row, const float* Wr) {
          wh_at_nz_row<KMAX, false>(cols + row * w, H + gi * k, Wr, Wt,
                                    out + gi * w, w, k, g, nq, sw, vec != 0,
                                    lane);
        });
  }
}

// ---------------------------------------------------------------------------
// h_newton_stats, in strict f32 with whm = max(WH, EPS), ratio = X / whm and
// r2 = ratio / whm:
//   numer[r, i, c] = sum_j ratio * W[r, c, cols[i, j]]
//   hess[r, i, c]  = sum_j (r2 * W[r, c, cols[i, j]]) * W[r, c, cols[i, j]]
// the MU numerator and the diagonal Hessian of the Diagonalized-Newton H
// step in one traversal, on h_stats' skeleton with a second accumulator per
// component. Padded slots are skipped and all-zero rows give exact +0.0 in
// both outputs.
// ---------------------------------------------------------------------------

// After warp_fold<2 KMAX, 2 KMAX, 16> of one array holding numer's sums
// (first KMAX) and hess' (the rest), lane l holds sums PER l .. PER l +
// PER - 1 (PER = 2 KMAX / 32): at KMAX = 16 lanes 0-15 numer, 16-31 hess.
template <int KMAX>
__device__ __forceinline__ void store_folded_pair(const float (&a)[2 * KMAX],
                                                  int lane, float* numer,
                                                  float* hess, int k) {
  static_assert(KMAX >= 16, "one sum a lane at least");
  constexpr int PER = 2 * KMAX / 32;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int s = lane * PER + i;
    const int c = s < KMAX ? s : s - KMAX;
    if (c < k) (s < KMAX ? numer : hess)[c] = a[i];
  }
}

// One row, one warp: the row's H in registers, the lanes striding over its
// slots. A stored slot gathers its gene's column once, in ceil(k/4) chunks
// (16-byte shared loads from the packed table, or device memory where it
// does not fit), and keeps it in registers for the WH chain and both sums
// up to KMAX = 32; at 64, h and the two accumulators alone take 192
// registers, so the products gather each chunk a second time. Components
// past k are 0 in h and in the table: +0.0 products, never stored.
template <int KMAX, bool SMEM>
__device__ __forceinline__ void h_newton_row(
    const float* __restrict__ vals_row, const int* __restrict__ cols_row,
    const float* __restrict__ Hrow, const float* __restrict__ Wr,
    const uint4* tbl, float* __restrict__ numer, float* __restrict__ hess,
    int w, int k, int g, int nq, int sw, int lane) {
  float h[KMAX];
#pragma unroll
  for (int c = 0; c < KMAX; ++c) h[c] = c < k ? __ldg(Hrow + c) : 0.f;
  // numer's sums in acc[0, KMAX), hess' in acc[KMAX, 2 KMAX): one array,
  // folded across the warp at once
  float acc[2 * KMAX];
#pragma unroll
  for (int c = 0; c < 2 * KMAX; ++c) acc[c] = 0.f;

  row_slots(vals_row, cols_row, w, lane, [&](int col, float v) {
    float wv[KMAX];   // the column, kept up to KMAX = 32
    float wh = 0.f;
#pragma unroll
    for (int q = 0; q < KMAX / 4; ++q) {
      float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q < nq) u = w_chunk<SMEM>(tbl, Wr, k, g, nq, sw, col, q);
      const float x[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 4 * q + i;
        if constexpr (KMAX <= 32) wv[c] = x[i];
        const float hw = h[c] * x[i];
        wh = (c == 0) ? hw : wh + hw;
      }
    }
    const float whm = fmaxf(wh, KL_EPS);
    const float ratio = v / whm;
    const float r2 = ratio / whm;
#pragma unroll
    for (int q = 0; q < KMAX / 4; ++q) {
      float x[4];
      if constexpr (KMAX <= 32) {
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = wv[4 * q + i];
      } else {
        float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
        if (q < nq) u = w_chunk<SMEM>(tbl, Wr, k, g, nq, sw, col, q);
        x[0] = u.x;
        x[1] = u.y;
        x[2] = u.z;
        x[3] = u.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 4 * q + i;
        acc[c] += ratio * x[i];
        acc[KMAX + c] += (r2 * x[i]) * x[i];
      }
    }
  });
  warp_fold<2 * KMAX, 2 * KMAX, 16>(acc, lane);
  store_folded_pair<KMAX>(acc, lane, numer, hess, k);
}

// h_stats' block (16 warps at k <= 16, whose 128 KB f32 table at g=2000
// leaves one block an SM), the persistent row walk and the table's
// placement a template argument of the row, as in wh_at_nz_kernel.
template <int KMAX>
__global__ void __launch_bounds__(HStatsShape<false, KMAX>::THREADS)
h_newton_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                const float* __restrict__ H, const float* __restrict__ W,
                float* __restrict__ numer, float* __restrict__ hess, int R,
                int n, int w, int k, int g, int nq, int use_smem) {
  constexpr int WARPS = HStatsShape<false, KMAX>::WARPS;
  extern __shared__ uint4 Wt[];
  const int sw = (nq & (nq - 1)) ? 0 : nq - 1;
  const int lane = threadIdx.x & 31;
  if (use_smem) {
    walk_rows<false, KMAX, WARPS>(
        W, Wt, R, n, k, g, nq, sw, true,
        [&](int64_t gi, int64_t row, const float* Wr) {
          h_newton_row<KMAX, true>(vals + row * w, cols + row * w, H + gi * k,
                                   Wr, Wt, numer + gi * k, hess + gi * k, w,
                                   k, g, nq, sw, lane);
        });
  } else {
    walk_rows<false, KMAX, WARPS>(
        W, Wt, R, n, k, g, nq, sw, false,
        [&](int64_t gi, int64_t row, const float* Wr) {
          h_newton_row<KMAX, false>(vals + row * w, cols + row * w,
                                    H + gi * k, Wr, Wt, numer + gi * k,
                                    hess + gi * k, w, k, g, nq, sw, lane);
        });
  }
}

// ---------------------------------------------------------------------------
// beta_err_partials: partials[r, i] = sum over the stored slots of row i
// with X > 0 of
//   xp (u - log1p(max(u, -1))) - WH,  or  xp (u + log xp - log whs) - WH
//   where whs / xp < 1e-6,
// xp = max(X, EPS), whs = max(WH, EPS), u = whs / xp - 1: the nonzero part
// of row i's KL term, one value a row; the wrapper sums the rows and adds
// sum WH in torch.
// ---------------------------------------------------------------------------

// beta_err's block at k <= 16: 32 warps (the 128 KB f32 table of k=13,
// g=2000 leaves one block an SM, and the gathers need the warps in flight:
// 16 warps ran 26-36% slower at k=9 and 13 on the H100, though the 64
// registers a thread of 32 warps has cost a 40-byte spill), else 8
constexpr int BETA_ERR_THREADS_K16 = 1024;

template <int KMAX>
struct BetaErrShape {
  static constexpr int THREADS = KMAX <= 16 ? BETA_ERR_THREADS_K16 : 256;
  static constexpr int WARPS = THREADS / 32;
};

// One stored slot's term, v > 0: the two regimes of the JAX body, with the
// IEEE division, logf and log1pf (no fast math), each operation rounded as
// the plain version rounds it (no fused multiply-add).
__device__ __forceinline__ float kl_slot_term(float v, float wh) {
  const float xp = fmaxf(v, KL_EPS);
  const float whs = fmaxf(wh, KL_EPS);
  const float ratio = whs / xp;
  const float u = ratio - 1.f;
  float term;
  if (ratio < 1e-6f)
    term = u + logf(xp) - logf(whs);
  else
    term = u - log1pf(fmaxf(u, -1.f));
  return __fsub_rn(__fmul_rn(xp, term), wh);
}

// One row, one warp: the row's H in registers, the lanes striding over its
// stored slots. A slot gathers its gene's column in ceil(k/4) chunks
// (16-byte shared loads from the packed table, or device memory where it
// does not fit) and runs the WH chain in component order, each product
// rounded and then added, as the plain version does: a slot's WH and term
// have its bits. Components past k are 0 in h and in the table and leave
// the chain as it is. Each lane adds its slots' terms in order in f64 and
// lane 0 gets the row's sum, rounded to f32 once: a row whose terms cancel
// (a slot's term changes sign where WH = X/e) then agrees with the plain
// version's f64 row sum within one rounding of its value, whatever order
// either sums in.
template <int KMAX, bool SMEM>
__device__ __forceinline__ float beta_err_row(
    const float* __restrict__ vals_row, const int* __restrict__ cols_row,
    const float* __restrict__ Hrow, const float* __restrict__ Wr,
    const uint4* tbl, int w, int k, int g, int nq, int sw, int lane) {
  float h[KMAX];
#pragma unroll
  for (int c = 0; c < KMAX; ++c) h[c] = c < k ? __ldg(Hrow + c) : 0.f;
  double sum = 0.0;
  row_slots(vals_row, cols_row, w, lane, [&](int col, float v) {
    if (!(v > 0.f)) return;   // a negative stored value adds nothing
    float wh = 0.f;
#pragma unroll
    for (int q = 0; q < KMAX / 4; ++q) {
      float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q < nq) u = w_chunk<SMEM>(tbl, Wr, k, g, nq, sw, col, q);
      const float x[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 4 * q + i;
        const float hw = __fmul_rn(h[c], x[i]);
        wh = (c == 0) ? hw : __fadd_rn(wh, hw);
      }
    }
    sum += (double)kl_slot_term(v, wh);
  });
  return (float)warp_sum(sum);
}

// The persistent row walk and the table's placement a template argument of
// the row, as in h_newton_kernel; one value a row, stored by lane 0.
template <int KMAX>
__global__ void __launch_bounds__(BetaErrShape<KMAX>::THREADS)
beta_err_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                const float* __restrict__ H, const float* __restrict__ W,
                float* __restrict__ partials, int R, int n, int w, int k,
                int g, int nq, int use_smem) {
  constexpr int WARPS = BetaErrShape<KMAX>::WARPS;
  extern __shared__ uint4 Wt[];
  const int sw = (nq & (nq - 1)) ? 0 : nq - 1;
  const int lane = threadIdx.x & 31;
  if (use_smem) {
    walk_rows<false, KMAX, WARPS>(
        W, Wt, R, n, k, g, nq, sw, true,
        [&](int64_t gi, int64_t row, const float* Wr) {
          const float s = beta_err_row<KMAX, true>(
              vals + row * w, cols + row * w, H + gi * k, Wr, Wt, w, k, g,
              nq, sw, lane);
          if (lane == 0) partials[gi] = s;
        });
  } else {
    walk_rows<false, KMAX, WARPS>(
        W, Wt, R, n, k, g, nq, sw, false,
        [&](int64_t gi, int64_t row, const float* Wr) {
          const float s = beta_err_row<KMAX, false>(
              vals + row * w, cols + row * w, H + gi * k, Wr, Wt, w, k, g,
              nq, sw, lane);
          if (lane == 0) partials[gi] = s;
        });
  }
}

// a device attribute of the current device, read once per device
template <cudaDeviceAttr ATTR>
int device_attr(int fallback) {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < 64 && cached[dev]) return cached[dev];
  int v = fallback;
  cudaDeviceGetAttribute(&v, ATTR, dev);
  if (dev >= 0 && dev < 64) cached[dev] = v;
  return v;
}

int sm_count() { return device_attr<cudaDevAttrMultiProcessorCount>(132); }

int smem_optin() {
  return device_attr<cudaDevAttrMaxSharedMemoryPerBlockOptin>(48 * 1024);
}

// The launch of a kernel on walk_rows (h_stats, h_newton_stats, wh_at_nz,
// beta_err):
// the packed table's chunks per gene and bytes, shared memory or device
// memory, resident blocks per SM (from the occupancy calculator at that
// table size) and the persistent grid, one wave of resident blocks
struct RowLaunch {
  int threads, nq, use_smem, table_bytes, blocks_per_sm, grid;
};

template <typename Kern>
int row_launch(Kern kern, int threads, int nq, int R, int n, int g,
               RowLaunch* L) {
  L->threads = threads;
  L->nq = nq;
  const size_t bytes = (size_t)g * nq * 16;
  L->use_smem = bytes <= (size_t)smem_optin();
  L->table_bytes = L->use_smem ? (int)bytes : 0;
  if (L->table_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L->table_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  int nb = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, kern, threads, L->table_bytes);
  if (e != cudaSuccess) return (int)e;
  L->blocks_per_sm = nb > 0 ? nb : 1;
  const int warps = threads / 32;
  const int64_t need = ((int64_t)R * n + warps - 1) / warps;
  const int64_t wave = (int64_t)L->blocks_per_sm * sm_count();
  L->grid = (int)(need < wave ? (need > 0 ? need : 1) : wave);
  return 0;
}

template <typename VT, bool BF16, int KMAX>
int h_stats_launch(int R, int n, int k, int g, RowLaunch* L) {
  return row_launch(h_stats_kernel<VT, BF16, KMAX>,
                    HStatsShape<BF16, KMAX>::THREADS, packed_chunks(k, BF16),
                    R, n, g, L);
}

template <typename VT, bool BF16, int KMAX>
int run_h_stats(const void* vals, const void* cols, const void* H,
                const void* W, void* numer, int R, int n, int w, int k, int g,
                cudaStream_t s, RowLaunch* query) {
  RowLaunch L;
  int e = h_stats_launch<VT, BF16, KMAX>(R, n, k, g, &L);
  if (e) return e;
  if (query) {
    *query = L;
    return 0;
  }
  if ((int64_t)R * n == 0) return 0;
  h_stats_kernel<VT, BF16, KMAX><<<L.grid, L.threads, L.table_bytes, s>>>(
      (const VT*)vals, (const int*)cols, (const float*)H, (const float*)W,
      (float*)numer, R, n, w, k, g, L.nq, L.use_smem);
  return (int)cudaGetLastError();
}

template <int KMAX>
int run_kmax_h_stats(const void* vals, int vals_bf16, const void* cols,
                     const void* H, const void* W, void* numer, int R, int n,
                     int w, int k, int g, int bf16, cudaStream_t s,
                     RowLaunch* query) {
  if (!bf16) {
    if (vals_bf16) return (int)cudaErrorInvalidValue;
    return run_h_stats<float, false, KMAX>(vals, cols, H, W, numer, R, n, w,
                                           k, g, s, query);
  }
  if (vals_bf16)
    return run_h_stats<__nv_bfloat16, true, KMAX>(vals, cols, H, W, numer, R,
                                                  n, w, k, g, s, query);
  return run_h_stats<float, true, KMAX>(vals, cols, H, W, numer, R, n, w, k,
                                        g, s, query);
}

int dispatch_h_stats(const void* vals, int vals_bf16, const void* cols,
                     const void* H, const void* W, void* numer, int R, int n,
                     int w, int k, int g, int bf16, cudaStream_t s,
                     RowLaunch* query) {
  if (k <= 16)
    return run_kmax_h_stats<16>(vals, vals_bf16, cols, H, W, numer, R, n, w,
                                k, g, bf16, s, query);
  if (k <= 32)
    return run_kmax_h_stats<32>(vals, vals_bf16, cols, H, W, numer, R, n, w,
                                k, g, bf16, s, query);
  if (k <= 64)
    return run_kmax_h_stats<64>(vals, vals_bf16, cols, H, W, numer, R, n, w,
                                k, g, bf16, s, query);
  return (int)cudaErrorInvalidValue;
}

// w_numer's two launches: the scratch arrays, then the gene-side traversal
template <typename VT, bool BF16, int KMAX>
int run_w_numer(const void* vals, const void* rows_t, const void* perm_t,
                const void* H, const void* W, void* Hp, void* Xt,
                void* numer, int R, int n, int w, int k, int g, int wt,
                int nq, cudaStream_t s) {
  using XT = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  if (nq != packed_chunks(k, BF16)) return (int)cudaErrorInvalidValue;
  const int64_t rows = (int64_t)R * n;
  const int64_t slots = (int64_t)g * wt;
  const int64_t work = rows * nq > slots ? rows * nq : slots;
  if (work > 0) {
    const int64_t need = (work + PREP_THREADS - 1) / PREP_THREADS;
    const int64_t cap = 16 * (int64_t)sm_count();
    w_numer_prep_kernel<VT, XT, BF16>
        <<<(unsigned)(need < cap ? need : cap), PREP_THREADS, 0, s>>>(
            (const VT*)vals, (const int*)perm_t, (const float*)H,
            (uint4*)Hp, (XT*)Xt, rows, k, nq, slots, n * w);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t items = (int64_t)R * g;
  if (items == 0) return 0;
  w_numer_kernel<XT, BF16, KMAX>
      <<<(unsigned)((items + W_NUMER_WARPS - 1) / W_NUMER_WARPS),
         W_NUMER_WARPS * 32, 0, s>>>(
          (const XT*)Xt, (const int*)rows_t, (const int*)perm_t,
          (const uint4*)Hp, (const float*)W, (float*)numer, n, k, g, wt, nq,
          n * w, items);
  return (int)cudaGetLastError();
}

template <int KMAX>
int run_kmax_w_numer(const void* vals, int vals_bf16, const void* rows_t,
                     const void* perm_t, const void* H, const void* W,
                     void* Hp, void* Xt, void* numer, int R, int n, int w,
                     int k, int g, int wt, int nq, int bf16, cudaStream_t s) {
  if (!bf16) {
    if (vals_bf16) return (int)cudaErrorInvalidValue;
    return run_w_numer<float, false, KMAX>(vals, rows_t, perm_t, H, W, Hp,
                                           Xt, numer, R, n, w, k, g, wt, nq,
                                           s);
  }
  if (vals_bf16)
    return run_w_numer<__nv_bfloat16, true, KMAX>(vals, rows_t, perm_t, H,
                                                  W, Hp, Xt, numer, R, n, w,
                                                  k, g, wt, nq, s);
  return run_w_numer<float, true, KMAX>(vals, rows_t, perm_t, H, W, Hp, Xt,
                                        numer, R, n, w, k, g, wt, nq, s);
}

template <int KMAX>
int run_kmax_beta_err(const void* vals, const void* cols, const void* H,
                      const void* W, void* partials, int R, int n, int w,
                      int k, int g, cudaStream_t s, RowLaunch* query) {
  RowLaunch L;
  int e = row_launch(beta_err_kernel<KMAX>, BetaErrShape<KMAX>::THREADS,
                     packed_chunks(k, false), R, n, g, &L);
  if (e) return e;
  if (query) {
    *query = L;
    return 0;
  }
  if ((int64_t)R * n == 0) return 0;
  beta_err_kernel<KMAX><<<L.grid, L.threads, L.table_bytes, s>>>(
      (const float*)vals, (const int*)cols, (const float*)H, (const float*)W,
      (float*)partials, R, n, w, k, g, L.nq, L.use_smem);
  return (int)cudaGetLastError();
}

int dispatch_beta_err(const void* vals, const void* cols, const void* H,
                      const void* W, void* partials, int R, int n, int w,
                      int k, int g, cudaStream_t s, RowLaunch* query) {
  if (k <= 16)
    return run_kmax_beta_err<16>(vals, cols, H, W, partials, R, n, w, k, g,
                                 s, query);
  if (k <= 32)
    return run_kmax_beta_err<32>(vals, cols, H, W, partials, R, n, w, k, g,
                                 s, query);
  if (k <= 64)
    return run_kmax_beta_err<64>(vals, cols, H, W, partials, R, n, w, k, g,
                                 s, query);
  return (int)cudaErrorInvalidValue;
}

template <int KMAX>
int run_kmax_h_newton(const void* vals, const void* cols, const void* H,
                      const void* W, void* numer, void* hess, int R, int n,
                      int w, int k, int g, cudaStream_t s,
                      RowLaunch* query) {
  RowLaunch L;
  int e = row_launch(h_newton_kernel<KMAX>, HStatsShape<false, KMAX>::THREADS,
                     packed_chunks(k, false), R, n, g, &L);
  if (e) return e;
  if (query) {
    *query = L;
    return 0;
  }
  if ((int64_t)R * n == 0) return 0;
  h_newton_kernel<KMAX><<<L.grid, L.threads, L.table_bytes, s>>>(
      (const float*)vals, (const int*)cols, (const float*)H, (const float*)W,
      (float*)numer, (float*)hess, R, n, w, k, g, L.nq, L.use_smem);
  return (int)cudaGetLastError();
}

int dispatch_h_newton(const void* vals, const void* cols, const void* H,
                      const void* W, void* numer, void* hess, int R, int n,
                      int w, int k, int g, cudaStream_t s, RowLaunch* query) {
  if (k <= 16)
    return run_kmax_h_newton<16>(vals, cols, H, W, numer, hess, R, n, w, k,
                                 g, s, query);
  if (k <= 32)
    return run_kmax_h_newton<32>(vals, cols, H, W, numer, hess, R, n, w, k,
                                 g, s, query);
  if (k <= 64)
    return run_kmax_h_newton<64>(vals, cols, H, W, numer, hess, R, n, w, k,
                                 g, s, query);
  return (int)cudaErrorInvalidValue;
}

template <int KMAX>
int run_kmax_wh_at_nz(const void* cols, const void* H, const void* W,
                      void* out, int R, int n, int w, int k, int g,
                      cudaStream_t s, RowLaunch* query) {
  RowLaunch L;
  int e = row_launch(wh_at_nz_kernel<KMAX>, WhShape<KMAX>::THREADS,
                     packed_chunks(k, false), R, n, g, &L);
  if (e) return e;
  if (query) {
    *query = L;
    return 0;
  }
  if ((int64_t)R * n == 0) return 0;
  const int vec = w % 4 == 0 && ((uintptr_t)cols & 15) == 0 &&
                  ((uintptr_t)out & 15) == 0;
  wh_at_nz_kernel<KMAX><<<L.grid, L.threads, L.table_bytes, s>>>(
      (const int*)cols, (const float*)H, (const float*)W, (float*)out, R, n,
      w, k, g, L.nq, L.use_smem, vec);
  return (int)cudaGetLastError();
}

int dispatch_wh_at_nz(const void* cols, const void* H, const void* W,
                      void* out, int R, int n, int w, int k, int g,
                      cudaStream_t s, RowLaunch* query) {
  if (k <= 16)
    return run_kmax_wh_at_nz<16>(cols, H, W, out, R, n, w, k, g, s, query);
  if (k <= 32)
    return run_kmax_wh_at_nz<32>(cols, H, W, out, R, n, w, k, g, s, query);
  if (k <= 64)
    return run_kmax_wh_at_nz<64>(cols, H, W, out, R, n, w, k, g, s, query);
  return (int)cudaErrorInvalidValue;
}

// a RowLaunch as the six ints of the launch queries: {threads per block,
// chunks per gene, table in shared memory (1) or read from device memory
// (0), table bytes, resident blocks per SM, grid}
void put_launch(const RowLaunch& L, int* out) {
  const int v[6] = {L.threads, L.nq, L.use_smem, L.table_bytes,
                    L.blocks_per_sm, L.grid};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
}

}  // namespace

extern "C" {

int kl_h_stats(const void* vals, int vals_bf16, const void* cols,
               const void* H, const void* W, void* numer, int R, int n,
               int w, int k, int g, int bf16, void* stream) {
  return dispatch_h_stats(vals, vals_bf16, cols, H, W, numer, R, n, w, k, g,
                          bf16, (cudaStream_t)stream, nullptr);
}

// h_stats' launch at these sizes, without launching (put_launch's six
// ints)
int kl_h_stats_launch(int R, int n, int k, int g, int bf16, int vals_bf16,
                      int* out) {
  RowLaunch L;
  int e = dispatch_h_stats(nullptr, vals_bf16, nullptr, nullptr, nullptr,
                           nullptr, R, n, 0, k, g, bf16, nullptr, &L);
  if (e) return e;
  put_launch(L, out);
  return 0;
}

// scratch: Hp, R*n*nq 16-byte chunks, nq = ceil(k/8) (bf16) or ceil(k/4)
// (f32), for the packed copy of H; Xt, g*wt values (bf16 in bf16 mode,
// else f32) for the gene-side values
int kl_w_numer(const void* vals, int vals_bf16, const void* rows_t,
               const void* perm_t, const void* H, const void* W, void* Hp,
               void* Xt, void* numer, int R, int n, int w, int k, int g,
               int wt, int nq, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 16)
    return run_kmax_w_numer<16>(vals, vals_bf16, rows_t, perm_t, H, W, Hp,
                                Xt, numer, R, n, w, k, g, wt, nq, bf16, s);
  if (k <= 32)
    return run_kmax_w_numer<32>(vals, vals_bf16, rows_t, perm_t, H, W, Hp,
                                Xt, numer, R, n, w, k, g, wt, nq, bf16, s);
  if (k <= 64)
    return run_kmax_w_numer<64>(vals, vals_bf16, rows_t, perm_t, H, W, Hp,
                                Xt, numer, R, n, w, k, g, wt, nq, bf16, s);
  return (int)cudaErrorInvalidValue;
}

// partials (R, n): the nonzero part of each row's KL term
int kl_beta_err_partials(const void* vals, const void* cols, const void* H,
                         const void* W, void* partials, int R, int n, int w,
                         int k, int g, void* stream) {
  return dispatch_beta_err(vals, cols, H, W, partials, R, n, w, k, g,
                           (cudaStream_t)stream, nullptr);
}

// beta_err_partials' launch at these sizes, without launching (put_launch's
// six ints)
int kl_beta_err_launch(int R, int n, int k, int g, int* out) {
  RowLaunch L;
  int e = dispatch_beta_err(nullptr, nullptr, nullptr, nullptr, nullptr, R, n,
                            0, k, g, nullptr, &L);
  if (e) return e;
  put_launch(L, out);
  return 0;
}

int kl_h_newton_stats(const void* vals, const void* cols, const void* H,
                      const void* W, void* numer, void* hess, int R, int n,
                      int w, int k, int g, void* stream) {
  return dispatch_h_newton(vals, cols, H, W, numer, hess, R, n, w, k, g,
                           (cudaStream_t)stream, nullptr);
}

// h_newton_stats' launch at these sizes, without launching (put_launch's
// six ints)
int kl_h_newton_stats_launch(int R, int n, int k, int g, int* out) {
  RowLaunch L;
  int e = dispatch_h_newton(nullptr, nullptr, nullptr, nullptr, nullptr,
                            nullptr, R, n, 0, k, g, nullptr, &L);
  if (e) return e;
  put_launch(L, out);
  return 0;
}

int kl_wh_at_nz(const void* cols, const void* H, const void* W, void* out,
                int R, int n, int w, int k, int g, void* stream) {
  return dispatch_wh_at_nz(cols, H, W, out, R, n, w, k, g,
                           (cudaStream_t)stream, nullptr);
}

// wh_at_nz's launch at these sizes, without launching (put_launch's six
// ints)
int kl_wh_at_nz_launch(int R, int n, int k, int g, int* out) {
  RowLaunch L;
  int e = dispatch_wh_at_nz(nullptr, nullptr, nullptr, nullptr, R, n, 0, k, g,
                            nullptr, &L);
  if (e) return e;
  put_launch(L, out);
  return 0;
}

}  // extern "C"
