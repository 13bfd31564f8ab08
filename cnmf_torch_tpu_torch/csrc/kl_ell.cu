// Hopper (sm_90a) kernels for the sparse (ELL) KL statistics of the
// consensus-NMF solvers. They replace the Pallas TPU kernels of
// cnmf_torch_tpu/ops/pallas_kl.py:
//
//   h_stats            <- pallas_kl_h_stats   (_h_stats_body)
//   ratio              <- pallas_kl_w_numer pass 1 (_ratio_body)
//   w_numer            <- pallas_kl_w_numer pass 2 (_w_numer_body)
//   beta_err_partials  <- pallas_kl_beta_err  (_obj_body)
//   h_newton_stats     <- pallas_kl_h_newton_stats (_h_newton_body)
//   wh_at_nz           <- pallas_wh_at_nz     (_wh_body)
//
// The first four serve every MU solve; the last two serve the
// Diagonalized-Newton (dna) recipe of the batch solver.
//
// Layout: the ELL buffers (vals, cols: n x w; rows_t, perm_t: g x wt) are
// shared by every replicate; H (R, n, k), W (R, k, g) and every output
// carry the replicate axis, which is gridDim.y. Padded slots hold value 0
// at column 0 (row side) or point at the zero sentinel slot n*w of the
// flat ratio buffer (transpose side), so they add exactly +0.0.
//
// Design (see ops/kernels/kl_ell.py for the bound of each kernel):
//   * one warp per row (h_stats, ratio, beta_err, h_newton_stats,
//     wh_at_nz) or per gene (w_numer); lanes stride over the row's w (or
//     the gene's wt) slots;
//   * the row's H[r, i, :] lives in registers; W[r] is staged once per
//     block in dynamic shared memory when k*g*4 bytes fit the budget,
//     otherwise read through the read-only cache (__ldg);
//   * per-component sums are reduced across the warp with shuffles in a
//     fixed order and written by lane 0 — no atomics, so repeated runs are
//     bit-identical;
//   * bf16 mode rounds where the JAX bf16 chain rounds: operands to bf16,
//     WH accumulated in bf16, the ratio in bf16, every ratio*W (or ratio*H)
//     product rounded to bf16 and then summed in f32.
//
// Strict IEEE f32 arithmetic (no fast math): where WH underflows, the
// Newton Hessian may overflow to +inf, and the kernel and its plain
// version must then agree (grad / inf = 0 keeps the Newton candidate at H).
//
// Plain C interface for ctypes; every entry point returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float KL_EPS = 1e-16f;
constexpr int WARPS_PER_BLOCK = 8;
constexpr int THREADS = WARPS_PER_BLOCK * 32;
// stage W[r] in shared memory up to this many bytes; above, use __ldg
constexpr int SMEM_W_LIMIT = 200 * 1024;

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

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
  }
  return s;
}

// Stage W[r] (k x g) into shared memory, rounded to bf16 in bf16 mode.
template <bool BF16>
__device__ __forceinline__ void stage_w(float* Ws, const float* Wr, int kg) {
  for (int i = threadIdx.x; i < kg; i += blockDim.x) {
    const float v = __ldg(Wr + i);
    Ws[i] = BF16 ? round_bf16(v) : v;
  }
  __syncthreads();
}

template <bool BF16>
__device__ __forceinline__ float w_at(const float* Ws, const float* Wr,
                                      bool use_smem, int idx) {
  if (use_smem) return Ws[idx];
  const float v = __ldg(Wr + idx);
  return BF16 ? round_bf16(v) : v;
}

// WH at one stored coordinate and the ratio X / max(WH, EPS).
template <int KMAX, bool BF16>
__device__ __forceinline__ float ratio_at(const float (&h)[KMAX], int k,
                                          const float* Ws, const float* Wr,
                                          bool use_smem, int g, int col,
                                          float v) {
  float wh = 0.f;
#pragma unroll
  for (int c = 0; c < KMAX; ++c) {
    if (c < k) {
      const float wv = w_at<BF16>(Ws, Wr, use_smem, c * g + col);
      if (BF16) {
        const float p = round_bf16(h[c] * wv);
        wh = (c == 0) ? p : round_bf16(wh + p);
      } else {
        wh = (c == 0) ? h[c] * wv : wh + h[c] * wv;
      }
    }
  }
  if (BF16) {
    const float den = fmaxf(wh, round_bf16(KL_EPS));
    return round_bf16(round_bf16(v) / den);
  }
  return v / fmaxf(wh, KL_EPS);
}

template <int KMAX, bool BF16>
__device__ __forceinline__ void load_h_row(float (&h)[KMAX],
                                           const float* Hrow, int k) {
#pragma unroll
  for (int c = 0; c < KMAX; ++c) {
    const float v = (c < k) ? __ldg(Hrow + c) : 0.f;
    h[c] = BF16 ? round_bf16(v) : v;
  }
}

// numer[r, i, c] = sum_j ratio[i, j] * W[r, c, cols[i, j]]
template <typename VT, bool BF16, int KMAX>
__global__ void __launch_bounds__(THREADS)
h_stats_kernel(const VT* __restrict__ vals, const int* __restrict__ cols,
               const float* __restrict__ H, const float* __restrict__ W,
               float* __restrict__ numer, int n, int w, int k, int g,
               int use_smem) {
  extern __shared__ float Ws[];
  const int r = blockIdx.y;
  const float* Wr = W + (int64_t)r * k * g;
  if (use_smem) stage_w<BF16>(Ws, Wr, k * g);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int row = blockIdx.x * WARPS_PER_BLOCK + warp; row < n;
       row += gridDim.x * WARPS_PER_BLOCK) {
    const int64_t hrow = ((int64_t)r * n + row) * k;
    float h[KMAX];
    load_h_row<KMAX, BF16>(h, H + hrow, k);
    float acc[KMAX];
#pragma unroll
    for (int c = 0; c < KMAX; ++c) acc[c] = 0.f;
    const int64_t base = (int64_t)row * w;
    for (int j = lane; j < w; j += 32) {
      const int col = __ldg(cols + base + j);
      const float ratio = ratio_at<KMAX, BF16>(h, k, Ws, Wr, use_smem != 0,
                                               g, col, load_val(vals + base + j));
#pragma unroll
      for (int c = 0; c < KMAX; ++c) {
        if (c < k) {
          const float wv = w_at<BF16>(Ws, Wr, use_smem != 0, c * g + col);
          acc[c] += BF16 ? round_bf16(ratio * wv) : ratio * wv;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < KMAX; ++c) {
      if (c < k) {
        const float s = warp_sum(acc[c]);
        if (lane == 0) numer[hrow + c] = s;
      }
    }
  }
}

// out[r, i*w + j] = ratio at (i, j); out[r, n*w] = 0 (the sentinel slot)
template <typename VT, typename OT, bool BF16, int KMAX>
__global__ void __launch_bounds__(THREADS)
ratio_kernel(const VT* __restrict__ vals, const int* __restrict__ cols,
             const float* __restrict__ H, const float* __restrict__ W,
             OT* __restrict__ out, int n, int w, int k, int g, int use_smem) {
  extern __shared__ float Ws[];
  const int r = blockIdx.y;
  const float* Wr = W + (int64_t)r * k * g;
  if (use_smem) stage_w<BF16>(Ws, Wr, k * g);
  const int64_t nw1 = (int64_t)n * w + 1;
  OT* outr = out + (int64_t)r * nw1;
  if (blockIdx.x == 0 && threadIdx.x == 0) store_val(outr + nw1 - 1, 0.f);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int row = blockIdx.x * WARPS_PER_BLOCK + warp; row < n;
       row += gridDim.x * WARPS_PER_BLOCK) {
    float h[KMAX];
    load_h_row<KMAX, BF16>(h, H + ((int64_t)r * n + row) * k, k);
    const int64_t base = (int64_t)row * w;
    for (int j = lane; j < w; j += 32) {
      const int col = __ldg(cols + base + j);
      store_val(outr + base + j,
                ratio_at<KMAX, BF16>(h, k, Ws, Wr, use_smem != 0, g, col,
                                     load_val(vals + base + j)));
    }
  }
}

// numer[r, c, gene] = sum_t ratio[r, perm_t[gene, t]] * H[r, rows_t[gene, t], c]
template <typename RT, bool BF16, int KMAX>
__global__ void __launch_bounds__(THREADS)
w_numer_kernel(const int* __restrict__ rows_t, const int* __restrict__ perm_t,
               const RT* __restrict__ ratio, const float* __restrict__ H,
               float* __restrict__ numer, int n, int w, int k, int g,
               int wt) {
  const int r = blockIdx.y;
  const int64_t nw1 = (int64_t)n * w + 1;
  const RT* rr = ratio + (int64_t)r * nw1;
  const float* Hr = H + (int64_t)r * n * k;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int gene = blockIdx.x * WARPS_PER_BLOCK + warp; gene < g;
       gene += gridDim.x * WARPS_PER_BLOCK) {
    float acc[KMAX];
#pragma unroll
    for (int c = 0; c < KMAX; ++c) acc[c] = 0.f;
    const int64_t base = (int64_t)gene * wt;
    for (int t = lane; t < wt; t += 32) {
      const float rv = load_val(rr + __ldg(perm_t + base + t));
      const float* Hrow = Hr + (int64_t)__ldg(rows_t + base + t) * k;
#pragma unroll
      for (int c = 0; c < KMAX; ++c) {
        if (c < k) {
          const float hv = BF16 ? round_bf16(__ldg(Hrow + c)) : __ldg(Hrow + c);
          acc[c] += BF16 ? round_bf16(rv * hv) : rv * hv;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < KMAX; ++c) {
      if (c < k) {
        const float s = warp_sum(acc[c]);
        if (lane == 0) numer[((int64_t)r * k + c) * g + gene] = s;
      }
    }
  }
}

// numer[r, i, c] = sum_j ratio[i, j] * W[r, c, cols[i, j]]
// hess[r, i, c]  = sum_j (ratio[i, j] / whm[i, j]) * W[r, c, cols[i, j]]^2
// with whm = max(WH, EPS) and ratio = X / whm, in f32: the MU numerator
// and the diagonal Hessian of the Diagonalized-Newton H step in one
// traversal (h_stats' skeleton with a second accumulator per component).
// Padded slots (value 0) and all-zero rows give exact +0.0 in both.
template <int KMAX>
__global__ void __launch_bounds__(THREADS)
h_newton_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                const float* __restrict__ H, const float* __restrict__ W,
                float* __restrict__ numer, float* __restrict__ hess, int n,
                int w, int k, int g, int use_smem) {
  extern __shared__ float Ws[];
  const int r = blockIdx.y;
  const float* Wr = W + (int64_t)r * k * g;
  if (use_smem) stage_w<false>(Ws, Wr, k * g);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int row = blockIdx.x * WARPS_PER_BLOCK + warp; row < n;
       row += gridDim.x * WARPS_PER_BLOCK) {
    const int64_t hrow = ((int64_t)r * n + row) * k;
    float h[KMAX];
    load_h_row<KMAX, false>(h, H + hrow, k);
    float an[KMAX], ah[KMAX];
#pragma unroll
    for (int c = 0; c < KMAX; ++c) {
      an[c] = 0.f;
      ah[c] = 0.f;
    }
    const int64_t base = (int64_t)row * w;
    for (int j = lane; j < w; j += 32) {
      const int col = __ldg(cols + base + j);
      const float v = __ldg(vals + base + j);
      float wh = 0.f;
#pragma unroll
      for (int c = 0; c < KMAX; ++c) {
        if (c < k) {
          const float wv = w_at<false>(Ws, Wr, use_smem != 0, c * g + col);
          wh = (c == 0) ? h[c] * wv : wh + h[c] * wv;
        }
      }
      const float whm = fmaxf(wh, KL_EPS);
      const float ratio = v / whm;
      const float r2 = ratio / whm;
#pragma unroll
      for (int c = 0; c < KMAX; ++c) {
        if (c < k) {
          const float wv = w_at<false>(Ws, Wr, use_smem != 0, c * g + col);
          an[c] += ratio * wv;
          ah[c] += (r2 * wv) * wv;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < KMAX; ++c) {
      if (c < k) {
        const float sn = warp_sum(an[c]);
        const float sh = warp_sum(ah[c]);
        if (lane == 0) {
          numer[hrow + c] = sn;
          hess[hrow + c] = sh;
        }
      }
    }
  }
}

// out[r, i, j] = sum_c H[r, i, c] * W[r, c, cols[i, j]] at every stored
// slot (the SDDMM); lanes write consecutive slots of a row (coalesced)
template <int KMAX>
__global__ void __launch_bounds__(THREADS)
wh_at_nz_kernel(const int* __restrict__ cols, const float* __restrict__ H,
                const float* __restrict__ W, float* __restrict__ out, int n,
                int w, int k, int g, int use_smem) {
  extern __shared__ float Ws[];
  const int r = blockIdx.y;
  const float* Wr = W + (int64_t)r * k * g;
  if (use_smem) stage_w<false>(Ws, Wr, k * g);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int row = blockIdx.x * WARPS_PER_BLOCK + warp; row < n;
       row += gridDim.x * WARPS_PER_BLOCK) {
    float h[KMAX];
    load_h_row<KMAX, false>(h, H + ((int64_t)r * n + row) * k, k);
    const int64_t base = (int64_t)row * w;
    float* outr = out + (int64_t)r * n * w + base;
    for (int j = lane; j < w; j += 32) {
      const int col = __ldg(cols + base + j);
      float wh = 0.f;
#pragma unroll
      for (int c = 0; c < KMAX; ++c) {
        if (c < k) {
          const float wv = w_at<false>(Ws, Wr, use_smem != 0, c * g + col);
          wh = (c == 0) ? h[c] * wv : wh + h[c] * wv;
        }
      }
      outr[j] = wh;
    }
  }
}

// partials[r, block] = sum over the block's rows of
//   [X > 0] * (X (u - log1p(u)) or its split-log form  -  WH),  u = WH/X - 1
template <int KMAX>
__global__ void __launch_bounds__(THREADS)
beta_err_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                const float* __restrict__ H, const float* __restrict__ W,
                float* __restrict__ partials, int n, int w, int k, int g,
                int use_smem) {
  extern __shared__ float Ws[];
  __shared__ float red[WARPS_PER_BLOCK];
  const int r = blockIdx.y;
  const float* Wr = W + (int64_t)r * k * g;
  if (use_smem) stage_w<false>(Ws, Wr, k * g);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float local = 0.f;
  for (int row = blockIdx.x * WARPS_PER_BLOCK + warp; row < n;
       row += gridDim.x * WARPS_PER_BLOCK) {
    float h[KMAX];
    load_h_row<KMAX, false>(h, H + ((int64_t)r * n + row) * k, k);
    const int64_t base = (int64_t)row * w;
    for (int j = lane; j < w; j += 32) {
      const float v = __ldg(vals + base + j);
      if (v > 0.f) {
        const int col = __ldg(cols + base + j);
        float wh = 0.f;
#pragma unroll
        for (int c = 0; c < KMAX; ++c) {
          if (c < k) {
            const float wv = w_at<false>(Ws, Wr, use_smem != 0, c * g + col);
            wh = (c == 0) ? h[c] * wv : wh + h[c] * wv;
          }
        }
        const float xp = fmaxf(v, KL_EPS);
        const float whs = fmaxf(wh, KL_EPS);
        const float ratio = whs / xp;
        const float u = ratio - 1.f;
        const float term =
            (ratio < 1e-6f) ? (u + logf(xp) - logf(whs))
                            : (u - log1pf(fmaxf(u, -1.f)));
        local += xp * term - wh;
      }
    }
  }
  local = warp_sum(local);
  if (lane == 0) red[warp] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < WARPS_PER_BLOCK; ++i) s += red[i];
    partials[(int64_t)r * gridDim.x + blockIdx.x] = s;
  }
}

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < 64 && cached[dev]) return cached[dev];
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (dev >= 0 && dev < 64) cached[dev] = sms;
  return sms;
}

// blocks along x: enough to cover the rows (or genes), capped so that the
// whole (x, R) grid is about 4 blocks per SM — each block then walks
// several rows and stages W once for all of them
int grid_x_for(int R, int items) {
  const int need = (items + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  int cap = (4 * sm_count()) / (R > 0 ? R : 1);
  if (cap < 1) cap = 1;
  return need < cap ? (need > 0 ? need : 1) : cap;
}

template <typename K>
int launch_row_kernel(K kernel, int R, int n, int k, int g, size_t* smem,
                      int* use_smem, dim3* grid) {
  const size_t bytes = (size_t)k * g * sizeof(float);
  *use_smem = bytes <= (size_t)SMEM_W_LIMIT;
  *smem = *use_smem ? bytes : 0;
  if (*smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
    if (e != cudaSuccess) return (int)e;
  }
  *grid = dim3(grid_x_for(R, n), R);
  return 0;
}

template <typename VT, bool BF16, int KMAX>
int run_h_stats(const void* vals, const void* cols, const void* H,
                const void* W, void* numer, int R, int n, int w, int k, int g,
                cudaStream_t s) {
  auto kern = h_stats_kernel<VT, BF16, KMAX>;
  size_t smem;
  int use_smem;
  dim3 grid;
  int e = launch_row_kernel(kern, R, n, k, g, &smem, &use_smem, &grid);
  if (e) return e;
  kern<<<grid, THREADS, smem, s>>>(
      (const VT*)vals, (const int*)cols, (const float*)H, (const float*)W,
      (float*)numer, n, w, k, g, use_smem);
  return (int)cudaGetLastError();
}

template <typename VT, typename OT, bool BF16, int KMAX>
int run_ratio(const void* vals, const void* cols, const void* H,
              const void* W, void* out, int R, int n, int w, int k, int g,
              cudaStream_t s) {
  auto kern = ratio_kernel<VT, OT, BF16, KMAX>;
  size_t smem;
  int use_smem;
  dim3 grid;
  int e = launch_row_kernel(kern, R, n, k, g, &smem, &use_smem, &grid);
  if (e) return e;
  kern<<<grid, THREADS, smem, s>>>(
      (const VT*)vals, (const int*)cols, (const float*)H, (const float*)W,
      (OT*)out, n, w, k, g, use_smem);
  return (int)cudaGetLastError();
}

template <int KMAX>
int run_kmax_h_stats(const void* vals, int vals_bf16, const void* cols,
                     const void* H, const void* W, void* numer, int R, int n,
                     int w, int k, int g, int bf16, cudaStream_t s) {
  if (!bf16) {
    if (vals_bf16) return (int)cudaErrorInvalidValue;
    return run_h_stats<float, false, KMAX>(vals, cols, H, W, numer, R, n, w,
                                           k, g, s);
  }
  if (vals_bf16)
    return run_h_stats<__nv_bfloat16, true, KMAX>(vals, cols, H, W, numer, R,
                                                  n, w, k, g, s);
  return run_h_stats<float, true, KMAX>(vals, cols, H, W, numer, R, n, w, k,
                                        g, s);
}

template <int KMAX>
int run_kmax_ratio(const void* vals, int vals_bf16, const void* cols,
                   const void* H, const void* W, void* out, int R, int n,
                   int w, int k, int g, int bf16, cudaStream_t s) {
  if (!bf16) {
    if (vals_bf16) return (int)cudaErrorInvalidValue;
    return run_ratio<float, float, false, KMAX>(vals, cols, H, W, out, R, n,
                                                w, k, g, s);
  }
  if (vals_bf16)
    return run_ratio<__nv_bfloat16, __nv_bfloat16, true, KMAX>(
        vals, cols, H, W, out, R, n, w, k, g, s);
  return run_ratio<float, __nv_bfloat16, true, KMAX>(vals, cols, H, W, out,
                                                     R, n, w, k, g, s);
}

template <int KMAX>
int run_kmax_w_numer(const void* rows_t, const void* perm_t,
                     const void* ratio, const void* H, void* numer, int R,
                     int n, int w, int k, int g, int wt, int bf16,
                     cudaStream_t s) {
  dim3 grid(grid_x_for(R, g), R);
  if (bf16) {
    w_numer_kernel<__nv_bfloat16, true, KMAX><<<grid, THREADS, 0, s>>>(
        (const int*)rows_t, (const int*)perm_t, (const __nv_bfloat16*)ratio,
        (const float*)H, (float*)numer, n, w, k, g, wt);
  } else {
    w_numer_kernel<float, false, KMAX><<<grid, THREADS, 0, s>>>(
        (const int*)rows_t, (const int*)perm_t, (const float*)ratio,
        (const float*)H, (float*)numer, n, w, k, g, wt);
  }
  return (int)cudaGetLastError();
}

template <int KMAX>
int run_kmax_beta_err(const void* vals, const void* cols, const void* H,
                      const void* W, void* partials, int R, int n, int w,
                      int k, int g, cudaStream_t s) {
  auto kern = beta_err_kernel<KMAX>;
  size_t smem;
  int use_smem;
  dim3 grid;
  int e = launch_row_kernel(kern, R, n, k, g, &smem, &use_smem, &grid);
  if (e) return e;
  kern<<<grid, THREADS, smem, s>>>((const float*)vals, (const int*)cols,
                                   (const float*)H, (const float*)W,
                                   (float*)partials, n, w, k, g, use_smem);
  return (int)cudaGetLastError();
}

template <int KMAX>
int run_kmax_h_newton(const void* vals, const void* cols, const void* H,
                      const void* W, void* numer, void* hess, int R, int n,
                      int w, int k, int g, cudaStream_t s) {
  auto kern = h_newton_kernel<KMAX>;
  size_t smem;
  int use_smem;
  dim3 grid;
  int e = launch_row_kernel(kern, R, n, k, g, &smem, &use_smem, &grid);
  if (e) return e;
  kern<<<grid, THREADS, smem, s>>>((const float*)vals, (const int*)cols,
                                   (const float*)H, (const float*)W,
                                   (float*)numer, (float*)hess, n, w, k, g,
                                   use_smem);
  return (int)cudaGetLastError();
}

template <int KMAX>
int run_kmax_wh_at_nz(const void* cols, const void* H, const void* W,
                      void* out, int R, int n, int w, int k, int g,
                      cudaStream_t s) {
  auto kern = wh_at_nz_kernel<KMAX>;
  size_t smem;
  int use_smem;
  dim3 grid;
  int e = launch_row_kernel(kern, R, n, k, g, &smem, &use_smem, &grid);
  if (e) return e;
  kern<<<grid, THREADS, smem, s>>>((const int*)cols, (const float*)H,
                                   (const float*)W, (float*)out, n, w, k, g,
                                   use_smem);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// number of (R, blocks) partials kl_beta_err_partials writes
int kl_row_blocks(int R, int n) { return grid_x_for(R, n); }

int kl_h_stats(const void* vals, int vals_bf16, const void* cols,
               const void* H, const void* W, void* numer, int R, int n,
               int w, int k, int g, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 16)
    return run_kmax_h_stats<16>(vals, vals_bf16, cols, H, W, numer, R, n, w,
                                k, g, bf16, s);
  if (k <= 32)
    return run_kmax_h_stats<32>(vals, vals_bf16, cols, H, W, numer, R, n, w,
                                k, g, bf16, s);
  if (k <= 64)
    return run_kmax_h_stats<64>(vals, vals_bf16, cols, H, W, numer, R, n, w,
                                k, g, bf16, s);
  return (int)cudaErrorInvalidValue;
}

int kl_ratio(const void* vals, int vals_bf16, const void* cols, const void* H,
             const void* W, void* out, int R, int n, int w, int k, int g,
             int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 16)
    return run_kmax_ratio<16>(vals, vals_bf16, cols, H, W, out, R, n, w, k,
                              g, bf16, s);
  if (k <= 32)
    return run_kmax_ratio<32>(vals, vals_bf16, cols, H, W, out, R, n, w, k,
                              g, bf16, s);
  if (k <= 64)
    return run_kmax_ratio<64>(vals, vals_bf16, cols, H, W, out, R, n, w, k,
                              g, bf16, s);
  return (int)cudaErrorInvalidValue;
}

int kl_w_numer(const void* rows_t, const void* perm_t, const void* ratio,
               const void* H, void* numer, int R, int n, int w, int k, int g,
               int wt, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 16)
    return run_kmax_w_numer<16>(rows_t, perm_t, ratio, H, numer, R, n, w, k,
                                g, wt, bf16, s);
  if (k <= 32)
    return run_kmax_w_numer<32>(rows_t, perm_t, ratio, H, numer, R, n, w, k,
                                g, wt, bf16, s);
  if (k <= 64)
    return run_kmax_w_numer<64>(rows_t, perm_t, ratio, H, numer, R, n, w, k,
                                g, wt, bf16, s);
  return (int)cudaErrorInvalidValue;
}

int kl_beta_err_partials(const void* vals, const void* cols, const void* H,
                         const void* W, void* partials, int R, int n, int w,
                         int k, int g, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 16)
    return run_kmax_beta_err<16>(vals, cols, H, W, partials, R, n, w, k, g,
                                 s);
  if (k <= 32)
    return run_kmax_beta_err<32>(vals, cols, H, W, partials, R, n, w, k, g,
                                 s);
  if (k <= 64)
    return run_kmax_beta_err<64>(vals, cols, H, W, partials, R, n, w, k, g,
                                 s);
  return (int)cudaErrorInvalidValue;
}

int kl_h_newton_stats(const void* vals, const void* cols, const void* H,
                      const void* W, void* numer, void* hess, int R, int n,
                      int w, int k, int g, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 16)
    return run_kmax_h_newton<16>(vals, cols, H, W, numer, hess, R, n, w, k,
                                 g, s);
  if (k <= 32)
    return run_kmax_h_newton<32>(vals, cols, H, W, numer, hess, R, n, w, k,
                                 g, s);
  if (k <= 64)
    return run_kmax_h_newton<64>(vals, cols, H, W, numer, hess, R, n, w, k,
                                 g, s);
  return (int)cudaErrorInvalidValue;
}

int kl_wh_at_nz(const void* cols, const void* H, const void* W, void* out,
                int R, int n, int w, int k, int g, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 16)
    return run_kmax_wh_at_nz<16>(cols, H, W, out, R, n, w, k, g, s);
  if (k <= 32)
    return run_kmax_wh_at_nz<32>(cols, H, W, out, R, n, w, k, g, s);
  if (k <= 64)
    return run_kmax_wh_at_nz<64>(cols, H, W, out, R, n, w, k, g, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
