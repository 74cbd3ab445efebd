// Chebyshev matmul-only CFConv kernels for Hopper (sm_90a), plain C
// interface for ctypes. Built by flashmd_tpu_torch/ops/_build.py.
//
// Three kernels replace the TPU kernels of
// flashmd_tpu/ops/pallas/cheb_kernel.py on the simulation's main path:
//
//   cheb_fwd     <- _cheb_fwd_kernel
//     out[i] = sum_m c_m * (Ttil_m[i,:] @ x) - w0 * x[i]
//              + w_lin * (low[i,:] @ x),   Ttil_m = (1-z)^2 T_m(z)
//   cheb_bwd_gx  <- _cheb_bwd_kernel (need_gx=True, need_gd=False)
//     gx[i]  = sum_k That_k[i,:] @ (q_k * g) - w0 * g[i]
//              + low[i,:] @ (w_lin * g),   That_k = (1-z) T_k(z)
//   cheb_bwd_gd  <- _cheb_bwd_kernel (need_gx=False, stacked=True)
//     gd[i,j] = (1-z) sum_m T_m(z) ((c2_m * g[i]) . x[j]),  W = gd / d
//     gpos[i] = pos[i] rowsum(W)_i - (W @ pos)_i
//             + pos[i] colsum(W)_i - (W^T @ pos)_i
//
// What bounds them on the H100: at the slice (A=266, F=128, B=3 blocks,
// orders 48/64) the three kernels are matrix work,
// (2B-1)*M1 + B*M2 = 432 order-products of 2*A^2*F FLOPs, about 7.8 GFLOP
// per molecule-step; the bytes they read are pos, x/g and the coefficient
// tables (a few hundred KB per molecule), so they sit far above the
// machine balance and are bound by arithmetic. These first versions do
// that arithmetic as float32 FMA from shared memory (register-tiled 4x4
// per thread), on operands rounded to bf16 in the bf16 tier; they do not
// use the tensor cores yet (mma/wgmma is later work). What the design
// does about the bound: the [A, A] pair and recurrence state never
// reaches device memory -- it lives in registers and a double-buffered
// shared tile per (row tile, column block) -- so every FLOP is spent on
// the products themselves, and the three-term recurrence costs one FMA
// per pair and order against F FMAs of product.
//
// Determinism: each block owns its output rows; the only cross-block sum
// (the column side of the position gradient) is written as per-tile
// partials and summed by a second kernel in a fixed tile order. No
// atomics anywhere, so results are bitwise reproducible run to run.
//
// Precision tiers: bf16 != 0 rounds the product operands to bf16 (round
// to nearest even) at the same places as the plain PyTorch twins in
// ops/cheb_kernel.py; the recurrence and all accumulation stay float32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;

// cheb_fwd / cheb_bwd_gx tiling: 32 destination rows x 128 features per
// block, source atoms in column blocks of 32.
constexpr int RT_TA = 32;
constexpr int RT_TJ = 32;
constexpr int RT_FC = 128;

// cheb_bwd_gd tiling: 64 x 64 pair tiles, features in chunks of 32.
constexpr int GD_T = 64;
constexpr int GD_FC = 32;
constexpr int GD_LD = GD_FC + 1;  // padded row stride: no bank conflicts
constexpr int GD_WLD = GD_T + 1;

__device__ __forceinline__ float rnd_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool BF16>
__device__ __forceinline__ float op(float v) {
  return BF16 ? rnd_bf16(v) : v;
}

// d = sqrt(|p_j - p_i|^2 + 1e-12) from exact per-coordinate differences
// (not a Gram matmul); pairs outside [0, A) are parked at 2 rcut, where
// z = 1 and every (1-z)-weighted basis value is exactly zero.
__device__ __forceinline__ void pair_geom(const float* pi, const float* pj,
                                          bool valid, float rcut,
                                          float d_min, float scale,
                                          float& d, float& z) {
  float r0 = pj[0] - pi[0];
  float r1 = pj[1] - pi[1];
  float r2 = pj[2] - pi[2];
  float dd = sqrtf(r0 * r0 + r1 * r1 + r2 * r2 + 1e-12f);
  if (!valid) dd = 2.0f * rcut;
  d = dd;
  z = fminf(fmaxf((dd - d_min) * scale - 1.0f, -1.0f), 1.0f);
}

// One kernel for cheb_fwd (GX=false: basis (1-z)^2 T_m, operand x,
// coefficient after the product) and cheb_bwd_gx (GX=true: basis
// (1-z) T_k, operand q_k * g formed before the product). Grid:
// (row tiles, feature chunks, molecules).
template <bool BF16, bool GX>
__global__ void __launch_bounds__(THREADS)
cheb_rows_kernel(const float* __restrict__ pos, const float* __restrict__ in,
                 const float* __restrict__ coef,
                 const float* __restrict__ w0,
                 const float* __restrict__ w_lin, float* __restrict__ out,
                 int A, int F, int M, float rcut, float d_min, float scale) {
  __shared__ float t_s[2][RT_TA][RT_TJ];
  __shared__ float in_s[RT_TJ][RT_FC];
  __shared__ float pr_s[RT_TA][3];
  __shared__ float pc_s[RT_TJ][3];

  const int s = blockIdx.z;
  const int r0 = blockIdx.x * RT_TA;
  const int f0 = blockIdx.y * RT_FC;
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  pos += (size_t)s * A * 3;
  in += (size_t)s * A * F;
  out += (size_t)s * A * F;

  int fk[4];
  bool fok[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    fk[k] = f0 + tx + 32 * k;
    fok[k] = fk[k] < F;
  }
  float wl[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    wl[k] = (w_lin != nullptr && fok[k]) ? w_lin[fk[k]] : 0.0f;

  if (tid < RT_TA * 3) {
    int r = tid / 3, c = tid % 3;
    pr_s[r][c] = (r0 + r < A) ? pos[(r0 + r) * 3 + c] : 0.0f;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.0f;

  for (int j0 = 0; j0 < A; j0 += RT_TJ) {
    __syncthreads();  // previous column block's reads are done
    for (int e = tid; e < RT_TJ * RT_FC; e += THREADS) {
      int jj = e / RT_FC, ff = e % RT_FC;
      int j = j0 + jj, f = f0 + ff;
      float v = (j < A && f < F) ? in[(size_t)j * F + f] : 0.0f;
      in_s[jj][ff] = GX ? v : op<BF16>(v);
    }
    if (tid < RT_TJ * 3) {
      int jj = tid / 3, c = tid % 3;
      pc_s[jj][c] = (j0 + jj < A) ? pos[(j0 + jj) * 3 + c] : 0.0f;
    }
    __syncthreads();

    // This thread's 4 pairs of the tile: rows ty + 8e, column tx.
    float z[4], d[4], tp[4], tc[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int r = ty + 8 * e;
      bool valid = (r0 + r < A) && (j0 + tx < A);
      pair_geom(pr_s[r], pc_s[tx], valid, rcut, d_min, scale, d[e], z[e]);
      float u = 1.0f - z[e];
      float seed = GX ? u : u * u;
      tp[e] = seed;
      tc[e] = seed * z[e];
    }

    for (int m = 0; m < M; ++m) {
      float* tb = &t_s[m & 1][0][0];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float tm;
        if (m == 0) {
          tm = tp[e];
        } else if (m == 1) {
          tm = tc[e];
        } else {
          float tn = 2.0f * z[e] * tc[e] - tp[e];
          tp[e] = tc[e];
          tc[e] = tn;
          tm = tn;
        }
        tb[(ty + 8 * e) * RT_TJ + tx] = op<BF16>(tm);
      }
      __syncthreads();
      float cm[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        cm[k] = fok[k] ? coef[(size_t)m * F + fk[k]] : 0.0f;
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) p[i][k] = 0.0f;
#pragma unroll 4
      for (int jj = 0; jj < RT_TJ; ++jj) {
        float b[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float v = in_s[jj][tx + 32 * k];
          b[k] = GX ? op<BF16>(cm[k] * v) : v;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float t = tb[(ty + 8 * i) * RT_TJ + jj];
#pragma unroll
          for (int k = 0; k < 4; ++k) p[i][k] += t * b[k];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          acc[i][k] += GX ? p[i][k] : cm[k] * p[i][k];
    }

    if (w_lin != nullptr) {
      // First-order extrapolation below the fit-domain floor:
      // low = min(d - d_min, 0) off the diagonal, zero outside [0, A).
      float* tb = &t_s[M & 1][0][0];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int r = r0 + ty + 8 * e, j = j0 + tx;
        bool valid = (r < A) && (j < A) && (r != j);
        float low = valid ? fminf(d[e] - d_min, 0.0f) : 0.0f;
        tb[(ty + 8 * e) * RT_TJ + tx] = op<BF16>(low);
      }
      __syncthreads();
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) p[i][k] = 0.0f;
      for (int jj = 0; jj < RT_TJ; ++jj) {
        float b[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float v = in_s[jj][tx + 32 * k];
          b[k] = GX ? op<BF16>(wl[k] * v) : v;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float t = tb[(ty + 8 * i) * RT_TJ + jj];
#pragma unroll
          for (int k = 0; k < 4; ++k) p[i][k] += t * b[k];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          acc[i][k] += GX ? p[i][k] : wl[k] * p[i][k];
    }
  }

  // Self-pair removal: the diagonal (z = -1) contributed w0 * in[i].
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r = r0 + ty + 8 * i;
    if (r >= A) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!fok[k]) continue;
      size_t o = (size_t)r * F + fk[k];
      out[o] = acc[i][k] - w0[fk[k]] * in[o];
    }
  }
}

// Distance gradient of all blocks at once over block-stacked [A, F]
// operands, and its row/column position-gradient sides. Grid: (row
// tiles, molecules). Row sides go to row_part [S, A, 3] (owned rows);
// column sides to col_part [S, n_tiles, A, 3] (one slab per row tile).
template <bool BF16>
__global__ void __launch_bounds__(THREADS)
cheb_gd_kernel(const float* __restrict__ pos, const float* __restrict__ x,
               const float* __restrict__ g, const float* __restrict__ c2,
               float* __restrict__ row_part, float* __restrict__ col_part,
               int A, int F, int M, int n_tiles, float rcut, float d_min,
               float scale) {
  extern __shared__ float smem[];
  float* g_s = smem;                  // [GD_T][GD_LD]
  float* x_s = g_s + GD_T * GD_LD;    // [GD_T][GD_LD]
  float* w_s = x_s + GD_T * GD_LD;    // [GD_T][GD_WLD]
  float* c_s = w_s + GD_T * GD_WLD;   // [M][GD_FC]
  __shared__ float pr_s[GD_T][3];
  __shared__ float pc_s[GD_T][3];

  const int s = blockIdx.y;
  const int rt = blockIdx.x;
  const int r0 = rt * GD_T;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  pos += (size_t)s * A * 3;
  x += (size_t)s * A * F;
  g += (size_t)s * A * F;

  if (tid < GD_T * 3) {
    int r = tid / 3, c = tid % 3;
    pr_s[r][c] = (r0 + r < A) ? pos[(r0 + r) * 3 + c] : 0.0f;
  }
  float rs = 0.0f, wp0 = 0.0f, wp1 = 0.0f, wp2 = 0.0f;

  for (int j0 = 0; j0 < A; j0 += GD_T) {
    __syncthreads();
    if (tid < GD_T * 3) {
      int jj = tid / 3, c = tid % 3;
      pc_s[jj][c] = (j0 + jj < A) ? pos[(j0 + jj) * 3 + c] : 0.0f;
    }
    __syncthreads();

    // This thread's 16 pairs: rows ty + 16i, columns tx + 16k.
    float d[4][4], z[4][4], gd[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int r = ty + 16 * i, j = tx + 16 * k;
        bool valid = (r0 + r < A) && (j0 + j < A);
        pair_geom(pr_s[r], pc_s[j], valid, rcut, d_min, scale, d[i][k],
                  z[i][k]);
        gd[i][k] = 0.0f;
      }

    // gd = sum over feature chunks of sum_m T_m * U_m(chunk); the
    // recurrence restarts per chunk (one FMA per pair and order).
    for (int f0 = 0; f0 < F; f0 += GD_FC) {
      __syncthreads();
      for (int e = tid; e < GD_T * GD_FC; e += THREADS) {
        int rr = e / GD_FC, ff = e % GD_FC, f = f0 + ff;
        int r = r0 + rr, j = j0 + rr;
        g_s[rr * GD_LD + ff] = (r < A && f < F) ? g[(size_t)r * F + f] : 0.0f;
        x_s[rr * GD_LD + ff] =
            (j < A && f < F) ? op<BF16>(x[(size_t)j * F + f]) : 0.0f;
      }
      for (int e = tid; e < M * GD_FC; e += THREADS) {
        int m = e / GD_FC, f = f0 + e % GD_FC;
        c_s[e] = (f < F) ? c2[(size_t)m * F + f] : 0.0f;
      }
      __syncthreads();

      float tp[4][4], tc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          tp[i][k] = 1.0f;
          tc[i][k] = z[i][k];
        }
      for (int m = 0; m < M; ++m) {
        float u[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) u[i][k] = 0.0f;
        const float* cm = c_s + m * GD_FC;
#pragma unroll 4
        for (int ff = 0; ff < GD_FC; ++ff) {
          float cv = cm[ff];
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            a[i] = op<BF16>(cv * g_s[(ty + 16 * i) * GD_LD + ff]);
#pragma unroll
          for (int k = 0; k < 4; ++k) b[k] = x_s[(tx + 16 * k) * GD_LD + ff];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int k = 0; k < 4; ++k) u[i][k] += a[i] * b[k];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float t;
            if (m == 0) {
              t = tp[i][k];
            } else if (m == 1) {
              t = tc[i][k];
            } else {
              t = 2.0f * z[i][k] * tc[i][k] - tp[i][k];
              tp[i][k] = tc[i][k];
              tc[i][k] = t;
            }
            gd[i][k] += t * u[i][k];
          }
      }
    }

    // W = (1-z) gd / d on live pairs: d < rcut, off the diagonal, in range.
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int rr = ty + 16 * i, jj = tx + 16 * k;
        int r = r0 + rr, j = j0 + jj;
        bool keep = (r < A) && (j < A) && (r != j) && (d[i][k] < rcut);
        w_s[rr * GD_WLD + jj] =
            keep ? ((1.0f - z[i][k]) * gd[i][k]) / d[i][k] : 0.0f;
      }
    __syncthreads();
    if (tid < GD_T) {
      // row side, accumulated over column blocks in order
      for (int jj = 0; jj < GD_T; ++jj) {
        float w = w_s[tid * GD_WLD + jj];
        rs += w;
        wp0 += w * pc_s[jj][0];
        wp1 += w * pc_s[jj][1];
        wp2 += w * pc_s[jj][2];
      }
    } else if (tid < 2 * GD_T) {
      // column side of this tile, summed over its rows in order
      int jj = tid - GD_T, j = j0 + jj;
      float cs = 0.0f, q0 = 0.0f, q1 = 0.0f, q2 = 0.0f;
      for (int rr = 0; rr < GD_T; ++rr) {
        float w = w_s[rr * GD_WLD + jj];
        cs += w;
        q0 += w * pr_s[rr][0];
        q1 += w * pr_s[rr][1];
        q2 += w * pr_s[rr][2];
      }
      if (j < A) {
        float* o = col_part + (((size_t)s * n_tiles + rt) * A + j) * 3;
        o[0] = pc_s[jj][0] * cs - q0;
        o[1] = pc_s[jj][1] * cs - q1;
        o[2] = pc_s[jj][2] * cs - q2;
      }
    }
  }
  if (tid < GD_T && r0 + tid < A) {
    float* o = row_part + ((size_t)s * A + r0 + tid) * 3;
    o[0] = pr_s[tid][0] * rs - wp0;
    o[1] = pr_s[tid][1] * rs - wp1;
    o[2] = pr_s[tid][2] * rs - wp2;
  }
}

// gpos = row side + column-side partials summed in tile order 0..n-1.
__global__ void gd_reduce_kernel(const float* __restrict__ row_part,
                                 const float* __restrict__ col_part,
                                 float* __restrict__ gpos, int S, int A,
                                 int n_tiles) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= S * A * 3) return;
  int s = idx / (A * 3);
  int rem = idx - s * A * 3;
  float v = row_part[idx];
  for (int t = 0; t < n_tiles; ++t)
    v += col_part[((size_t)s * n_tiles + t) * A * 3 + rem];
  gpos[idx] = v;
}

inline float fit_scale(float rcut, float d_min) {
  return (float)(2.0 / ((double)rcut - (double)d_min));
}

template <bool GX>
int launch_rows(const float* pos, const float* in, const float* coef,
                const float* w0, const float* w_lin, float* out, int S,
                int A, int F, int M, float rcut, float d_min, int bf16,
                cudaStream_t stream) {
  dim3 grid((A + RT_TA - 1) / RT_TA, (F + RT_FC - 1) / RT_FC, S);
  float scale = fit_scale(rcut, d_min);
  if (bf16)
    cheb_rows_kernel<true, GX><<<grid, THREADS, 0, stream>>>(
        pos, in, coef, w0, w_lin, out, A, F, M, rcut, d_min, scale);
  else
    cheb_rows_kernel<false, GX><<<grid, THREADS, 0, stream>>>(
        pos, in, coef, w0, w_lin, out, A, F, M, rcut, d_min, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cheb_gd_tiles(int A) { return (A + GD_T - 1) / GD_T; }

int cheb_fwd(const float* pos, const float* x, const float* c,
             const float* w0, const float* w_lin, float* out, int S, int A,
             int F, int M, float rcut, float d_min, int bf16, void* stream) {
  return launch_rows<false>(pos, x, c, w0, w_lin, out, S, A, F, M, rcut,
                            d_min, bf16, (cudaStream_t)stream);
}

int cheb_bwd_gx(const float* pos, const float* g, const float* q,
                const float* w0, const float* w_lin, float* gx, int S, int A,
                int F, int M, float rcut, float d_min, int bf16,
                void* stream) {
  return launch_rows<true>(pos, g, q, w0, w_lin, gx, S, A, F, M, rcut,
                           d_min, bf16, (cudaStream_t)stream);
}

int cheb_bwd_gd(const float* pos, const float* x, const float* g,
                const float* c2, float* row_part, float* col_part,
                float* gpos, int S, int A, int F, int M, float rcut,
                float d_min, int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int n_tiles = cheb_gd_tiles(A);
  size_t smem =
      sizeof(float) * (2 * GD_T * GD_LD + GD_T * GD_WLD + (size_t)M * GD_FC);
  cudaError_t err;
  if (bf16)
    err = cudaFuncSetAttribute(cheb_gd_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  else
    err = cudaFuncSetAttribute(cheb_gd_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_tiles, S);
  float scale = fit_scale(rcut, d_min);
  if (bf16)
    cheb_gd_kernel<true><<<grid, THREADS, smem, st>>>(
        pos, x, g, c2, row_part, col_part, A, F, M, n_tiles, rcut, d_min,
        scale);
  else
    cheb_gd_kernel<false><<<grid, THREADS, smem, st>>>(
        pos, x, g, c2, row_part, col_part, A, F, M, n_tiles, rcut, d_min,
        scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int total = S * A * 3;
  gd_reduce_kernel<<<(total + 255) / 256, 256, 0, st>>>(row_part, col_part,
                                                        gpos, S, A, n_tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
