// Dense all-pairs exact-filter CFConv kernels for Hopper (sm_90a), plain C
// interface for ctypes. Built by flashmd_tpu_torch/ops/_build.py. The tile
// layout and the device code shared with the neighbour-matrix kernels are in
// cfconv_tile.cuh.
//
// Two kernels replace the TPU kernels of
// flashmd_tpu/ops/pallas/cfconv_dense.py, batched over S molecules:
//
//   dense_cfconv_fwd  <- _fwd_kernel (:126)
//     out[i]  = sum_{j != i, j < A} W_ij * cut_ij * x[j]
//   dense_cfconv_bwd  <- _bwd_kernel (:147), two launches:
//     dense_bwd_kernel (fp32), dense_bwd_mma_kernel (bf16):
//                        gx[i] = sum_{j != i} W_ij * cut_ij * g[j] and
//                        gd[i, j] = d(g_i . out_i)/d d_ij for every ordered
//                        pair (the MLP backward of the cotangent g_i x_j)
//     dense_gpos_kernel: gpos[i] = -sum_{j != i} (gd_ij + gd_ji) u_ij,
//                        u_ij = (p_j - p_i) / d_ij
//
// with d = sqrt(max(|p_j - p_i|^2, 1e-12)), cut = 0.5 (cos(pi d / rc) + 1)
// [d < rc], rbf = exp(coeff (d - offset)^2) cut, W = tanh(rbf @ w0 + b0) @ w1
// (_pair_geometry :67, _filter_mlp3 :97).
//
// What bounds them on the H100: every pair runs a two-layer filter MLP,
// R*F + F*F = 22,784 multiply-adds at R = 50, F = 128 (twice that in the
// backward), against a few hundred bytes of input per molecule: they are
// bound by arithmetic, never by memory. The forward (both tiers) and the
// fp32 backward do the arithmetic as float32 FMA from shared memory on
// CUDA cores (operands rounded to bf16 in the forward's bf16 tier); the
// bf16 backward takes its four products on the tensor cores over the live
// pairs only (dense_bwd_mma_kernel, its note below). What the CUDA-core
// design does about the bound:
//   - the [pairs, F] MLP activations never reach device memory: a block
//     owns 4 destination rows and walks the source atoms in chunks of 16,
//     so one chunk is a 64-pair tile whose activations live in registers
//     (4 pairs x 8 features per thread) and one shared [F, 64] tile;
//   - w0 and w1 are loaded into shared memory once per block, with padded
//     row strides so both the products and their transposes (backward)
//     read them without bank conflicts;
//   - a chunk whose 64 pairs all lie at d >= rc (or are masked) adds
//     exactly zero (cut and dcut vanish there) and is skipped whole.
//
// Determinism: every block (bf16 backward: every warp) owns its output
// rows. W and cut depend only on d_ij, which is bitwise symmetric, so gx[i]
// is the forward with x replaced by g. The reference adds gd_ij to row j
// across grid steps; here the first kernel writes gd [S, A, A] (36 MB at
// S = 128, A = 266) and the second sums row i of gd + gd^T in a fixed
// order. No sum crosses blocks,
// there are no atomics, and results are bitwise reproducible. Each ordered
// pair runs one MLP backward, as in the reference, so the bf16 roundings
// fall on the same values (g_i x_j cut and gt0 of each ordered pair).
//
// Precision tiers: bf16 != 0 rounds the operands of the four products to
// bf16 (round to nearest even) where the reference and the plain PyTorch
// twins in ops/cfconv_dense.py do: rbf and w0, a0 and w1 (forward);
// g_i x_j cut and w1, gt0 and w0 (backward). tanh, the geometry and all
// sums stay float32.

#include "cfconv_tile.cuh"

namespace {

// Dynamic shared memory, in floats.
constexpr int FWD_FLOATS = W_FLOATS + RMAX * LDA + F * LDA + COLS * F;
constexpr int BWD_FLOATS = W_FLOATS + 2 * F * LDA + 2 * COLS * F + ROWS * F;
constexpr int GPOS_ROWS = THREADS / 32;  // one warp per row of gpos

// Forward. Grid: (row tiles of ROWS, molecules). Thread (pg, fg) holds
// pairs p0 = 4 pg .. p0 + 3 (row pg / 4, columns 4 (pg % 4) + i) and
// features fg + 16 c.
template <bool BF16>
__global__ void __launch_bounds__(THREADS, 1)
dense_fwd_kernel(const float* __restrict__ pos, const float* __restrict__ x,
                 const float* __restrict__ w0, const float* __restrict__ b0,
                 const float* __restrict__ w1,
                 const float* __restrict__ offset,
                 const float* __restrict__ coeff_p, float* __restrict__ out,
                 int A, int R, float rcut, float arg_scale,
                 float dcut_scale) {
  extern __shared__ __align__(16) float smem[];
  float* w0_s = smem;                  // [RMAX][LDW]
  float* w1_s = w0_s + RMAX * LDW;     // [F][LDW]
  float* rbf_s = w1_s + F * LDW;       // [RMAX][LDA]
  float* a_s = rbf_s + RMAX * LDA;     // [F][LDA]
  float* in_s = a_s + F * LDA;         // [COLS][F]
  __shared__ float b0_s[F], off_s[RMAX];
  __shared__ float pr_s[ROWS][3], pc_s[COLS][3], d_s[NP], cut_s[NP];

  const int s = blockIdx.y;
  const int r0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x;
  const int fg = tid & 15, pg = tid >> 4, p0 = 4 * pg;
  pos += (size_t)s * A * 3;
  x += (size_t)s * A * F;
  out += (size_t)s * A * F;
  const float coeff = *coeff_p;

  load_weights<BF16>(w0, b0, w1, offset, R, w0_s, w1_s, b0_s, off_s);
  if (tid < ROWS * 3) {
    int r = tid / 3, c = tid % 3;
    pr_s[r][c] = r0 + r < A ? pos[(r0 + r) * 3 + c] : 0.0f;
  }
  float acc[FPT];
#pragma unroll
  for (int c = 0; c < FPT; ++c) acc[c] = 0.0f;

  for (int j0 = 0; j0 < A; j0 += COLS) {
    __syncthreads();  // the previous chunk is done with every tile
    if (tid < COLS * 3) {
      int jj = tid / 3, c = tid % 3;
      pc_s[jj][c] = j0 + jj < A ? pos[(j0 + jj) * 3 + c] : 0.0f;
    }
    for (int e = tid; e < COLS * F; e += THREADS) {
      int j = j0 + e / F;
      in_s[e] = j < A ? x[(size_t)j * F + e % F] : 0.0f;
    }
    __syncthreads();
    bool live = false;
    if (tid < NP) {
      int i = r0 + tid / COLS, j = j0 + tid % COLS;
      float d, cut, dcut, rel[3];
      live = pair_geom(pr_s[tid / COLS], pc_s[tid % COLS],
                       i < A && j < A && i != j, rcut, arg_scale, dcut_scale,
                       d, cut, dcut, rel);
      d_s[tid] = d;
      cut_s[tid] = cut;
    }
    if (!__syncthreads_or(live)) continue;  // the chunk adds exactly zero

    for (int e = tid; e < R * NP; e += THREADS) {
      int r = e / NP, p = e % NP;
      float dr = d_s[p] - off_s[r];
      rbf_s[r * LDA + p] = op<BF16>(expf(coeff * (dr * dr)) * cut_s[p]);
    }
    __syncthreads();
    float t[4][FPT] = {};
    gemm_tile<FPT>(rbf_s, w0_s + fg, R, LDW, 1, p0, t);
#pragma unroll
    for (int c = 0; c < FPT; ++c) {
      int f = fg + 16 * c;
#pragma unroll
      for (int i = 0; i < 4; ++i) t[i][c] = op<BF16>(tanhf(t[i][c] + b0_s[f]));
      store4(a_s + f * LDA + p0, t, c);
    }
    __syncthreads();
    float w[4][FPT] = {};
    gemm_tile<FPT>(a_s, w1_s + fg, F, LDW, 1, p0, w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int p = p0 + i;
      float cutp = cut_s[p];
      const float* xin = in_s + (p % COLS) * F + fg;
#pragma unroll
      for (int c = 0; c < FPT; ++c) acc[c] += (w[i][c] * cutp) * xin[16 * c];
    }
  }

  // Row sums over the 4 column groups of each row, in order.
  __syncthreads();
  float* red = a_s;  // [16 pair groups][F]
#pragma unroll
  for (int c = 0; c < FPT; ++c) red[pg * F + fg + 16 * c] = acc[c];
  __syncthreads();
  for (int e = tid; e < ROWS * F; e += THREADS) {
    int rr = e / F, f = e % F;
    if (r0 + rr >= A) continue;
    const float* q = red + rr * 4 * F + f;
    out[(size_t)(r0 + rr) * F + f] = ((q[0] + q[F]) + q[2 * F]) + q[3 * F];
  }
}

// Backward, pass 1 at fp32: recompute the forward chunk, then gx (GX) of
// this block's rows and gd of its ordered pairs (i in the block, every j)
// into gd [S, A, A]. Same grid and thread layout as the forward.
template <bool GX>
__global__ void __launch_bounds__(THREADS, 1)
dense_bwd_kernel(const float* __restrict__ pos, const float* __restrict__ x,
                 const float* __restrict__ g, const float* __restrict__ w0,
                 const float* __restrict__ b0, const float* __restrict__ w1,
                 const float* __restrict__ offset,
                 const float* __restrict__ coeff_p, float* __restrict__ gd,
                 float* __restrict__ gx, int A, int R, float rcut,
                 float arg_scale, float dcut_scale) {
  extern __shared__ __align__(16) float smem[];
  float* w0_s = smem;                  // [RMAX][LDW]
  float* w1_s = w0_s + RMAX * LDW;     // [F][LDW]
  float* a_s = w1_s + F * LDW;         // [F][LDA]: a0, then gt0
  float* p_s = a_s + F * LDA;          // [F][LDA]: rbf, then g_i x_j cut
  float* xc_s = p_s + F * LDA;         // [COLS][F]
  float* gc_s = xc_s + COLS * F;       // [COLS][F]
  float* gr_s = gc_s + COLS * F;       // [ROWS][F]
  __shared__ float b0_s[F], off_s[RMAX];
  __shared__ float pr_s[ROWS][3], pc_s[COLS][3];
  __shared__ float d_s[NP], cut_s[NP], dcut_s[NP];

  const int s = blockIdx.y;
  const int r0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x;
  const int fg = tid & 15, pg = tid >> 4, p0 = 4 * pg, row = pg >> 2;
  pos += (size_t)s * A * 3;
  x += (size_t)s * A * F;
  g += (size_t)s * A * F;
  gd += (size_t)s * A * A;
  const float coeff = *coeff_p;

  load_weights<false>(w0, b0, w1, offset, R, w0_s, w1_s, b0_s, off_s);
  if (tid < ROWS * 3) {
    int r = tid / 3, c = tid % 3;
    pr_s[r][c] = r0 + r < A ? pos[(r0 + r) * 3 + c] : 0.0f;
  }
  for (int e = tid; e < ROWS * F; e += THREADS) {
    int i = r0 + e / F;
    gr_s[e] = i < A ? g[(size_t)i * F + e % F] : 0.0f;
  }
  float accgx[FPT];
#pragma unroll
  for (int c = 0; c < FPT; ++c) accgx[c] = 0.0f;

  for (int j0 = 0; j0 < A; j0 += COLS) {
    __syncthreads();
    if (tid < COLS * 3) {
      int jj = tid / 3, c = tid % 3;
      pc_s[jj][c] = j0 + jj < A ? pos[(j0 + jj) * 3 + c] : 0.0f;
    }
    for (int e = tid; e < COLS * F; e += THREADS) {
      int j = j0 + e / F;
      xc_s[e] = j < A ? x[(size_t)j * F + e % F] : 0.0f;
      gc_s[e] = j < A ? g[(size_t)j * F + e % F] : 0.0f;
    }
    __syncthreads();
    bool live = false;
    if (tid < NP) {
      int i = r0 + tid / COLS, j = j0 + tid % COLS;
      float d, cut, dcut, rel[3];
      live = pair_geom(pr_s[tid / COLS], pc_s[tid % COLS],
                       i < A && j < A && i != j, rcut, arg_scale, dcut_scale,
                       d, cut, dcut, rel);
      d_s[tid] = d;
      cut_s[tid] = cut;
      dcut_s[tid] = dcut;
    }
    if (!__syncthreads_or(live)) {  // the chunk adds exactly zero
      int i = r0 + tid / COLS, j = j0 + tid % COLS;
      if (tid < NP && i < A && j < A) gd[(size_t)i * A + j] = 0.0f;
      continue;
    }

    float* rbf_s = p_s;
    for (int e = tid; e < R * NP; e += THREADS) {
      int r = e / NP, p = e % NP;
      float dr = d_s[p] - off_s[r];
      rbf_s[r * LDA + p] = expf(coeff * (dr * dr)) * cut_s[p];
    }
    __syncthreads();
    // Forward recompute; a0 stays in registers unrounded for gt0.
    float a0[4][FPT] = {};
    gemm_tile<FPT>(rbf_s, w0_s + fg, R, LDW, 1, p0, a0);
#pragma unroll
    for (int c = 0; c < FPT; ++c) {
      int f = fg + 16 * c;
#pragma unroll
      for (int i = 0; i < 4; ++i) a0[i][c] = tanhf(a0[i][c] + b0_s[f]);
      store4(a_s + f * LDA + p0, a0, c);
    }
    __syncthreads();  // rbf reads done, a0 tile complete
    float w[4][FPT] = {};
    gemm_tile<FPT>(a_s, w1_s + fg, F, LDW, 1, p0, w);

    // gx, s_cut = sum_f g_i W x_j and the MLP cotangent g_i x_j cut (into
    // w's registers; reference gw, cfconv_dense.py:181).
    float sc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int p = p0 + i;
      float cutp = cut_s[p];
      const float* xj = xc_s + (p % COLS) * F + fg;
      const float* gj = gc_s + (p % COLS) * F + fg;
      const float* gi = gr_s + row * F + fg;
      sc[i] = 0.0f;
#pragma unroll
      for (int c = 0; c < FPT; ++c) {
        float xjv = xj[16 * c], giv = gi[16 * c];
        if (GX) accgx[c] += (w[i][c] * cutp) * gj[16 * c];
        sc[i] += (giv * w[i][c]) * xjv;
        w[i][c] = (giv * xjv) * cutp;
      }
    }
#pragma unroll
    for (int c = 0; c < FPT; ++c) store4(p_s + (fg + 16 * c) * LDA + p0, w, c);
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i] = sum16(sc[i]);
    __syncthreads();  // cotangent tile complete; a0 tile reads done

    // ga0 = (g_i x_j cut) @ w1^T, gt0 = ga0 (1 - a0^2) -> a_s.
    float ga[4][FPT] = {};
    gemm_tile<FPT>(p_s, w1_s + fg * LDW, F, 1, LDW, p0, ga);
#pragma unroll
    for (int c = 0; c < FPT; ++c) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ga[i][c] = ga[i][c] * (1.0f - a0[i][c] * a0[i][c]);
      store4(a_s + (fg + 16 * c) * LDA + p0, ga, c);
    }
    __syncthreads();

    // grbf = gt0 @ w0^T over r = fg + 16 cr, then the distance gradient.
    float gr[4][4] = {};
    gemm_tile<4>(a_s, w0_s + fg * LDW, F, 1, LDW, p0, gr);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float dp = d_s[p0 + i];
      float sg = 0.0f, se = 0.0f;
#pragma unroll
      for (int cr = 0; cr < 4; ++cr) {
        int r = fg + 16 * cr;
        if (r < R) {
          float dr = dp - off_s[r];
          float ge = gr[i][cr] * expf(coeff * (dr * dr));
          se += ge;
          sg += ge * dr;
        }
      }
      sg = sum16(sg);
      se = sum16(se);
      int p = p0 + i, ii = r0 + p / COLS, j = j0 + p % COLS;
      if (fg == 0 && ii < A && j < A)
        gd[(size_t)ii * A + j] =
            cut_s[p] * (2.0f * coeff) * sg + (sc[i] + se) * dcut_s[p];
    }
  }

  if (GX) {
    __syncthreads();
    float* red = a_s;
#pragma unroll
    for (int c = 0; c < FPT; ++c) red[pg * F + fg + 16 * c] = accgx[c];
    __syncthreads();
    gx += (size_t)s * A * F;
    for (int e = tid; e < ROWS * F; e += THREADS) {
      int rr = e / F, f = e % F;
      if (r0 + rr >= A) continue;
      const float* q = red + rr * 4 * F + f;
      gx[(size_t)(r0 + rr) * F + f] = ((q[0] + q[F]) + q[2 * F]) + q[3 * F];
    }
  }
}

// Backward, pass 1 at bf16, on the tensor cores: gd of every ordered pair
// of a work item's rows (zero where dead) and, with GX, gx of those rows.
//
// Design. A persistent grid (one block of DM_WARPS warps per SM) stages w0
// and w1 once as bf16 in shared memory; each warp then owns work items of
// DM_RW rows of one molecule and walks them alone:
// 1. It scans the rows' partners 32 at a time (warp vote and prefix) and
//    appends the live pairs (d < rc, i != j, in range), in row-major order,
//    to a ring in shared memory, writing gd = 0 for every other pair.
// 2. Each 16 pairs of the ring are one M tile of the filter MLP, so only
//    the last tile of an item carries padding. Four mma.m16n8k16 products
//    per tile: a0 = tanh(bf16(rbf) bf16(w0) + b0) (K = R padded to 16),
//    ga0 = bf16(g_i x_j cut) bf16(w1)^T, grbf = bf16(gt0) bf16(w0)^T with
//    gt0 = ga0 (1 - a0^2), W = bf16(a0) bf16(w1). Each product's
//    accumulators are the next one's A fragments (mlp_afrag); the float32
//    a0 waits for (1 - a0^2) and bf16(a0) in lane-private shared memory,
//    so that ga0's 64 accumulators fit without spills. The bf16 roundings
//    fall where they do in the twin and the reference, each ordered pair
//    runs its own MLP backward, and tanh, the geometry, s_cut and the sums
//    stay float32.
// 3. gd of the tile's pairs from grbf, s_cut and the cutoff, written to
//    the [S, A, A] workspace; with GX, W cut is staged per pair and
//    (W cut) g_j summed into the item's gx rows in ring order (a running
//    sum per row segment, one lane per 4 features, g_j read coalesced).
//    The item's gx rows are owned by its warp: no atomics, bitwise
//    reproducible.
constexpr int DM_WARPS = 8;
constexpr int DM_RW = 4;       // rows per work item
constexpr int DM_RING = 64;    // live-pair ring per warp (a power of two)
constexpr int DM_VLD = F + 4;  // row stride of the per-pair gx staging
// per warp, in floats: gx staging [16][DM_VLD], g and gx rows [DM_RW][F]
// each, the ring, the float32 a0 [16 n-tiles][32 lanes][4]
constexpr int DM_WARP_FLOATS = 16 * DM_VLD + 2 * DM_RW * F + DM_RING + 16 * F;
constexpr int DM_SMEM = 2 * (RMAX + F) * LDB + 4 * (F + RMAX) +
                        4 * DM_WARPS * DM_WARP_FLOATS;  // bytes

// One M tile: the ring's entries head .. head + nv - 1 (nv <= 16) of the
// item at row r0. ring entries are (row - r0) << 16 | j.
template <bool GX>
__device__ __forceinline__ void dense_mma_tile(
    const int* ring, int head, int nv, int r0, const float* pos,
    const float* x, const float* g, const float* gi_s, float* v_s,
    float* gx_s, float4* a0_s, float* gd, const __nv_bfloat16* w0_b,
    const __nv_bfloat16* w1_b, const float* b0_s, const float* off_s, int A,
    int R, float coeff, float rcut, float arg_scale, float dcut_scale,
    int lane) {
  const int gq = lane >> 2, tq = lane & 3;
  const int nks = (R + 15) >> 4;  // k-steps over R, n-tile pairs over R
  // this lane's pairs: tile rows gq (h = 0) and gq + 8 (h = 1)
  int rr[2], jj[2];
  float d[2], cut[2], dcut[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int t = gq + 8 * h;
    bool ok = t < nv;
    int ent = ok ? ring[(head + t) & (DM_RING - 1)] : 0;
    rr[h] = ent >> 16;
    jj[h] = ent & 0xffff;
    float rel[3];
    pair_geom(pos + (r0 + rr[h]) * 3, pos + jj[h] * 3, ok, rcut, arg_scale,
              dcut_scale, d[h], cut[h], dcut[h], rel);
  }

  // a0 = tanh(bf16(rbf) @ bf16(w0) + b0), float32
  float a0[16][4] = {};
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if (ks >= nks) break;
    unsigned af[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int h = i & 1, r = 16 * ks + 8 * (i >> 1) + 2 * tq;
      float v[2];
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        float dr = d[h] - off_s[r + b];
        v[b] = r + b < R ? expf(coeff * (dr * dr)) * cut[h] : 0.0f;
      }
      af[i] = pack_bf16x2(v[0], v[1]);
    }
    mma_kstep<true>(a0, af, w0_b, 16 * ks, 8, lane);
  }
  // the float32 a0 waits in this lane's slots of a0_s for (1 - a0^2) and
  // bf16(a0), out of the registers that ga0 needs
  a0_s += lane;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const float2 b = *reinterpret_cast<const float2*>(b0_s + 8 * nt + 2 * tq);
    a0[nt][0] = tanhf(a0[nt][0] + b.x);
    a0[nt][1] = tanhf(a0[nt][1] + b.y);
    a0[nt][2] = tanhf(a0[nt][2] + b.x);
    a0[nt][3] = tanhf(a0[nt][3] + b.y);
    a0_s[32 * nt] = make_float4(a0[nt][0], a0[nt][1], a0[nt][2], a0[nt][3]);
  }

  // ga0 = bf16(g_i x_j cut) @ bf16(w1)^T (reference gw, cfconv_dense.py:181);
  // the k-steps not unrolled, x_j and g_i loaded one k-step ahead
  // (unrolled, every k-step's loads were hoisted and spilled)
  float ga[16][4] = {};
  float2 xv[4], gv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int h = i & 1, k = 8 * (i >> 1) + 2 * tq;
    xv[i] = *reinterpret_cast<const float2*>(x + (size_t)jj[h] * F + k);
    gv[i] = *reinterpret_cast<const float2*>(gi_s + rr[h] * F + k);
  }
#pragma unroll 1
  for (int ks = 0; ks < 8; ++ks) {
    unsigned af[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float c = cut[i & 1];
      af[i] = pack_bf16x2((gv[i].x * xv[i].x) * c, (gv[i].y * xv[i].y) * c);
    }
    if (ks + 1 < 8) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int h = i & 1, k = 16 * (ks + 1) + 8 * (i >> 1) + 2 * tq;
        xv[i] = *reinterpret_cast<const float2*>(x + (size_t)jj[h] * F + k);
        gv[i] = *reinterpret_cast<const float2*>(gi_s + rr[h] * F + k);
      }
    }
    mma_kstep<false>(ga, af, w1_b, 16 * ks, 8, lane);
  }
  // gt0 = ga0 (1 - a0^2) into ga's registers, bf16(gt0) as the A
  // fragments of grbf's product
  unsigned gt[8][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const float4 a = a0_s[32 * nt];
    ga[nt][0] *= 1.0f - a.x * a.x;
    ga[nt][1] *= 1.0f - a.y * a.y;
    ga[nt][2] *= 1.0f - a.z * a.z;
    ga[nt][3] *= 1.0f - a.w * a.w;
  }
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) mlp_afrag(gt[ks], ga, ks);

  // grbf = bf16(gt0) @ bf16(w0)^T, then this lane's r of the rbf chain
  float gr[8][4] = {};
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
    mma_kstep<false>(gr, gt[ks], w0_b, 16 * ks, nks, lane);
  float sg[2] = {0.0f, 0.0f}, se[2] = {0.0f, 0.0f};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int r = 8 * nt + 2 * tq + (e & 1), h = e >> 1;
      if (r < R) {
        float dr = d[h] - off_s[r];
        float ge = gr[nt][e] * expf(coeff * (dr * dr));
        se[h] += ge;
        sg[h] += ge * dr;
      }
    }

  // W = bf16(a0) @ bf16(w1) in two halves of its columns, each consumed
  // into s_cut = sum_f g_i W x_j and the gx terms before the next
  float sc[2] = {0.0f, 0.0f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float w[8][4] = {};
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const float4 lo = a0_s[32 * (2 * ks)], hi = a0_s[32 * (2 * ks + 1)];
      const unsigned ap[4] = {pack_bf16x2(lo.x, lo.y), pack_bf16x2(lo.z, lo.w),
                              pack_bf16x2(hi.x, hi.y), pack_bf16x2(hi.z, hi.w)};
      mma_kstep<true>(w, ap, w1_b + 64 * half, 16 * ks, 4, lane);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int f = 64 * half + 8 * nt + 2 * tq;
        const float2 xv =
            *reinterpret_cast<const float2*>(x + (size_t)jj[h] * F + f);
        const float2 gi =
            *reinterpret_cast<const float2*>(gi_s + rr[h] * F + f);
        float w0v = w[nt][2 * h], w1v = w[nt][2 * h + 1];
        sc[h] += (gi.x * w0v) * xv.x;
        sc[h] += (gi.y * w1v) * xv.y;
        if (GX)
          *reinterpret_cast<float2*>(v_s + (gq + 8 * h) * DM_VLD + f) =
              make_float2(w0v * cut[h], w1v * cut[h]);
      }
  }

  // gd of the lane's pairs: sums over the quad's columns, then the pair
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sc[h] += __shfl_xor_sync(0xffffffffu, sc[h], off);
      se[h] += __shfl_xor_sync(0xffffffffu, se[h], off);
      sg[h] += __shfl_xor_sync(0xffffffffu, sg[h], off);
    }
  if (tq == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (gq + 8 * h < nv)
        gd[(size_t)(r0 + rr[h]) * A + jj[h]] =
            cut[h] * (2.0f * coeff) * sg[h] + (sc[h] + se[h]) * dcut[h];
  }

  if (GX) {
    // gx rows += (W cut) g_j, pairs in ring order: a running sum per row
    // segment, lane l on features 4 l .. 4 l + 3 (g_j one float4 per lane)
    __syncwarp();
    float4 run = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int cur = ring[head & (DM_RING - 1)] >> 16;
#pragma unroll 1  // unrolled, it pushes this instantiation into spills
    for (int t = 0; t < nv; ++t) {
      int ent = ring[(head + t) & (DM_RING - 1)], r = ent >> 16;
      if (r != cur) {
        float4* o = reinterpret_cast<float4*>(gx_s + cur * F) + lane;
        float4 a = *o;
        *o = make_float4(a.x + run.x, a.y + run.y, a.z + run.z, a.w + run.w);
        run = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        cur = r;
      }
      const float4 v = reinterpret_cast<const float4*>(v_s + t * DM_VLD)[lane];
      const float4 gj =
          reinterpret_cast<const float4*>(g + (size_t)(ent & 0xffff) * F)[lane];
      run.x += __fmul_rn(v.x, gj.x);
      run.y += __fmul_rn(v.y, gj.y);
      run.z += __fmul_rn(v.z, gj.z);
      run.w += __fmul_rn(v.w, gj.w);
    }
    float4* o = reinterpret_cast<float4*>(gx_s + cur * F) + lane;
    float4 a = *o;
    *o = make_float4(a.x + run.x, a.y + run.y, a.z + run.z, a.w + run.w);
  }
  __syncwarp();  // the ring and v_s are read before they are written again
}

template <bool GX>
__global__ void __launch_bounds__(DM_WARPS * 32, 1)
dense_bwd_mma_kernel(const float* __restrict__ pos,
                     const float* __restrict__ x, const float* __restrict__ g,
                     const float* __restrict__ w0,
                     const float* __restrict__ b0,
                     const float* __restrict__ w1,
                     const float* __restrict__ offset,
                     const float* __restrict__ coeff_p, float* __restrict__ gd,
                     float* __restrict__ gx, int S, int A, int R, float rcut,
                     float arg_scale, float dcut_scale) {
  extern __shared__ float4 dm_smem4[];
  __nv_bfloat16* w0_b = reinterpret_cast<__nv_bfloat16*>(dm_smem4);
  __nv_bfloat16* w1_b = w0_b + RMAX * LDB;                  // [F][LDB]
  float* b0_s = reinterpret_cast<float*>(w1_b + F * LDB);  // [F]
  float* off_s = b0_s + F;                                  // [RMAX]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* v_s = off_s + RMAX + warp * DM_WARP_FLOATS;  // [16][DM_VLD]
  float* gi_s = v_s + 16 * DM_VLD;                    // [DM_RW][F]
  float* gx_s = gi_s + DM_RW * F;                     // [DM_RW][F]
  int* ring = reinterpret_cast<int*>(gx_s + DM_RW * F);  // [DM_RING]
  float4* a0_s = reinterpret_cast<float4*>(ring + DM_RING);
  const float coeff = *coeff_p;

  stage_weights_bf16(w0, b0, w1, offset, R, w0_b, w1_b, b0_s, off_s);
  __syncthreads();

  const int n_groups = (A + DM_RW - 1) / DM_RW;
  const int n_items = S * n_groups;
  for (int item = blockIdx.x * DM_WARPS + warp; item < n_items;
       item += gridDim.x * DM_WARPS) {
    const int s = item / n_groups, r0 = (item % n_groups) * DM_RW;
    const float* ps = pos + (size_t)s * A * 3;
    const float* xs = x + (size_t)s * A * F;
    const float* gs = g + (size_t)s * A * F;
    float* gds = gd + (size_t)s * A * A;
    for (int e = lane; e < DM_RW * F; e += 32) {
      int i = r0 + e / F;
      gi_s[e] = i < A ? gs[(size_t)i * F + e % F] : 0.0f;
      gx_s[e] = 0.0f;
    }
    __syncwarp();

    // 1-3. The rows' live pairs through the ring, 16 at a time.
    int head = 0, tail = 0;
    for (int rr = 0; rr < DM_RW && r0 + rr < A; ++rr) {
      const int i = r0 + rr;
      const float* pi = ps + i * 3;
      for (int jb = 0; jb < A; jb += 32) {
        int j = jb + lane;
        bool live = false;
        if (j < A) {
          float d, cut, dcut, rel[3];
          live = pair_geom(pi, ps + j * 3, j != i, rcut, arg_scale,
                           dcut_scale, d, cut, dcut, rel);
          if (!live) gds[(size_t)i * A + j] = 0.0f;
        }
        unsigned vote = __ballot_sync(0xffffffffu, live);
        if (live)
          ring[(tail + __popc(vote & ((1u << lane) - 1u))) & (DM_RING - 1)] =
              (rr << 16) | j;
        tail += __popc(vote);
        __syncwarp();
        for (; tail - head >= 16; head += 16)
          dense_mma_tile<GX>(ring, head, 16, r0, ps, xs, gs, gi_s, v_s, gx_s,
                             a0_s, gds, w0_b, w1_b, b0_s, off_s, A, R, coeff,
                             rcut, arg_scale, dcut_scale, lane);
      }
    }
    if (tail > head)
      dense_mma_tile<GX>(ring, head, tail - head, r0, ps, xs, gs, gi_s, v_s,
                         gx_s, a0_s, gds, w0_b, w1_b, b0_s, off_s, A, R, coeff,
                         rcut, arg_scale, dcut_scale, lane);
    if (GX) {
      __syncwarp();
      float* gxs = gx + (size_t)s * A * F;
      for (int e = 4 * lane; e < DM_RW * F; e += 128) {
        int i = r0 + e / F;
        if (i < A)
          *reinterpret_cast<float4*>(gxs + (size_t)i * F + e % F) =
              *reinterpret_cast<const float4*>(gx_s + e);
      }
    }
    __syncwarp();  // gi_s and gx_s are read before the next item writes
  }
}

// Backward, pass 2: gpos[i] = -sum_j (gd_ij + gd_ji) u_ij. Grid: (row
// tiles of GPOS_ROWS, molecules); warp w owns row i = GPOS_ROWS tile + w,
// its lanes stride over j and the shuffle tree sums them in a fixed order.
// gd is zero on the diagonal, the padding and every pair at d >= rc.
__global__ void __launch_bounds__(THREADS)
dense_gpos_kernel(const float* __restrict__ pos, const float* __restrict__ gd,
                  float* __restrict__ gpos, int A) {
  const int s = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * GPOS_ROWS + (threadIdx.x >> 5);
  if (i >= A) return;  // whole warps: the shuffles below stay full
  pos += (size_t)s * A * 3;
  gd += (size_t)s * A * A;
  const float pi0 = pos[i * 3], pi1 = pos[i * 3 + 1], pi2 = pos[i * 3 + 2];
  float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
  for (int j = lane; j < A; j += 32) {
    float r0 = pos[j * 3] - pi0, r1 = pos[j * 3 + 1] - pi1,
          r2 = pos[j * 3 + 2] - pi2;
    float d = sqrtf(fmaxf(r0 * r0 + r1 * r1 + r2 * r2, 1e-12f));
    float v = gd[(size_t)i * A + j] + gd[(size_t)j * A + i];
    g0 += v * (r0 / d);
    g1 += v * (r1 / d);
    g2 += v * (r2 / d);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    g0 += __shfl_xor_sync(0xffffffffu, g0, o);
    g1 += __shfl_xor_sync(0xffffffffu, g1, o);
    g2 += __shfl_xor_sync(0xffffffffu, g2, o);
  }
  if (lane == 0) {
    float* out = gpos + ((size_t)s * A + i) * 3;
    out[0] = -g0;
    out[1] = -g1;
    out[2] = -g2;
  }
}

// The tensor-core backward on a persistent grid: one block per SM, or
// fewer when there are fewer work items.
template <typename K>
cudaError_t launch_mma(K kernel, int S, int A, cudaStream_t stream,
                       void** args) {
  int dev, n_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DM_SMEM);
  if (err != cudaSuccess) return err;
  int warps = S * ((A + DM_RW - 1) / DM_RW);
  int blocks = (warps + DM_WARPS - 1) / DM_WARPS;
  err = cudaLaunchKernel((const void*)kernel, dim3(blocks < n_sm ? blocks
                                                                  : n_sm),
                         dim3(DM_WARPS * 32), args, DM_SMEM, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Sizes the kernels take: F == 128, 1 <= R <= 64, S >= 1, A >= 1.
int dense_cfconv_fwd(const float* pos, const float* x, const float* w0,
                     const float* b0, const float* w1, const float* offset,
                     const float* coeff, float* out, int S, int A, int Fdim,
                     int R, float rcut, int bf16, void* stream) {
  if (Fdim != F || R < 1 || R > RMAX || S < 1 || A < 1)
    return (int)cudaErrorInvalidValue;
  float arg_scale = (float)(PI / (double)rcut);
  float dcut_scale = (float)(-0.5 * (PI / (double)rcut));
  void* args[] = {&pos, &x,  &w0,   &b0,        &w1,        &offset, &coeff,
                  &out, &A,  &R,    &rcut,      &arg_scale, &dcut_scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return (int)launch(dense_fwd_kernel<true>, FWD_FLOATS, S, A, st, args);
  return (int)launch(dense_fwd_kernel<false>, FWD_FLOATS, S, A, st, args);
}

// gx may be null: then it is not computed (the block's input is
// position-independent and its cotangent dead). gd is a workspace of
// S * A * A floats; every entry is written before it is read.
int dense_cfconv_bwd(const float* pos, const float* x, const float* g,
                     const float* w0, const float* b0, const float* w1,
                     const float* offset, const float* coeff, float* gd,
                     float* gpos, float* gx, int S, int A, int Fdim, int R,
                     float rcut, int bf16, void* stream) {
  if (Fdim != F || R < 1 || R > RMAX || S < 1 || A < 1)
    return (int)cudaErrorInvalidValue;
  float arg_scale = (float)(PI / (double)rcut);
  float dcut_scale = (float)(-0.5 * (PI / (double)rcut));
  void* args[] = {&pos,  &x,  &g, &w0, &b0,   &w1,        &offset,
                  &coeff, &gd, &gx, &A, &R, &rcut, &arg_scale, &dcut_scale};
  cudaStream_t st = (cudaStream_t)stream;
  bool need_gx = gx != nullptr;
  cudaError_t err;
  if (bf16) {
    void* margs[] = {&pos, &x,  &g, &w0, &b0, &w1,   &offset,    &coeff,
                     &gd,  &gx, &S, &A,  &R,  &rcut, &arg_scale, &dcut_scale};
    err = launch_mma(need_gx ? dense_bwd_mma_kernel<true>
                             : dense_bwd_mma_kernel<false>,
                     S, A, st, margs);
  } else if (need_gx)
    err = launch(dense_bwd_kernel<true>, BWD_FLOATS, S, A, st, args);
  else
    err = launch(dense_bwd_kernel<false>, BWD_FLOATS, S, A, st, args);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((A + GPOS_ROWS - 1) / GPOS_ROWS, S);
  dense_gpos_kernel<<<grid, THREADS, 0, st>>>(pos, gd, gpos, A);
  return (int)cudaGetLastError();
}

// Dynamic shared memory per block, in bytes: of the forward (kind 0), of
// the backward's first pass at fp32 (1) or at bf16 (2, tensor cores).
int dense_cfconv_smem_bytes(int kind) {
  if (kind == 2) return DM_SMEM;
  return (int)sizeof(float) * (kind ? BWD_FLOATS : FWD_FLOATS);
}

}  // extern "C"
