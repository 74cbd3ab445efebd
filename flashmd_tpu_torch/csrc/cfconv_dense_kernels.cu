// Dense all-pairs exact-filter CFConv kernels for Hopper (sm_90a), plain C
// interface for ctypes. Built by flashmd_tpu_torch/ops/_build.py. The tile
// code shared with the neighbour-matrix kernels is in cfconv_tile.cuh.
//
// Two entry points replace the TPU kernels of
// flashmd_tpu/ops/pallas/cfconv_dense.py, batched over S molecules:
//
//   dense_cfconv_fwd  <- _fwd_kernel (:126), one launch:
//     dense_fwd_kernel (fp32), dense_fwd_mma_kernel (bf16):
//                        out[i] = sum_{j != i, j < A} W_ij * cut_ij * x[j]
//   dense_cfconv_bwd  <- _bwd_kernel (:147), two launches:
//     dense_bwd_ffma_kernel (fp32), dense_bwd_mma_kernel (bf16):
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
// bound by arithmetic, never by memory. The live pairs (d < rc, i != j;
// 0.097 of all pairs at the dense slice's start positions) are the only
// ones that add something. At bf16 both kernels take their products on the
// tensor cores over those only: a warp compacts its rows' live pairs into a
// ring and runs them in 16-pair M tiles of mma.m16n8k16 (cfconv_tile.cuh;
// the kernels' notes below). At fp32 the backward runs the same ring's
// pairs through register-tiled float32 FMAs on the CUDA cores
// (dense_bwd_ffma_kernel, bwd_ffma_tile); the fp32 forward does the
// arithmetic as float32 FMA from shared memory on every 64-pair chunk that
// holds a live pair:
//   - the [pairs, F] MLP activations never reach device memory: a block
//     owns 4 destination rows and walks the source atoms in chunks of 16,
//     so one chunk is a 64-pair tile whose activations live in registers
//     (4 pairs x 8 features per thread) and one shared [F, 64] tile;
//   - w0 and w1 are loaded into shared memory once per block, with padded
//     row strides so the products read them without bank conflicts;
//   - a chunk whose 64 pairs all lie at d >= rc (or are masked) adds
//     exactly zero (cut and dcut vanish there) and is skipped whole.
//
// Determinism: every block (the backward and the bf16 forward: every warp)
// owns its output rows. W and
// cut depend only on d_ij, which is bitwise symmetric, so gx[i] is the
// forward with x replaced by g. The reference adds gd_ij to row j across
// grid steps; here the first kernel writes gd [S, A, A] (36 MB at S = 128,
// A = 266) and the second sums row i of gd + gd^T in a fixed order. No
// sum crosses blocks, there are no atomics, and results are bitwise
// reproducible. Each ordered pair runs one MLP backward, as in the
// reference, so the bf16 roundings fall on the same values (g_i x_j cut
// and gt0 of each ordered pair).
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
constexpr int GPOS_ROWS = THREADS / 32;  // one warp per row of gpos

// Forward at fp32. Grid: (row tiles of ROWS, molecules). Thread (pg, fg)
// holds pairs p0 = 4 pg .. p0 + 3 (row pg / 4, columns 4 (pg % 4) + i) and
// features fg + 16 c.
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

  load_weights(w0, b0, w1, offset, R, w0_s, w1_s, b0_s, off_s);
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
      rbf_s[r * LDA + p] = expf(coeff * (dr * dr)) * cut_s[p];
    }
    __syncthreads();
    float t[4][FPT] = {};
    gemm_tile<FPT>(rbf_s, w0_s + fg, R, LDW, 1, p0, t);
#pragma unroll
    for (int c = 0; c < FPT; ++c) {
      int f = fg + 16 * c;
#pragma unroll
      for (int i = 0; i < 4; ++i) t[i][c] = tanhf(t[i][c] + b0_s[f]);
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

// Backward, pass 1 at fp32, on the CUDA cores: gd of every ordered pair of
// a work item's rows (zero where dead) and, with GX, gx of those rows.
//
// Replaces _bwd_kernel (flashmd_tpu/ops/pallas/cfconv_dense.py:147) at
// fp32, as dense_bwd_mma_kernel does at bf16. Bound: operations, per live
// pair 4 (R F + F F) FLOP of the four products (+ 12 F + 6 R elementwise)
// at the 67 TFLOP/s float32 peak: 1.2091 ms at the dense slice's start
// (871,318 live pairs, R = 50, F = 128).
//
// Design: dense_bwd_mma_kernel's pairs, with the products on the CUDA
// cores. A persistent grid stages w0 and w1 as float32 once per block
// (stage_weights_f32, 101 KB); each of its DF_WARPS = 4 warps (one per
// scheduler of the SM, dense_cfconv_smem_bytes(4)) owns work items of
// DM_RW rows, scans their partners 32 at a time, writes gd = 0 for every
// dead pair and pushes the live ones (d < rc, i != j, in range), in
// row-major order, into its ring. Every DF_TILE = 16
// entries are one tile (bwd_ffma_tile): the four products as
// register-tiled float32 FMAs (8 pairs x 8 columns a lane, 16 FMAs per
// shared load), tanhf and expf at the twin's places, a0 kept in the warp's
// shared tile for (1 - a0^2), gd of the tile's pairs written to the [S, A,
// A] workspace, and with GX (W cut) g_j summed into the item's gx rows in
// ring order. Every sum runs in a fixed order (features, then pairs in
// ring order); no atomics.
template <bool GX>
__global__ void __launch_bounds__(DF_WARPS * 32, 1)
dense_bwd_ffma_kernel(const float* __restrict__ pos,
                      const float* __restrict__ x,
                      const float* __restrict__ g,
                      const float* __restrict__ w0,
                      const float* __restrict__ b0,
                      const float* __restrict__ w1,
                      const float* __restrict__ offset,
                      const float* __restrict__ coeff_p,
                      float* __restrict__ gd, float* __restrict__ gx, int S,
                      int A, int R, float rcut, float arg_scale,
                      float dcut_scale) {
  extern __shared__ float4 ffma_smem4[];
  float* w0_s = reinterpret_cast<float*>(ffma_smem4);  // [RMAX][DF_LDW]
  float* w1_s = w0_s + RMAX * DF_LDW;                  // [F][DF_LDW]
  float* b0_s = w1_s + F * DF_LDW;                     // [F]
  float* off_s = b0_s + F;                             // [RMAX]
  stage_weights_f32(w0, b0, w1, offset, R, w0_s, w1_s, b0_s, off_s);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* act_s = off_s + RMAX + warp * DF_WARP_FLOATS;  // [DF_TILE][F]
  float* buf_s = act_s + DF_TILE * F;                   // [DF_TILE][F]
  float* gx_s = buf_s + DF_TILE * F;                    // [DM_RW][F]
  float* pd_s = gx_s + DM_RW * F;                       // [DF_TILE][4]
  int* ring = reinterpret_cast<int*>(pd_s + 4 * DF_TILE);  // [DM_RING]
  const float coeff = *coeff_p;

  const int n_groups = (A + DM_RW - 1) / DM_RW;
  const int n_items = S * n_groups;
  for (int item = blockIdx.x * DF_WARPS + warp; item < n_items;
       item += gridDim.x * DF_WARPS) {
    const int s = item / n_groups, r0 = (item % n_groups) * DM_RW;
    const float* ps = pos + (size_t)s * A * 3;
    const float* xs = x + (size_t)s * A * F;
    const float* gs = g + (size_t)s * A * F;
    float* gds = gd + (size_t)s * A * A;
    if (GX) {
      for (int e = lane; e < DM_RW * F; e += 32) gx_s[e] = 0.0f;
      __syncwarp();
    }

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
        tail = ring_push(ring, tail, live, (rr << 16) | j, lane);
        for (; tail - head >= DF_TILE; head += DF_TILE)
          bwd_ffma_tile<GX>(ring, head, DF_TILE, r0, ps, A, xs, gs, act_s,
                            buf_s, pd_s, gx_s, gds, w0_s, w1_s, b0_s, off_s,
                            R, coeff, rcut, arg_scale, dcut_scale, lane);
      }
    }
    if (tail > head)
      bwd_ffma_tile<GX>(ring, head, tail - head, r0, ps, A, xs, gs, act_s,
                        buf_s, pd_s, gx_s, gds, w0_s, w1_s, b0_s, off_s, R,
                        coeff, rcut, arg_scale, dcut_scale, lane);
    if (GX) {
      float* gxs = gx + (size_t)s * A * F;
      for (int e = 4 * lane; e < DM_RW * F; e += 128) {
        int i = r0 + e / F;
        if (i < A)
          *reinterpret_cast<float4*>(gxs + (size_t)i * F + e % F) =
              *reinterpret_cast<const float4*>(gx_s + e);
      }
    }
    __syncwarp();  // gx_s is read before the next item writes
  }
}

// Backward, pass 1 at bf16, on the tensor cores: gd of every ordered pair
// of a work item's rows (zero where dead) and, with GX, gx of those rows.
//
// Design (the live-pair ring of cfconv_tile.cuh):
// 1. A warp scans its rows' partners 32 at a time and appends the live
//    pairs (d < rc, i != j, in range), in row-major order, to its ring,
//    writing gd = 0 for every other pair.
// 2. Each 16 pairs of the ring are one M tile (bwd_mma_tile). Four
//    mma.m16n8k16 products per tile: a0 = tanh(bf16(rbf) bf16(w0) + b0)
//    (K = R padded to 16), ga0 = bf16(g_i x_j cut) bf16(w1)^T, grbf =
//    bf16(gt0) bf16(w0)^T with gt0 = ga0 (1 - a0^2), W = bf16(a0)
//    bf16(w1). Each product's accumulators are the next one's A fragments
//    (mlp_afrag); the float32 a0 waits for (1 - a0^2) and bf16(a0) in
//    lane-private shared memory, so that ga0's 64 accumulators fit without
//    spills. The bf16 roundings fall where they do in the twin and the
//    reference, each ordered pair runs its own MLP backward, and tanh, the
//    geometry, s_cut and the sums stay float32.
// 3. gd of the tile's pairs from grbf, s_cut and the cutoff, written to
//    the [S, A, A] workspace; with GX, W cut is staged per pair and
//    (W cut) g_j summed into the item's gx rows in ring order (a running
//    sum per row segment, one lane per 4 features, g_j read coalesced).
// per warp, in floats: gx staging [16][DM_VLD], g and gx rows [DM_RW][F]
// each, the ring, the float32 a0 [16 n-tiles][32 lanes][4]
constexpr int DM_WARP_FLOATS = 16 * DM_VLD + 2 * DM_RW * F + DM_RING + 16 * F;
constexpr int DM_SMEM = WB_BYTES + 4 * DM_WARPS * DM_WARP_FLOATS;  // bytes

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
  extern __shared__ float4 mma_smem4[];
  const __nv_bfloat16 *w0_b, *w1_b;
  const float *b0_s, *off_s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* v_s = stage_mma_smem(mma_smem4, w0, b0, w1, offset, R, w0_b, w1_b,
                              b0_s, off_s) +
               warp * DM_WARP_FLOATS;                    // [16][DM_VLD]
  float* gi_s = v_s + 16 * DM_VLD;                       // [DM_RW][F]
  float* gx_s = gi_s + DM_RW * F;                        // [DM_RW][F]
  int* ring = reinterpret_cast<int*>(gx_s + DM_RW * F);  // [DM_RING]
  float4* a0_s = reinterpret_cast<float4*>(ring + DM_RING);
  const float coeff = *coeff_p;

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
        tail = ring_push(ring, tail, live, (rr << 16) | j, lane);
        for (; tail - head >= 16; head += 16)
          bwd_mma_tile<GX, false>(ring, head, 16, r0, ps, nullptr, A, xs, gs,
                                  gi_s, v_s, gx_s, a0_s, gds, w0_b, w1_b,
                                  b0_s, off_s, R, coeff, rcut, arg_scale,
                                  dcut_scale, lane);
      }
    }
    if (tail > head)
      bwd_mma_tile<GX, false>(ring, head, tail - head, r0, ps, nullptr, A, xs,
                              gs, gi_s, v_s, gx_s, a0_s, gds, w0_b, w1_b,
                              b0_s, off_s, R, coeff, rcut, arg_scale,
                              dcut_scale, lane);
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

// Forward at bf16, on the tensor cores: out of a work item's rows. The
// ring of the backward with two of its four products (fwd_mma_items over
// each row's A partners): the rows' live pairs (d < rc, i != j) in 16-pair
// tiles, a0 and W on the tensor cores, out_i += (W cut) x_j in ring order
// into the item's out rows, which its warp owns. Without the float32 a0 that
// the backward keeps, a thread needs at most 128 registers, so FW_WARPS = 16
// warps share an SM.
__global__ void __launch_bounds__(FW_WARPS * 32, 1)
dense_fwd_mma_kernel(const float* __restrict__ pos,
                     const float* __restrict__ x,
                     const float* __restrict__ w0,
                     const float* __restrict__ b0,
                     const float* __restrict__ w1,
                     const float* __restrict__ offset,
                     const float* __restrict__ coeff_p,
                     float* __restrict__ out, int S, int A, int R, float rcut,
                     float arg_scale, float dcut_scale) {
  extern __shared__ float4 mma_smem4[];
  fwd_mma_items(
      mma_smem4, pos, x, w0, b0, w1, offset, coeff_p, out, S, A, R, rcut,
      arg_scale, dcut_scale, [=](int, int) { return make_int2(0, A); },
      [=](int, const float* ps, int i, int e, int& j) {
        j = e;
        float d, cut, dcut, rel[3];
        return pair_geom(ps + i * 3, ps + j * 3, j != i, rcut, arg_scale,
                         dcut_scale, d, cut, dcut, rel);
      });
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

bool sizes_ok(int S, int A, int Fdim, int R) {
  return Fdim == F && R >= 1 && R <= RMAX && S >= 1 && A >= 1 &&
         A <= RING_MAX;
}

}  // namespace

extern "C" {

// Sizes the kernels take: F == 128, 1 <= R <= 64, S >= 1 and 1 <= A <=
// RING_MAX.
int dense_cfconv_fwd(const float* pos, const float* x, const float* w0,
                     const float* b0, const float* w1, const float* offset,
                     const float* coeff, float* out, int S, int A, int Fdim,
                     int R, float rcut, int bf16, void* stream) {
  if (!sizes_ok(S, A, Fdim, R)) return (int)cudaErrorInvalidValue;
  float arg_scale = (float)(PI / (double)rcut);
  float dcut_scale = (float)(-0.5 * (PI / (double)rcut));
  void* args[] = {&pos, &x,  &w0,   &b0,        &w1,        &offset, &coeff,
                  &out, &A,  &R,    &rcut,      &arg_scale, &dcut_scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    void* margs[] = {&pos,  &x, &w0, &b0,   &w1,        &offset,    &coeff,
                     &out, &S, &A,  &R,    &rcut,      &arg_scale, &dcut_scale};
    return (int)launch_persistent(dense_fwd_mma_kernel, FW_WARPS, FW_SMEM,
                                  S * ((A + DM_RW - 1) / DM_RW), st, margs);
  }
  return (int)launch(dense_fwd_kernel, FWD_FLOATS, S, A, st, args);
}

// gx may be null: then it is not computed (the block's input is
// position-independent and its cotangent dead). gd is a workspace of
// S * A * A floats; every entry is written before it is read.
int dense_cfconv_bwd(const float* pos, const float* x, const float* g,
                     const float* w0, const float* b0, const float* w1,
                     const float* offset, const float* coeff, float* gd,
                     float* gpos, float* gx, int S, int A, int Fdim, int R,
                     float rcut, int bf16, void* stream) {
  if (!sizes_ok(S, A, Fdim, R)) return (int)cudaErrorInvalidValue;
  float arg_scale = (float)(PI / (double)rcut);
  float dcut_scale = (float)(-0.5 * (PI / (double)rcut));
  void* margs[] = {&pos, &x,  &g, &w0, &b0, &w1,   &offset,    &coeff,
                   &gd,  &gx, &S, &A,  &R,  &rcut, &arg_scale, &dcut_scale};
  cudaStream_t st = (cudaStream_t)stream;
  bool need_gx = gx != nullptr;
  cudaError_t err;
  if (bf16) {
    err = launch_persistent(need_gx ? dense_bwd_mma_kernel<true>
                                    : dense_bwd_mma_kernel<false>,
                            DM_WARPS, DM_SMEM, S * ((A + DM_RW - 1) / DM_RW),
                            st, margs);
  } else {
    err = launch_persistent(need_gx ? dense_bwd_ffma_kernel<true>
                                    : dense_bwd_ffma_kernel<false>,
                            DF_WARPS, DF_SMEM, S * ((A + DM_RW - 1) / DM_RW),
                            st, margs);
  }
  if (err != cudaSuccess) return (int)err;
  dim3 grid((A + GPOS_ROWS - 1) / GPOS_ROWS, S);
  dense_gpos_kernel<<<grid, THREADS, 0, st>>>(pos, gd, gpos, A);
  return (int)cudaGetLastError();
}

// Dynamic shared memory per block, in bytes: of the forward at fp32 (kind
// 0) or at bf16 (3, tensor cores), of the backward's first pass at fp32 (1,
// CUDA cores) or at bf16 (2, tensor cores). Kind 4: the fp32 backward's
// warps per block; 5: its bytes per warp (the rest of kind 1 is the
// staged float32 weights).
int dense_cfconv_smem_bytes(int kind) {
  switch (kind) {
    case 0: return (int)sizeof(float) * FWD_FLOATS;
    case 1: return DF_SMEM;
    case 2: return DM_SMEM;
    case 3: return FW_SMEM;
    case 4: return DF_WARPS;
    case 5: return (int)sizeof(float) * DF_WARP_FLOATS;
    default: return -1;
  }
}

}  // extern "C"
