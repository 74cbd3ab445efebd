// Chebyshev matmul-only CFConv kernels for Hopper (sm_90a), plain C
// interface for ctypes. Built by flashmd_tpu_torch/ops/_build.py.
//
// Four kernels replace the TPU kernels of
// flashmd_tpu/ops/pallas/cheb_kernel.py:
//
//   cheb_fwd     <- _cheb_fwd_kernel
//     out[i] = sum_m c_m * (Ttil_m[i,:] @ x) - w0 * x[i]
//              + w_lin * (low[i,:] @ x),   Ttil_m = (1-z)^2 T_m(z)
//   cheb_bwd_gx  <- _cheb_bwd_kernel (need_gx=True, need_gd=False)
//     gx[i]  = sum_k That_k[i,:] @ (q_k * g) - w0 * g[i]
//              + low[i,:] @ (w_lin * g),   That_k = (1-z) T_k(z)
//   cheb_bwd_gd  <- _cheb_bwd_kernel (need_gx=False; block-stacked on the
//                   stacked schedule, one block's [A, F] on the per-block
//                   schedule)
//     gd[i,j] = (1-z) sum_m T_m(z) ((c2_m * g[i]) . x[j]),  W = gd / d
//     gpos[i] = pos[i] rowsum(W)_i - (W @ pos)_i
//             + pos[i] colsum(W)_i - (W^T @ pos)_i
//   cheb_bwd_gxgd <- _cheb_bwd_kernel (need_gx=True, need_gd=True), the
//                   per-block backward of blocks 2..B: gx and gpos in one
//                   launch from the pairs' recurrence on T_m, which feeds
//                   the gx series (That_m = (1-z) T_m, the (1-z) factor
//                   applied to each pair's filter) and the gd series (the
//                   (1-z) factor riding in W).
//
// What bounds them on the H100: at the slice (A=266, F=128, B=3 blocks,
// orders 48/64) the kernels are matrix work over the pairs within the
// cutoff (871,318 of 9,056,768 at the slice's start), 2 F FLOP per live
// pair and order; the bytes they read are pos, x/g and the coefficient
// tables (a few hundred KB per molecule), so they sit far above the
// machine balance and are bound by arithmetic. Every kernel runs only the
// pairs that add something: at fp32 each takes float32 FMAs on the CUDA
// cores over the live pairs one by one, compacted per row by warp vote
// (cheb_rows_ffma_kernel, cheb_gd_ffma_kernel, cheb_gxgd_ffma_kernel: each
// pair's filter over all features as a register-tiled [pairs x M] [M x F]
// product, 32 FMAs per shared load, with the recurrence in registers). At
// bf16 and bf16x3 each takes its order products on the tensor cores:
// cheb_bwd_gd over the live 16 x 8 pair fragments only
// (cheb_gd_mma_kernel), cheb_fwd and cheb_bwd_gx over the 16 x 16
// fragments with a pair inside the cutoff (cheb_rows_mma_kernel), and
// cheb_bwd_gxgd over those same fragments, both halves from one
// recurrence (cheb_gxgd_mma_kernel); their notes are below. What the
// design does about the bound: the [A, A] pair and recurrence state never
// reaches device memory -- it lives in registers -- so every FLOP is spent
// on the products themselves, and the three-term recurrence costs one FMA
// per pair and order against F FMAs of product (eight at fp32, where each
// lane steps its own pairs).
//
// Determinism: each warp or block owns its output rows; the only sums
// that cross them (the column side of the position gradient at bf16 and
// bf16x3; the feature chunks of the fp32 gd and gx+gd) are
// written as partial slabs and summed by a second kernel in a fixed slab
// order. No atomics anywhere, so results are bitwise reproducible run to
// run.
//
// Precision tiers (the C entry points' `tier`; any other value is refused
// with cudaErrorInvalidValue). At the same places as the plain PyTorch
// twins in ops/cheb_kernel.py; the recurrence and all accumulation stay
// float32:
//   0 fp32    float32 products (the CUDA-core kernels).
//   1 bf16    product operands rounded to bf16 (round to nearest even),
//             one mma.m16n8k16 per product tile.
//   3 bf16x3  each product operand split as hi = bf16(v), lo = bf16(v -
//             hi), the product taken as hi*hi + lo*hi + hi*lo: the
//             reference's _mxu_dot (cheb_kernel.py:358-380) emulating
//             Precision.HIGH, near float32; three mma passes on the split
//             operands, each split where its operand is formed. What
//             bounds the bf16x3 variants: the same matrix work three
//             times over (3x the product FLOPs at the bf16 rate).
//
// Periodic cells (HAS_CELL, the reference's has_cell): the C entry points
// take cell and inv pointers, [S, 3, 3] float32 (lattice rows and their
// inverse), nullptr for open boundaries. Each block stages its molecule's
// 18 scalars in shared memory once; every pair displacement is wrapped to
// the minimum image before d (frac = rel inv, rel -= rint(frac) cell,
// rounded half to even as jnp.round / torch.round). The wrap breaks the
// pos rowsum(W) - W pos identity of the gd epilogue, so the cell variant
// contracts W against the wrapped rel directly:
//     row side    -sum_j W_ij rel_ij,   column side  +sum_i W_ij rel_ij.
// The open variants compile as before: every cell branch is a constant.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <type_traits>

namespace {

constexpr int TIER_FP32 = 0;
constexpr int TIER_BF16 = 1;
constexpr int TIER_X3 = 3;

// The molecule's lattice (geo[0..8], rows) and inverse (geo[9..17]) into
// shared memory, one thread per scalar.
template <bool HAS_CELL>
__device__ __forceinline__ void stage_cell(float* geo, const float* cell,
                                           const float* inv, int s,
                                           int tid) {
  if (HAS_CELL && tid < 18)
    geo[tid] = tid < 9 ? cell[s * 9 + tid] : inv[s * 9 + tid - 9];
}

// rel = p_j - p_i, minimum-imaged under a cell in the reference's index
// order (_tile_rel, cheb_kernel.py:204-257).
template <bool HAS_CELL>
__device__ __forceinline__ void pair_rel(const float* pi, const float* pj,
                                         const float* geo, float& r0,
                                         float& r1, float& r2) {
  r0 = pj[0] - pi[0];
  r1 = pj[1] - pi[1];
  r2 = pj[2] - pi[2];
  if (HAS_CELL) {
    const float* iv = geo + 9;
    float n0 = rintf(r0 * iv[0] + r1 * iv[3] + r2 * iv[6]);
    float n1 = rintf(r0 * iv[1] + r1 * iv[4] + r2 * iv[7]);
    float n2 = rintf(r0 * iv[2] + r1 * iv[5] + r2 * iv[8]);
    r0 -= n0 * geo[0] + n1 * geo[3] + n2 * geo[6];
    r1 -= n0 * geo[1] + n1 * geo[4] + n2 * geo[7];
    r2 -= n0 * geo[2] + n1 * geo[5] + n2 * geo[8];
  }
}

// d = sqrt(|rel|^2 + 1e-12) from exact per-coordinate differences
// (not a Gram matmul); pairs outside [0, A) are parked at 2 rcut, where
// z = 1 and every (1-z)-weighted basis value is exactly zero.
template <bool HAS_CELL>
__device__ __forceinline__ void pair_geom(const float* pi, const float* pj,
                                          const float* geo, bool valid,
                                          float rcut, float d_min,
                                          float scale, float& d, float& z) {
  float r0, r1, r2;
  pair_rel<HAS_CELL>(pi, pj, geo, r0, r1, r2);
  float dd = sqrtf(r0 * r0 + r1 * r1 + r2 * r2 + 1e-12f);
  if (!valid) dd = 2.0f * rcut;
  d = dd;
  z = fminf(fmaxf((dd - d_min) * scale - 1.0f, -1.0f), 1.0f);
}

// One float to shared memory by cp.async, zero-filled when !in (src is
// then not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// The fp32 tier of cheb_fwd, cheb_bwd_gx and cheb_bwd_gd, on the CUDA
// cores, over the live pairs only (cheb_bwd_gxgd's, built from the same
// machinery, is cheb_gxgd_ffma_kernel below).
//
// Replace _cheb_fwd_kernel (flashmd_tpu/ops/pallas/cheb_kernel.py:394)
// and _cheb_bwd_kernel with need_gd=False or need_gx=False (:476) at
// fp32, as cheb_rows_mma_kernel and cheb_gd_mma_kernel do at bf16 and
// bf16x3. Bound: operations, 2 * live pairs * F * M FLOP of order
// products at the 67 TFLOP/s float32 peak (TF32 stays off: this tier is
// exact float32 arithmetic): at the cheb slice (871,318 live pairs of 128
// molecules, F = 128) 0.160 ms for the 48 forward orders, 0.163 ms for the
// 49 gx orders, 0.639 ms for the stacked gd (F = 384, M = 64).
//
// Design. For the P live pairs of a row the filter is a matrix product,
//     Wf[p, f] = sum_m T~_m(z_p) C[m, f],
// with C = c (fwd), q (gx) or c2 (gd) and T~_m the three-term recurrence
// from the seed (1-z)^2, (1-z) or 1. Each output is a sum of Wf against
// the operands:
//     fwd   out[i, f]  = sum_p Wf[p, f] x[j_p, f]  (+ low_p w_lin[f] in Wf)
//     gx    gx[i, f]   = sum_p Wf[p, f] g[j_p, f]  (the same, q and g)
//     gd    W_p = (1-z_p) / d_p sum_f Wf[p, f] (g[i, f] x[j, f]
//                                               + g[j, f] x[i, f])
//           gpos[i]    = -sum_p W_p rel_p          (rel_p = p_j - p_i,
//                                                   minimum-imaged)
// gd takes W_ij + W_ji from one Wf: d, z and the basis are symmetric
// bitwise (rel_ji = -rel_ij exactly, rint is odd), so each row owns its
// whole gradient and no column partial crosses a row.
// 1. Live pairs. A warp owns whole rows (one block stages C once and its
//    LF_W warps walk a contiguous range of the batch's S * A rows, warp w
//    taking every LF_W-th; the rows of a molecule stay together, so the
//    warps of a block read neighbouring x rows from L1). Per row the warp
//    computes z for 32 columns at a time (lf_geom), votes, and pushes
//    the live ones in column order into its ring (row, column, z and low
//    or d and rel): fwd/gx keep z != 1 exactly (both seeds vanish at z ==
//    1; the diagonal, at z = -1, stays and the epilogue removes its share
//    as w0 x[i]); gd keeps d < rcut off the diagonal in range (W is zero
//    elsewhere). Nothing leaves the card, the step loop waits for nothing.
// 2. Product core. Whenever LF_PB = 16 pairs are queued the warp takes
//    them as one batch: lane (fg = lane % 16, pg = lane / 16) holds Wf of
//    pairs 8 pg .. 8 pg + 7 at features 4 fg + {0..3} and 64 + 4 fg +
//    {0..3} of the block's LF_FC = 128-feature chunk in 64 float32
//    accumulators. Per order it steps its 8 pairs' recurrence in
//    registers (one FMA each; the forward's product and difference
//    rounded apart, lf_two_orders: no basis tile, no barrier), reads C[m] at
//    its features with two 16-byte shared loads, then takes 64 FMAs: 32
//    FMAs per shared load, against 2 in the 32 x 32 tiles this replaces.
//    C (and w_lin as one more row) is staged once per block by cp.async.
// 3. Epilogues. fwd/gx: the batch's Wf goes to the warp's shared rows in
//    two halves; lane l then sums Wf[p, 4l..4l+3] * x[j_p] over the pairs
//    in ring order into a running row sum, written as sum - w0 x[i] when
//    the row changes. gd: each lane contracts its 8 features per pair,
//    the 16 feature lanes reduce by shuffles (xor 1, 2, 4, 8), and -W rel
//    is summed per row in ring order. A row with no live pair is written
//    at the end of its scan (fwd/gx: -w0 x[i]; gd: 0).
// 4. Feature chunks. The grid's y axis takes F in chunks of LF_FC; fwd
//    and gx chunks own their features; gd chunk 0 writes row_part and
//    chunk c > 0 slab c - 1 of col_part, summed by gd_reduce_kernel in
//    chunk order (cheb_bwd_gd's n_slabs = chunks - 1).
// Determinism: every sum runs in a fixed order (orders, ring order within
// a row, the shuffle tree, chunk order), whatever the grid; no atomics.
// What bounds it: the product's FMAs, with one recurrence step per eight
// product FMAs on top. Reached at the cheb slice's shapes (H100 80GB
// HBM3, 700 W; chip_smoke, PERF.md section 6): at (48, 64) fwd about 0.51
// ms (31 % of the bound), gx 0.49-0.54 (30-33 %), stacked gd 1.84 (35 %),
// one block's gd 0.68 (31 %), 10-16x the 32 x 32 and 64 x 64 all-pair
// tiles they replace; at the fp32 zoo's (128, 128) fwd and gx about 1.0
// ms (42-44 %), stacked gd 2.8 (45 %). What holds them there: the order
// loop runs at about half the FFMA rate, and the rest (the scan, the
// epilogues, the staging: tools/cheb_ffma_variants.py's no_orders) takes
// 0.16 ms of the forward at M = 48 and 0.71 ms of the stacked gd, whose
// three feature chunks each scan the rows again.
// Orders up to ~370 (fwd, gx) or ~420 (gd) fit the staged C.
constexpr int LF_W = 8;          // warps per block
constexpr int LF_FC = 128;       // features per block
constexpr int LF_PP = 8;         // pairs per lane
constexpr int LF_PB = 2 * LF_PP;  // pairs per batch
constexpr int LF_RING = 64;      // ring entries per warp (a power of two)
// Blocks per SM that the register budget must allow: one for fwd/gx (168
// registers with the order loop unrolled four times; two blocks cap them
// at 128 and ran 10-22 % slower at M = 128, 3-12 % at M = 48:
// tools/cheb_ffma_variants.py), two for gd (at one, 168 registers and
// 10-13 % slower stacked).
constexpr int LF_ROWS_MINB = 1;
constexpr int LF_GD_MINB = 2;
// per-warp shared floats: Wf half batch, ring (row, column, z, low), cell
constexpr int LF_ROWS_WARP = LF_PP * LF_FC + 4 * LF_RING + 32;
// per-warp shared floats: -W rel per pair, ring (row, column, z, d, rel),
// cell
constexpr int LF_GD_WARP = 4 * LF_PB + 7 * LF_RING + 32;

// Four features f..f+3 of a row (zero past F); one 16-byte load when the
// row is 16-byte aligned (vec: F % 4 == 0 and an aligned base).
__device__ __forceinline__ float4 lf_ld4(const float* row, int f, int F,
                                         bool vec) {
  if (vec && f + 3 < F) return *reinterpret_cast<const float4*>(row + f);
  return make_float4(f < F ? row[f] : 0.0f, f + 1 < F ? row[f + 1] : 0.0f,
                     f + 2 < F ? row[f + 2] : 0.0f,
                     f + 3 < F ? row[f + 3] : 0.0f);
}

// C rows 0..rows-1 ([rows][F] at coef) and, when extra != nullptr, one
// more row from extra [F], of features f0..f0+LF_FC-1 into c_s
// [rows (+1)][LF_FC], zero past F; waited for and visible to the block.
__device__ __forceinline__ void lf_stage(float* c_s, const float* coef,
                                         const float* extra, int rows,
                                         int f0, int F) {
  int n = (rows + (extra != nullptr)) * LF_FC;
  for (int e = threadIdx.x; e < n; e += LF_W * 32) {
    int m = e / LF_FC, f = f0 + e % LF_FC;
    bool in = f < F;
    const float* src = m < rows ? coef + (size_t)m * F + f : extra + f;
    cp_async4(c_s + e, in ? src : coef, in);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// rel = p_j - p_i and d, z as the twins round them on the CPU: every
// product and sum apart, sums left to right, none contracted into an FMA
// (pair_rel and pair_geom let the compiler contract), so that z is bitwise
// the CPU twins'. The basis at order m moves by ~m^2 ulps of z near z =
// +-1, so at M = 128 on coefficients that do not decay the twin on the
// card, whose torch.sum adds the squares as (x^2 + z^2) + y^2, lies about
// as far from the twin on the CPU as the forward's 1e-5 bound; the card
// tests hold these kernels against the CPU twins.
template <bool HAS_CELL>
__device__ __forceinline__ void lf_geom(const float* pi, const float* pj,
                                        const float* geo, bool valid,
                                        float rcut, float d_min, float scale,
                                        float (&r)[3], float& d, float& z) {
#pragma unroll
  for (int k = 0; k < 3; ++k) r[k] = pj[k] - pi[k];
  if (HAS_CELL) {
    const float* iv = geo + 9;
    float n[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      n[k] = rintf(__fadd_rn(__fadd_rn(__fmul_rn(r[0], iv[k]),
                                       __fmul_rn(r[1], iv[3 + k])),
                             __fmul_rn(r[2], iv[6 + k])));
#pragma unroll
    for (int k = 0; k < 3; ++k)
      r[k] = __fsub_rn(r[k], __fadd_rn(__fadd_rn(__fmul_rn(n[0], geo[k]),
                                                 __fmul_rn(n[1], geo[3 + k])),
                                       __fmul_rn(n[2], geo[6 + k])));
  }
  float d2 = __fadd_rn(__fadd_rn(__fmul_rn(r[0], r[0]), __fmul_rn(r[1], r[1])),
                       __fmul_rn(r[2], r[2]));
  d = valid ? sqrtf(__fadd_rn(d2, 1e-12f)) : 2.0f * rcut;
  z = fminf(fmaxf(__fsub_rn(__fmul_rn(__fsub_rn(d, d_min), scale), 1.0f),
                  -1.0f),
            1.0f);
}

// The molecule's lattice and inverse into the warp's geo (cell variant),
// when the molecule changes.
template <bool HAS_CELL>
__device__ __forceinline__ void lf_geo(float* geo, const float* cell,
                                       const float* inv, int s, int& cur_s,
                                       int lane) {
  if (!HAS_CELL || s == cur_s) return;
  __syncwarp();
  if (lane < 18) geo[lane] = lane < 9 ? cell[s * 9 + lane]
                                      : inv[s * 9 + lane - 9];
  __syncwarp();
  cur_s = s;
}

// acc[p][k] += t[p] * C[m][k] at this lane's features (cm = C[m] + 4 fg).
__device__ __forceinline__ void lf_order(float (&acc)[LF_PP][8],
                                         const float (&t)[LF_PP],
                                         const float* cm) {
  const float4 lo = *reinterpret_cast<const float4*>(cm);
  const float4 hi = *reinterpret_cast<const float4*>(cm + LF_FC / 2);
  const float c[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int p = 0; p < LF_PP; ++p)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[p][k] = fmaf(t[p], c[k], acc[p][k]);
}

// Orders m and m + 1 into acc, then ta, tb advanced to T_{m+2}, T_{m+3}.
// With TWIN_STEP the step is rounded twice, as the twins' two_z * t -
// t_prev, so that the basis is bitwise the twins' (with lf_geom's z): the
// recurrence's rounding grows as m^2 near z = +-1, and at M = 128 on
// coefficients that do not decay an FMA here takes the forward several
// times farther from its twin, toward its 1e-5 bound. The forward pays
// the extra instruction (tools/cheb_ffma_variants.py, fwd_fma_step); gx
// and gd, bound at 1e-4, take one FMA.
template <bool TWIN_STEP>
__device__ __forceinline__ void lf_two_orders(float (&acc)[LF_PP][8],
                                              float (&ta)[LF_PP],
                                              float (&tb)[LF_PP],
                                              const float (&z2)[LF_PP],
                                              const float* cm) {
  lf_order(acc, ta, cm);
  lf_order(acc, tb, cm + LF_FC);
#pragma unroll
  for (int p = 0; p < LF_PP; ++p) {
    if constexpr (TWIN_STEP) {
      ta[p] = __fsub_rn(__fmul_rn(z2[p], tb[p]), ta[p]);
      tb[p] = __fsub_rn(__fmul_rn(z2[p], ta[p]), tb[p]);
    } else {
      ta[p] = fmaf(z2[p], tb[p], -ta[p]);
      tb[p] = fmaf(z2[p], ta[p], -tb[p]);
    }
  }
}

// acc = sum_m T_m C[m] over M orders from the seeds ta = T_0, tb = T_1
// (advanced in place, two orders a step: T_{m+2} = 2z T_{m+1} - T_m), the
// loop over steps unrolled UNROLL times (tools/cheb_ffma_variants.py: 4
// for fwd/gx, which have the registers for it, 1 for gd and both passes
// of gx+gd).
template <int UNROLL, bool TWIN_STEP>
__device__ __forceinline__ void lf_product(float (&acc)[LF_PP][8],
                                           float (&ta)[LF_PP],
                                           float (&tb)[LF_PP],
                                           const float (&z2)[LF_PP],
                                           const float* cf, int M) {
#pragma unroll
  for (int p = 0; p < LF_PP; ++p)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[p][k] = 0.0f;
  int m = 0;
#pragma unroll(UNROLL)
  for (; m + 1 < M; m += 2)
    lf_two_orders<TWIN_STEP>(acc, ta, tb, z2, cf + m * LF_FC);
  if (m < M) lf_order(acc, ta, cf + m * LF_FC);
}

// The warp's share [lo + warp, hi) step LF_W of the block's rows.
__device__ __forceinline__ void lf_rows(int S, int A, int warp, int& lo,
                                        int& hi) {
  int n = S * A;
  int per = (n + gridDim.x - 1) / gridDim.x;
  lo = blockIdx.x * per + warp;
  hi = min((int)(blockIdx.x * per) + per, n);
}

// cheb_fwd (GX = false: seed (1-z)^2, operand x, coefficients c) and
// cheb_bwd_gx (GX = true: seed (1-z), operand g, coefficients q) at fp32.
// Grid: (blocks over the S * A rows, feature chunks); LF_W warps.
template <bool GX, bool HAS_CELL>
__global__ void __launch_bounds__(LF_W * 32, LF_ROWS_MINB)
cheb_rows_ffma_kernel(const float* __restrict__ pos,
                      const float* __restrict__ in,
                      const float* __restrict__ coef,
                      const float* __restrict__ w0,
                      const float* __restrict__ w_lin,
                      const float* __restrict__ cell,
                      const float* __restrict__ inv, float* __restrict__ out,
                      int S, int A, int F, int M, float rcut, float d_min,
                      float scale, int vec_in) {
  extern __shared__ float4 lf_smem4[];
  float* c_s = reinterpret_cast<float*>(lf_smem4);  // [M + 1][LF_FC]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int fg = lane & 15, pg = lane >> 4;
  const int f0 = blockIdx.y * LF_FC;
  const bool vec = vec_in != 0;
  float* wf_s = c_s + (size_t)(M + 1) * LF_FC + warp * LF_ROWS_WARP;
  int* ring_i = reinterpret_cast<int*>(wf_s + LF_PP * LF_FC);
  int* ring_j = ring_i + LF_RING;
  float* ring_z = reinterpret_cast<float*>(ring_j + LF_RING);
  float* ring_a = ring_z + LF_RING;
  float* geo = ring_a + LF_RING;
  lf_stage(c_s, coef, w_lin, M, f0, F);

  int row, row_end;
  lf_rows(S, A, warp, row, row_end);
  int head = 0, tail = 0, cur = -1, cur_s = -1;
  float run[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  // out[r] = run - w0 in[r] at this lane's four features
  auto commit = [&](int r) {
    const size_t o = (size_t)r * F;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int f = f0 + 4 * lane + k;
      if (f < F) out[o + f] = run[k] - w0[f] * in[o + f];
    }
  };
  // the nv (<= LF_PB) queued pairs from head
  auto batch = [&](int nv) {
    float ta[LF_PP], tb[LF_PP], z2[LF_PP];
#pragma unroll
    for (int p = 0; p < LF_PP; ++p) {
      int t = pg * LF_PP + p;
      float z = t < nv ? ring_z[(head + t) & (LF_RING - 1)] : 1.0f;
      float u = 1.0f - z;
      float seed = GX ? u : u * u;
      ta[p] = seed;
      tb[p] = seed * z;
      z2[p] = 2.0f * z;
    }
    float acc[LF_PP][8];
    // the forward's bound is 1e-5: its basis is stepped as the twin's
    lf_product<4, !GX>(acc, ta, tb, z2, c_s + 4 * fg, M);
    if (w_lin != nullptr) {  // the linear term: Wf += low w_lin
#pragma unroll
      for (int p = 0; p < LF_PP; ++p) {
        int t = pg * LF_PP + p;
        ta[p] = t < nv ? ring_a[(head + t) & (LF_RING - 1)] : 0.0f;
      }
      lf_order(acc, ta, c_s + M * LF_FC + 4 * fg);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (pg == h) {
#pragma unroll
        for (int p = 0; p < LF_PP; ++p) {
          float* w = wf_s + p * LF_FC + 4 * fg;
          *reinterpret_cast<float4*>(w) =
              make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
          *reinterpret_cast<float4*>(w + LF_FC / 2) =
              make_float4(acc[p][4], acc[p][5], acc[p][6], acc[p][7]);
        }
      }
      __syncwarp();
      for (int t = 0; t < LF_PP; ++t) {
        int e = h * LF_PP + t;
        if (e >= nv) break;
        int q = (head + e) & (LF_RING - 1);
        int gi = ring_i[q], gj = ring_j[q];
        if (gi != cur) {
          if (cur >= 0) commit(cur);
          cur = gi;
          run[0] = run[1] = run[2] = run[3] = 0.0f;
        }
        float4 w = *reinterpret_cast<const float4*>(wf_s + t * LF_FC +
                                                    4 * lane);
        float4 v = lf_ld4(in + (size_t)gj * F, f0 + 4 * lane, F, vec);
        run[0] = fmaf(w.x, v.x, run[0]);
        run[1] = fmaf(w.y, v.y, run[1]);
        run[2] = fmaf(w.z, v.z, run[2]);
        run[3] = fmaf(w.w, v.w, run[3]);
      }
      __syncwarp();
    }
  };

  for (; row < row_end; row += LF_W) {
    const int s = row / A, r = row - s * A;
    lf_geo<HAS_CELL>(geo, cell, inv, s, cur_s, lane);
    const float* ps = pos + (size_t)s * A * 3;
    const float pi[3] = {ps[r * 3], ps[r * 3 + 1], ps[r * 3 + 2]};
    int n_row = 0;
    for (int j0 = 0; j0 < A; j0 += 32) {
      const int j = j0 + lane;
      const bool valid = j < A;
      float pj[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) pj[k] = valid ? ps[j * 3 + k] : 0.0f;
      float e[3], d, z;
      lf_geom<HAS_CELL>(pi, pj, geo, valid, rcut, d_min, scale, e, d, z);
      const bool live = z != 1.0f;
      const unsigned vote = __ballot_sync(0xffffffffu, live);
      if (live) {
        int q = (tail + __popc(vote & ((1u << lane) - 1u))) & (LF_RING - 1);
        ring_i[q] = row;
        ring_j[q] = s * A + j;
        ring_z[q] = z;
        ring_a[q] = j != r ? fminf(d - d_min, 0.0f) : 0.0f;
      }
      __syncwarp();
      tail += __popc(vote);
      n_row += __popc(vote);
      while (tail - head >= LF_PB) {
        batch(LF_PB);
        head += LF_PB;
      }
    }
    if (n_row == 0) {  // no live pair: the sum is empty
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int f = f0 + 4 * lane + k;
        const size_t o = (size_t)row * F + f;
        if (f < F) out[o] = 0.0f - w0[f] * in[o];
      }
    }
  }
  if (tail > head) batch(tail - head);
  if (cur >= 0) commit(cur);
}

// cheb_bwd_gd at fp32: one launch per (blocks over the rows, feature
// chunk); chunk 0 writes row_part [S, A, 3], chunk c > 0 slab c - 1 of
// col_part [S, n_slabs, A, 3].
template <bool HAS_CELL>
__global__ void __launch_bounds__(LF_W * 32, LF_GD_MINB)
cheb_gd_ffma_kernel(const float* __restrict__ pos,
                    const float* __restrict__ x, const float* __restrict__ g,
                    const float* __restrict__ c2,
                    const float* __restrict__ cell,
                    const float* __restrict__ inv,
                    float* __restrict__ row_part,
                    float* __restrict__ col_part, int S, int A, int F, int M,
                    int n_slabs, float rcut, float d_min, float scale,
                    int vec_in) {
  extern __shared__ float4 lf_smem4[];
  float* c_s = reinterpret_cast<float*>(lf_smem4);  // [M][LF_FC]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int fg = lane & 15, pg = lane >> 4;
  const int chunk = blockIdx.y, f0 = chunk * LF_FC;
  const bool vec = vec_in != 0;
  float* cb_s = c_s + (size_t)M * LF_FC + warp * LF_GD_WARP;  // [LF_PB][4]
  int* ring_i = reinterpret_cast<int*>(cb_s + 4 * LF_PB);
  int* ring_j = ring_i + LF_RING;
  float* ring_z = reinterpret_cast<float*>(ring_j + LF_RING);
  float* ring_d = ring_z + LF_RING;
  float* ring_r = ring_d + LF_RING;  // [3][LF_RING]
  float* geo = ring_r + 3 * LF_RING;
  lf_stage(c_s, c2, nullptr, M, f0, F);

  int row, row_end;
  lf_rows(S, A, warp, row, row_end);
  int head = 0, tail = 0, cur = -1, cur_s = -1;
  float run[3] = {0.0f, 0.0f, 0.0f};
  // row r's side of this chunk into its slab
  auto store = [&](int r, float v0, float v1, float v2) {
    if (lane == 0) {
      int s = r / A;
      float* o = chunk == 0
                     ? row_part + (size_t)r * 3
                     : col_part + (((size_t)s * n_slabs + chunk - 1) * A +
                                   (r - s * A)) * 3;
      o[0] = v0;
      o[1] = v1;
      o[2] = v2;
    }
  };
  auto commit = [&](int r) { store(r, run[0], run[1], run[2]); };
  auto batch = [&](int nv) {
    float ta[LF_PP], tb[LF_PP], z2[LF_PP];
#pragma unroll
    for (int p = 0; p < LF_PP; ++p) {
      int t = pg * LF_PP + p;
      float z = t < nv ? ring_z[(head + t) & (LF_RING - 1)] : 1.0f;
      ta[p] = 1.0f;
      tb[p] = z;
      z2[p] = 2.0f * z;
    }
    float acc[LF_PP][8];
    lf_product<1, false>(acc, ta, tb, z2, c_s + 4 * fg, M);
    // sum_f Wf (g_i x_j + g_j x_i) over this lane's features
    float part[LF_PP];
#pragma unroll
    for (int p = 0; p < LF_PP; ++p) {
      int t = pg * LF_PP + p, q = (head + t) & (LF_RING - 1);
      bool ok = t < nv;
      const size_t gi = ok ? ring_i[q] : 0, gj = ok ? ring_j[q] : 0;
      float v = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int f = f0 + h * (LF_FC / 2) + 4 * fg;
        float4 a = lf_ld4(g + gi * F, f, F, vec);
        float4 b = lf_ld4(x + gj * F, f, F, vec);
        float4 c = lf_ld4(g + gj * F, f, F, vec);
        float4 e = lf_ld4(x + gi * F, f, F, vec);
        v = fmaf(acc[p][4 * h], fmaf(a.x, b.x, c.x * e.x), v);
        v = fmaf(acc[p][4 * h + 1], fmaf(a.y, b.y, c.y * e.y), v);
        v = fmaf(acc[p][4 * h + 2], fmaf(a.z, b.z, c.z * e.z), v);
        v = fmaf(acc[p][4 * h + 3], fmaf(a.w, b.w, c.w * e.w), v);
      }
      part[p] = ok ? v : 0.0f;
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
#pragma unroll
      for (int p = 0; p < LF_PP; ++p)
        part[p] += __shfl_xor_sync(0xffffffffu, part[p], off);
    if (fg == 0) {
#pragma unroll
      for (int p = 0; p < LF_PP; ++p) {
        int t = pg * LF_PP + p, q = (head + t) & (LF_RING - 1);
        if (t < nv) {
          float w = ((1.0f - ring_z[q]) * part[p]) / ring_d[q];
#pragma unroll
          for (int k = 0; k < 3; ++k)
            cb_s[t * 4 + k] = -w * ring_r[k * LF_RING + q];
        }
      }
    }
    __syncwarp();
    for (int t = 0; t < nv; ++t) {
      int gi = ring_i[(head + t) & (LF_RING - 1)];
      if (gi != cur) {
        if (cur >= 0) commit(cur);
        cur = gi;
        run[0] = run[1] = run[2] = 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) run[k] += cb_s[t * 4 + k];
    }
    __syncwarp();
  };

  for (; row < row_end; row += LF_W) {
    const int s = row / A, r = row - s * A;
    lf_geo<HAS_CELL>(geo, cell, inv, s, cur_s, lane);
    const float* ps = pos + (size_t)s * A * 3;
    const float pi[3] = {ps[r * 3], ps[r * 3 + 1], ps[r * 3 + 2]};
    int n_row = 0;
    for (int j0 = 0; j0 < A; j0 += 32) {
      const int j = j0 + lane;
      const bool valid = j < A;
      float pj[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) pj[k] = valid ? ps[j * 3 + k] : 0.0f;
      float e[3], d, z;
      lf_geom<HAS_CELL>(pi, pj, geo, valid, rcut, d_min, scale, e, d, z);
      const bool live = valid && j != r && d < rcut;
      const unsigned vote = __ballot_sync(0xffffffffu, live);
      if (live) {
        int q = (tail + __popc(vote & ((1u << lane) - 1u))) & (LF_RING - 1);
        ring_i[q] = row;
        ring_j[q] = s * A + j;
        ring_z[q] = z;
        ring_d[q] = d;
#pragma unroll
        for (int k = 0; k < 3; ++k) ring_r[k * LF_RING + q] = e[k];
      }
      __syncwarp();
      tail += __popc(vote);
      n_row += __popc(vote);
      while (tail - head >= LF_PB) {
        batch(LF_PB);
        head += LF_PB;
      }
    }
    if (n_row == 0) store(row, 0.0f, 0.0f, 0.0f);  // no live pair
  }
  if (tail > head) batch(tail - head);
  if (cur >= 0) commit(cur);
}

// cheb_bwd_gxgd at fp32 (the per-block backward of blocks 2..B): gx and
// gpos in one launch, on the CUDA cores, over the live pairs only.
//
// Replaces _cheb_bwd_kernel with need_gx=True, need_gd=True
// (flashmd_tpu/ops/pallas/cheb_kernel.py:476) at fp32, as
// cheb_gxgd_mma_kernel does at bf16 and bf16x3. Per pair p = (i, j) with
// z != 1 it forms two filters from the recurrence on T_m (seeds 1, z):
//     Wq[p, f] = (1-z) sum_{k < MQ} T_k q_k[f] + low_p w_lin[f]
//     Wc[p, f] = sum_{m < M2} T_m c2_m[f]
// and sums them as the gx and gd kernels do:
//     gx[i, f] = sum_p Wq[p, f] g[j_p, f] - w0[f] g[i, f]
//     W_p      = (1-z_p) / d_p sum_f Wc[p, f] (g[i, f] x[j, f]
//                                              + g[j, f] x[i, f])
//     gpos[i]  = -sum_p W_p rel_p       (d < rcut off the diagonal)
// Bound: operations, 2 * live pairs * F * (MQ + M2) FLOP at the 67
// TFLOP/s float32 peak: at the per-block fp32 slice's (128, 128) fit
// (871,318 live pairs, F = 128) 0.8556 ms.
//
// Design: cheb_rows_ffma_kernel's and cheb_gd_ffma_kernel's machinery in
// one launch. A warp owns whole rows and compacts their pairs with z != 1
// (gx's live set: it keeps the diagonal, whose share the epilogue removes
// as w0 g[i]) into its ring, each entry with d, rel and low. A pair at d <
// rcut whose z rounds to exactly 1.0f is in gd's keep mask but not in the
// ring: exact, since its W carries the factor 1 - z = 0. Every GG_PB pairs
// the warp takes two product passes over the batch, sharing its scan, ring
// and geometry: Wq against q (staged with w_lin once per block), then Wc
// against c2 (staged beside it); each is lf_product's register-tiled
// float32 product (8 pairs x 8 features a lane, 32 FMAs per shared load),
// and the two passes reuse its 64 accumulators (two sets do not fit in
// 255 registers). gx: Wq to the warp's shared rows, then a running row sum
// of Wq g[j] in ring order, written as sum - w0 g[i]; gd: W_p of each pair
// (0 outside d < rcut, i != j) and -W rel summed per row in ring order:
// W_ij + W_ji from one Wc, so no column partial crosses a row. Feature
// chunks (F > 128) as cheb_gd_ffma_kernel: gx chunks own their features,
// gd chunk 0 writes row_part and chunk c > 0 slab c - 1 of col_part,
// summed by gd_reduce_kernel in chunk order; at F <= 128 the kernel writes
// gpos itself and no reduce runs. tools/cheb_ffma_variants.py times the
// other designs (one pass with both filters at 4 pairs a lane, 16 FMAs per
// shared load, q and c2 apart or interleaved in one table) and the
// unrolling. No atomics; every sum in a fixed order.
constexpr int GG_PP = LF_PP;      // pairs per lane
constexpr int GG_PB = 2 * GG_PP;  // pairs per batch
// Blocks per SM that the register budget must allow.
constexpr int GG_MINB = 1;
// per-warp shared floats: Wq half batch, -W rel per pair, ring (row,
// column, z, low, d, rel), cell
constexpr int GG_WARP = GG_PP * LF_FC + 4 * GG_PB + 8 * LF_RING + 32;

template <bool HAS_CELL>
__global__ void __launch_bounds__(LF_W * 32, GG_MINB)
cheb_gxgd_ffma_kernel(const float* __restrict__ pos,
                      const float* __restrict__ x,
                      const float* __restrict__ g,
                      const float* __restrict__ q,
                      const float* __restrict__ c2,
                      const float* __restrict__ w0,
                      const float* __restrict__ w_lin,
                      const float* __restrict__ cell,
                      const float* __restrict__ inv, float* __restrict__ gx,
                      float* __restrict__ row_part,
                      float* __restrict__ col_part, int S, int A, int F,
                      int MQ, int M2, int n_slabs, float rcut, float d_min,
                      float scale, int vec_in) {
  extern __shared__ float4 lf_smem4[];
  float* q_s = reinterpret_cast<float*>(lf_smem4);  // [MQ][LF_FC]
  float* wl_s = q_s + (size_t)MQ * LF_FC;           // [LF_FC]: w_lin
  float* c2_s = wl_s + LF_FC;                       // [M2][LF_FC]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int fg = lane & 15, pg = lane >> 4;
  const int chunk = blockIdx.y, f0 = chunk * LF_FC;
  const bool vec = vec_in != 0;
  float* wq_s = c2_s + (size_t)M2 * LF_FC + warp * GG_WARP;  // [GG_PP][FC]
  float* cb_s = wq_s + GG_PP * LF_FC;                         // [GG_PB][4]
  int* ring_i = reinterpret_cast<int*>(cb_s + 4 * GG_PB);
  int* ring_j = ring_i + LF_RING;
  float* ring_z = reinterpret_cast<float*>(ring_j + LF_RING);
  float* ring_a = ring_z + LF_RING;
  float* ring_d = ring_a + LF_RING;
  float* ring_r = ring_d + LF_RING;  // [3][LF_RING]
  float* geo = ring_r + 3 * LF_RING;
  lf_stage(q_s, q, w_lin, MQ, f0, F);
  lf_stage(c2_s, c2, nullptr, M2, f0, F);

  int row, row_end;
  lf_rows(S, A, warp, row, row_end);
  int head = 0, tail = 0, cur_x = -1, cur_d = -1, cur_s = -1;
  float run_x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float run_d[3] = {0.0f, 0.0f, 0.0f};
  // gx[r] = run_x - w0 g[r] at this lane's four features
  auto commit_x = [&](int r) {
    const size_t o = (size_t)r * F;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int f = f0 + 4 * lane + k;
      if (f < F) gx[o + f] = run_x[k] - w0[f] * g[o + f];
    }
  };
  // row r's side of this chunk's gpos into its slab
  auto store_d = [&](int r, float v0, float v1, float v2) {
    if (lane == 0) {
      int s = r / A;
      float* o = chunk == 0
                     ? row_part + (size_t)r * 3
                     : col_part + (((size_t)s * n_slabs + chunk - 1) * A +
                                   (r - s * A)) * 3;
      o[0] = v0;
      o[1] = v1;
      o[2] = v2;
    }
  };
  // gx of the batch's nv pairs from acc = sum_k T_k q_k
  auto gx_side = [&](float (&acc)[GG_PP][8], int nv) {
    float low[GG_PP];
#pragma unroll
    for (int p = 0; p < GG_PP; ++p) {
      int t = pg * GG_PP + p, qq = (head + t) & (LF_RING - 1);
      bool ok = t < nv;
      float u = ok ? 1.0f - ring_z[qq] : 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[p][k] *= u;
      low[p] = ok ? ring_a[qq] : 0.0f;
    }
    if (w_lin != nullptr) lf_order(acc, low, wl_s + 4 * fg);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (pg == h) {
#pragma unroll
        for (int p = 0; p < GG_PP; ++p) {
          float* w = wq_s + p * LF_FC + 4 * fg;
          *reinterpret_cast<float4*>(w) =
              make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
          *reinterpret_cast<float4*>(w + LF_FC / 2) =
              make_float4(acc[p][4], acc[p][5], acc[p][6], acc[p][7]);
        }
      }
      __syncwarp();
      for (int t = 0; t < GG_PP; ++t) {
        int e = h * GG_PP + t;
        if (e >= nv) break;
        int qq = (head + e) & (LF_RING - 1);
        int gi = ring_i[qq], gj = ring_j[qq];
        if (gi != cur_x) {
          if (cur_x >= 0) commit_x(cur_x);
          cur_x = gi;
          run_x[0] = run_x[1] = run_x[2] = run_x[3] = 0.0f;
        }
        float4 w = *reinterpret_cast<const float4*>(wq_s + t * LF_FC +
                                                    4 * lane);
        float4 v = lf_ld4(g + (size_t)gj * F, f0 + 4 * lane, F, vec);
        run_x[0] = fmaf(w.x, v.x, run_x[0]);
        run_x[1] = fmaf(w.y, v.y, run_x[1]);
        run_x[2] = fmaf(w.z, v.z, run_x[2]);
        run_x[3] = fmaf(w.w, v.w, run_x[3]);
      }
      __syncwarp();
    }
  };
  // gpos of the batch's nv pairs from acc = sum_m T_m c2_m
  auto gd_side = [&](float (&acc)[GG_PP][8], int nv) {
    float part[GG_PP];
#pragma unroll
    for (int p = 0; p < GG_PP; ++p) {
      int t = pg * GG_PP + p, qq = (head + t) & (LF_RING - 1);
      bool ok = t < nv;
      const size_t gi = ok ? ring_i[qq] : 0, gj = ok ? ring_j[qq] : 0;
      float v = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int f = f0 + h * (LF_FC / 2) + 4 * fg;
        float4 a = lf_ld4(g + gi * F, f, F, vec);
        float4 b = lf_ld4(x + gj * F, f, F, vec);
        float4 c = lf_ld4(g + gj * F, f, F, vec);
        float4 e = lf_ld4(x + gi * F, f, F, vec);
        v = fmaf(acc[p][4 * h], fmaf(a.x, b.x, c.x * e.x), v);
        v = fmaf(acc[p][4 * h + 1], fmaf(a.y, b.y, c.y * e.y), v);
        v = fmaf(acc[p][4 * h + 2], fmaf(a.z, b.z, c.z * e.z), v);
        v = fmaf(acc[p][4 * h + 3], fmaf(a.w, b.w, c.w * e.w), v);
      }
      part[p] = ok ? v : 0.0f;
    }
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
#pragma unroll
      for (int p = 0; p < GG_PP; ++p)
        part[p] += __shfl_xor_sync(0xffffffffu, part[p], off);
    if (fg == 0) {
#pragma unroll
      for (int p = 0; p < GG_PP; ++p) {
        int t = pg * GG_PP + p, qq = (head + t) & (LF_RING - 1);
        if (t < nv) {
          // gd's keep mask: within the cutoff, off the diagonal
          bool keep = ring_i[qq] != ring_j[qq] && ring_d[qq] < rcut;
          float w = keep ? ((1.0f - ring_z[qq]) * part[p]) / ring_d[qq]
                         : 0.0f;
#pragma unroll
          for (int k = 0; k < 3; ++k)
            cb_s[t * 4 + k] = -w * ring_r[k * LF_RING + qq];
        }
      }
    }
    __syncwarp();
    for (int t = 0; t < nv; ++t) {
      int gi = ring_i[(head + t) & (LF_RING - 1)];
      if (gi != cur_d) {
        if (cur_d >= 0) store_d(cur_d, run_d[0], run_d[1], run_d[2]);
        cur_d = gi;
        run_d[0] = run_d[1] = run_d[2] = 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) run_d[k] += cb_s[t * 4 + k];
    }
    __syncwarp();
  };
  // the nv (<= GG_PB) queued pairs from head: two product passes
  auto batch = [&](int nv) {
    float ta[GG_PP], tb[GG_PP], z2[GG_PP], acc[GG_PP][8];
    auto seed = [&]() {
#pragma unroll
      for (int p = 0; p < GG_PP; ++p) {
        int t = pg * GG_PP + p;
        float z = t < nv ? ring_z[(head + t) & (LF_RING - 1)] : 1.0f;
        ta[p] = 1.0f;
        tb[p] = z;
        z2[p] = 2.0f * z;
      }
    };
    seed();
    lf_product<1, false>(acc, ta, tb, z2, q_s + 4 * fg, MQ);
    gx_side(acc, nv);
    seed();
    lf_product<1, false>(acc, ta, tb, z2, c2_s + 4 * fg, M2);
    gd_side(acc, nv);
  };

  for (; row < row_end; row += LF_W) {
    const int s = row / A, r = row - s * A;
    lf_geo<HAS_CELL>(geo, cell, inv, s, cur_s, lane);
    const float* ps = pos + (size_t)s * A * 3;
    const float pi[3] = {ps[r * 3], ps[r * 3 + 1], ps[r * 3 + 2]};
    int n_row = 0;
    for (int j0 = 0; j0 < A; j0 += 32) {
      const int j = j0 + lane;
      const bool valid = j < A;
      float pj[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) pj[k] = valid ? ps[j * 3 + k] : 0.0f;
      float e[3], d, z;
      lf_geom<HAS_CELL>(pi, pj, geo, valid, rcut, d_min, scale, e, d, z);
      const bool live = z != 1.0f;
      const unsigned vote = __ballot_sync(0xffffffffu, live);
      if (live) {
        int qq = (tail + __popc(vote & ((1u << lane) - 1u))) & (LF_RING - 1);
        ring_i[qq] = row;
        ring_j[qq] = s * A + j;
        ring_z[qq] = z;
        ring_a[qq] = j != r ? fminf(d - d_min, 0.0f) : 0.0f;
        ring_d[qq] = d;
#pragma unroll
        for (int k = 0; k < 3; ++k) ring_r[k * LF_RING + qq] = e[k];
      }
      __syncwarp();
      tail += __popc(vote);
      n_row += __popc(vote);
      while (tail - head >= GG_PB) {
        batch(GG_PB);
        head += GG_PB;
      }
    }
    if (n_row == 0) {  // no live pair: both sums are empty
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int f = f0 + 4 * lane + k;
        const size_t o = (size_t)row * F + f;
        if (f < F) gx[o] = 0.0f - w0[f] * g[o];
      }
      store_d(row, 0.0f, 0.0f, 0.0f);
    }
  }
  if (tail > head) batch(tail - head);
  if (cur_x >= 0) commit_x(cur_x);
  if (cur_d >= 0) store_d(cur_d, run_d[0], run_d[1], run_d[2]);
}

// cheb_bwd_gd at the bf16 and bf16x3 tiers, on the tensor cores.
//
// Replaces _cheb_bwd_kernel with need_gx=False (flashmd_tpu/ops/pallas/
// cheb_kernel.py:476: chain_gd :533-545, gpos epilogue :639-685), as
// cheb_gd_ffma_kernel does at fp32. Bound: operations, 2 * live pairs * F * M
// FLOP of order products at 989 TFLOP/s, three times that at bf16x3: at
// the stacked slice (871,318 live pairs of 128 molecules, F = 384, M = 64)
// 0.0433 ms, at the bf16x3 slice (M = 96) 0.195 ms. The recurrence and gd
// add two FMAs per pair and order against F multiply-adds, the epilogue is
// O(A^2). Reached on an H100 80GB HBM3 at 700 W (chip_smoke, PERF.md):
// 1.31-1.32 ms stacked bf16, 3.3 % of the bound, 28x faster than the
// 64 x 64 CUDA-core tiles it replaced; 4.27-4.31 ms at bf16x3, 4.6 %.
// What holds it there: per mma (16 x 8 x 16) a lane also issues several
// instructions forming A and stepping the recurrence, and at 246-254
// registers only 8 warps share an SM to hide the mma.sync dependency
// chains.
//
// Design. One CTA per (16-row strip, molecule), MG_W warps. Pairs are
// taken in mma.m16n8k16 fragments (16 rows x 8 columns), so the tiling
// pads A only to the MMA grain (272 x 272 at A = 266, 1.046x all pairs).
// 1. Before any product, the warps test every 16 x 8 fragment of the
//    strip (d < rcut, i != j, in range; a warp vote per fragment) and
//    warp 0 compacts the live ones into a list; dead fragments are
//    skipped outright (exact: their W is zero by the keep mask whatever
//    gd is; 0.449x all pairs run at the slice's start positions). The
//    list is dealt round-robin to the warps, MG_NC fragments per warp and
//    round, so a strip's band of live fragments is shared.
// 2. Per feature chunk of FC, c2[:, chunk] and g[strip rows, chunk] are
//    staged in shared memory by cp.async, double-buffered, zero-padded
//    past F and A. Each warp loads g into registers in the A-fragment
//    layout and x of its fragments' columns in the B-fragment layout,
//    rounded (bf16) or split (bf16x3) as loaded. The B fragments stay in
//    registers for all M orders, so rounding x once per (strip, fragment,
//    chunk) costs 1/M of forming the A side: no pre-pass, no scratch.
// 3. Per order m the warp forms A = bf16(c2_m * g) in registers (float32
//    product, then round to nearest even, as the twin; at bf16x3 split into
//    hi and lo where the reference's _split_bf16 splits it) and reuses it
//    over its MG_NC fragments: U_m = A B^T by mma.sync into float32
//    accumulators (bf16x3: hi*hi, lo*hi, hi*lo into the same accumulator,
//    the reference's _mxu_dot order). Two orders are in flight at once.
// 4. The Chebyshev recurrence lives in the accumulator layout: lane l
//    holds the pairs (l/4, 2(l%4) + {0,1}) and (l/4 + 8, ...) of each
//    fragment, and carries T_m, T_{m+1}, 2z and gd for exactly those, one
//    FMA each for the recurrence and gd += T_m U_m per order. It restarts
//    per feature chunk (gd = sum_chunks sum_m T_m U_m^(chunk)). No pair
//    state reaches device memory.
// 5. Epilogue: W = (1-z) gd / d on live pairs, in registers. Column sides:
//    summed over the strip's 16 rows by shuffles in a fixed order, written
//    to this strip's slab of col_part (dead fragments' columns are written
//    zero). Row sides: each lane sums its columns over its warp's
//    fragments in list order, the quad by shuffles, then the warps in warp
//    order into row_part. No atomics: bitwise reproducible.
constexpr int MG_W = 4;
constexpr int MG_NC = 4;
constexpr int MG_ROWS = 16;

template <int TIER>
constexpr int MG_FC = TIER == TIER_X3 ? 32 : 64;

// Two floats as one bf16x2 mma operand, round to nearest even; `lo_k` is
// the lower k index (the lower 16 bits).
__device__ __forceinline__ unsigned pack_bf16x2(float lo_k, float hi_k) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_k, hi_k);
  return *reinterpret_cast<unsigned*>(&v);
}

// hi = bf16(v), lo = bf16(v - hi) of two floats, each packed as an operand.
__device__ __forceinline__ void split_bf16x2(float v0, float v1,
                                             unsigned& hi, unsigned& lo) {
  hi = pack_bf16x2(v0, v1);
  lo = pack_bf16x2(v0 - __uint_as_float(hi << 16),
                   v1 - __uint_as_float(hi & 0xffff0000u));
}

// d = a b + c for one m16n8k16 bf16 tile, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1,
                                         const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// d and z of this lane's four pairs of the fragment at (strip row r_base,
// column cf * 8), in accumulator order: rows (gq, gq, gq + 8, gq + 8),
// columns (2 tq, 2 tq + 1, 2 tq, 2 tq + 1); live = d < rcut off the
// diagonal in range (pair_geom parks out-of-range pairs at 2 rcut).
template <bool HAS_CELL>
__device__ __forceinline__ void mg_frag_geom(
    const float (*pr_s)[3], const float* pos, const float* geo, int r_base,
    int cf, int A, int gq, int tq, float rcut, float d_min, float scale,
    float (&d)[4], float (&z)[4], bool (&live)[4], float (&pcol)[2][3]) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    int j = cf * 8 + 2 * tq + c;
#pragma unroll
    for (int k = 0; k < 3; ++k) pcol[c][k] = j < A ? pos[j * 3 + k] : 0.0f;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    int rr = gq + 8 * (e >> 1), c = e & 1;
    int r = r_base + rr, j = cf * 8 + 2 * tq + c;
    pair_geom<HAS_CELL>(pr_s[rr], pcol[c], geo, r < A && j < A, rcut, d_min,
                        scale, d[e], z[e]);
    live[e] = r != j && d[e] < rcut;
  }
}

// c2[:, kc:kc+FC] into c2_s [M][FC] and g[strip rows, kc:kc+FC] into g_s
// [16][FC + 8], zero past F and A; one cp.async group.
template <int FC>
__device__ __forceinline__ void mg_stage(float* c2_s, float* g_s,
                                         const float* c2, const float* g,
                                         int kc, int r_base, int A, int F,
                                         int M, int tid) {
  for (int e = tid; e < M * FC; e += MG_W * 32) {
    int m = e / FC, k = kc + e % FC;
    bool in = k < F;
    cp_async4(c2_s + e, in ? c2 + (size_t)m * F + k : c2, in);
  }
  for (int e = tid; e < MG_ROWS * FC; e += MG_W * 32) {
    int rr = e / FC, k = kc + e % FC, r = r_base + rr;
    bool in = r < A && k < F;
    cp_async4(g_s + rr * (FC + 8) + e % FC, in ? g + (size_t)r * F + k : g,
              in);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One feature chunk of a warp's fragments: gd += sum_m T_m U_m over the
// chunk's features, the recurrence restarted at T_0 = 1, T_1 = z.
// cs: c2[:, chunk] [M][FC]; gs: g[strip rows, chunk] [16][FC + 8]; x is
// read at the fragments' columns. Fragments c >= n_on are computed on
// zero x (a branch per fragment cost more than the products).
template <int TIER>
__device__ __forceinline__ void mg_chunk(const float* cs, const float* gs,
                                         const float* x,
                                         const int (&cfs)[MG_NC], int n_on,
                                         int kc, int A, int F, int M,
                                         int lane, const float (&z2)[MG_NC][4],
                                         float (&gd)[MG_NC][4]) {
  constexpr bool X3 = TIER == TIER_X3;
  constexpr int FC = MG_FC<TIER>;
  constexpr int KS = FC / 16;
  constexpr int GLD = FC + 8;
  const int gq = lane >> 2, tq = lane & 3;
  // g at this lane's A-fragment places: rows gq, gq + 8; k = 2 tq + {0, 1}
  // and 2 tq + 8 + {0, 1} of each k16 step.
  float2 gr[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const float* g0 = gs + gq * GLD + ks * 16 + 2 * tq;
    const float* g1 = g0 + 8 * GLD;
    gr[ks][0] = *reinterpret_cast<const float2*>(g0);
    gr[ks][1] = *reinterpret_cast<const float2*>(g1);
    gr[ks][2] = *reinterpret_cast<const float2*>(g0 + 8);
    gr[ks][3] = *reinterpret_cast<const float2*>(g1 + 8);
  }
  // x at this lane's B-fragment places: column gq of the fragment, k =
  // 2 tq + {0, 1} and 2 tq + 8 + {0, 1}; rounded or split here, once for
  // all M orders.
  unsigned bh[MG_NC][KS][2], bl[MG_NC][KS][2];
#pragma unroll
  for (int c = 0; c < MG_NC; ++c) {
    int j = cfs[c] * 8 + gq;
    bool on = c < n_on && j < A;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int k = kc + ks * 16 + 2 * tq + 8 * h;
        float v0 = on && k < F ? x[(size_t)j * F + k] : 0.0f;
        float v1 = on && k + 1 < F ? x[(size_t)j * F + k + 1] : 0.0f;
        if constexpr (X3)
          split_bf16x2(v0, v1, bh[c][ks][h], bl[c][ks][h]);
        else
          bh[c][ks][h] = pack_bf16x2(v0, v1);
      }
  }
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  // u = U_m of every fragment: A = c2_m * g formed once, used MG_NC times
  auto product = [&](const float* cm, float (&u)[MG_NC][4]) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      float2 ca = *reinterpret_cast<const float2*>(cm + ks * 16 + 2 * tq);
      float2 cb = *reinterpret_cast<const float2*>(cm + ks * 16 + 2 * tq + 8);
      // A at (row gq | gq + 8) x (k | k + 8)
      const float2 av[4] = {
          make_float2(ca.x * gr[ks][0].x, ca.y * gr[ks][0].y),
          make_float2(ca.x * gr[ks][1].x, ca.y * gr[ks][1].y),
          make_float2(cb.x * gr[ks][2].x, cb.y * gr[ks][2].y),
          make_float2(cb.x * gr[ks][3].x, cb.y * gr[ks][3].y)};
      unsigned ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (X3)
          split_bf16x2(av[i].x, av[i].y, ah[i], al[i]);
        else
          ah[i] = pack_bf16x2(av[i].x, av[i].y);
      }
#pragma unroll
      for (int c = 0; c < MG_NC; ++c) {
        if (ks == 0)
          mma_bf16(u[c], ah, bh[c][ks][0], bh[c][ks][1], zero);
        else
          mma_bf16(u[c], ah, bh[c][ks][0], bh[c][ks][1], u[c]);
        if constexpr (X3) {
          mma_bf16(u[c], al, bh[c][ks][0], bh[c][ks][1], u[c]);
          mma_bf16(u[c], ah, bl[c][ks][0], bl[c][ks][1], u[c]);
        }
      }
    }
  };
  // Orders in pairs: ta = T_m, tb = T_{m+1}, advanced in place after both
  // (T_{m+2} = 2z T_{m+1} - T_m), so no state moves between orders.
  float ta[MG_NC][4], tb[MG_NC][4];
#pragma unroll
  for (int c = 0; c < MG_NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ta[c][e] = 1.0f;
      tb[c][e] = 0.5f * z2[c][e];
    }
  // two orders' products in flight, then their gd terms in order
  int m = 0;
  for (; m + 1 < M; m += 2) {
    float u0[MG_NC][4], u1[MG_NC][4];
    product(cs + m * FC, u0);
    product(cs + (m + 1) * FC, u1);
#pragma unroll
    for (int c = 0; c < MG_NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        gd[c][e] += ta[c][e] * u0[c][e];
        gd[c][e] += tb[c][e] * u1[c][e];
        ta[c][e] = z2[c][e] * tb[c][e] - ta[c][e];
        tb[c][e] = z2[c][e] * ta[c][e] - tb[c][e];
      }
  }
  if (m < M) {
    float u0[MG_NC][4];
    product(cs + m * FC, u0);
#pragma unroll
    for (int c = 0; c < MG_NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) gd[c][e] += ta[c][e] * u0[c][e];
  }
}

template <int TIER, bool HAS_CELL>
__global__ void __launch_bounds__(MG_W * 32)
cheb_gd_mma_kernel(const float* __restrict__ pos,
                   const float* __restrict__ x, const float* __restrict__ g,
                   const float* __restrict__ c2,
                   const float* __restrict__ cell,
                   const float* __restrict__ inv,
                   float* __restrict__ row_part, float* __restrict__ col_part,
                   int A, int F, int M, int n_strips, float rcut, float d_min,
                   float scale) {
  constexpr int FC = MG_FC<TIER>;
  constexpr int GLD = FC + 8;  // g_s row stride: conflict-free LDS.64
  extern __shared__ float4 mg_smem4[];
  float* c2_s = reinterpret_cast<float*>(mg_smem4);  // [2][M][FC]
  float* g_s = c2_s + 2 * (size_t)M * FC;            // [2][16][GLD]
  int* live_s = reinterpret_cast<int*>(g_s + 2 * MG_ROWS * GLD);  // [n_cf]
  int* list_s = live_s + (A + 7) / 8;                         // [n_cf]
  __shared__ float pr_s[MG_ROWS][3];
  __shared__ float geo_s[18];
  __shared__ float rp_s[MG_W][MG_ROWS][4];
  __shared__ int n_live_s;

  const int s = blockIdx.y;
  const int strip = blockIdx.x;
  const int r_base = strip * MG_ROWS;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int n_cf = (A + 7) / 8;
  pos += (size_t)s * A * 3;
  x += (size_t)s * A * F;
  g += (size_t)s * A * F;
  float* slab = col_part + ((size_t)s * n_strips + strip) * A * 3;

  if (tid < MG_ROWS * 3) {
    int r = tid / 3, k = tid % 3;
    pr_s[r][k] = (r_base + r < A) ? pos[(r_base + r) * 3 + k] : 0.0f;
  }
  stage_cell<HAS_CELL>(geo_s, cell, inv, s, tid);
  __syncthreads();

  // 1. Which fragments of the strip hold a live pair.
  for (int cf = warp; cf < n_cf; cf += MG_W) {
    float d[4], z[4], pcol[2][3];
    bool live[4];
    mg_frag_geom<HAS_CELL>(pr_s, pos, geo_s, r_base, cf, A, gq, tq, rcut,
                           d_min, scale, d, z, live, pcol);
    int any = __any_sync(0xffffffffu, live[0] || live[1] || live[2] ||
                                          live[3]);
    if (lane == 0) live_s[cf] = any;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < n_cf; base += 32) {
      int cf = base + lane;
      unsigned vote = __ballot_sync(0xffffffffu, cf < n_cf && live_s[cf]);
      if (cf < n_cf && live_s[cf])
        list_s[n + __popc(vote & ((1u << lane) - 1u))] = cf;
      n += __popc(vote);
    }
    if (lane == 0) n_live_s = n;
  }
  // dead fragments' columns of this strip's slab are zero
  for (int e = tid; e < A * 3; e += MG_W * 32)
    if (!live_s[e / 24]) slab[e] = 0.0f;
  __syncthreads();
  const int n_live = n_live_s;

  float rs[2] = {0.0f, 0.0f};
  float wp[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};

  // 2-4. Rounds of MG_W * MG_NC live fragments, in list order.
  for (int q0 = 0; q0 < n_live; q0 += MG_W * MG_NC) {
    int cfs[MG_NC];
    int n_on = 0;  // this warp's fragments of the round: entries c < n_on
#pragma unroll
    for (int c = 0; c < MG_NC; ++c) {
      int q = q0 + c * MG_W + warp;
      cfs[c] = q < n_live ? list_s[q] : 0;
      n_on += q < n_live;
    }
    float z2[MG_NC][4], gd[MG_NC][4];
#pragma unroll
    for (int c = 0; c < MG_NC; ++c) {
      float d[4], z[4], pcol[2][3];
      bool live[4];
      mg_frag_geom<HAS_CELL>(pr_s, pos, geo_s, r_base, cfs[c], A, gq, tq,
                             rcut, d_min, scale, d, z, live, pcol);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        z2[c][e] = 2.0f * z[e];
        gd[c][e] = 0.0f;
      }
    }

    // feature chunks, double-buffered: chunk kc + FC is copied in while
    // chunk kc is multiplied
    mg_stage<FC>(c2_s, g_s, c2, g, 0, r_base, A, F, M, tid);
    for (int kc = 0, b = 0; kc < F; kc += FC, b ^= 1) {
      if (kc + FC < F) {
        mg_stage<FC>(c2_s + (b ^ 1) * M * FC, g_s + (b ^ 1) * MG_ROWS * GLD,
                     c2, g, kc + FC, r_base, A, F, M, tid);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncthreads();  // chunk kc is in buffer b
      if (n_on > 0)
        mg_chunk<TIER>(c2_s + b * M * FC, g_s + b * MG_ROWS * GLD, x, cfs,
                       n_on, kc, A, F, M, lane, z2, gd);
      __syncthreads();  // buffer b is read: the next stage may refill it
    }

    // 5. W = (1-z) gd / d on live pairs; this round's sides.
#pragma unroll
    for (int c = 0; c < MG_NC; ++c) {
      if (c >= n_on) break;
      float d[4], z[4], pcol[2][3];
      bool live[4];
      mg_frag_geom<HAS_CELL>(pr_s, pos, geo_s, r_base, cfs[c], A, gq, tq,
                             rcut, d_min, scale, d, z, live, pcol);
      float col[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int h = e >> 1, cc = e & 1;
        float w = live[e] ? ((1.0f - z[e]) * gd[c][e]) / d[e] : 0.0f;
        const float* pi = pr_s[gq + 8 * h];
        if (HAS_CELL) {
          float e0, e1, e2;
          pair_rel<true>(pi, pcol[cc], geo_s, e0, e1, e2);
          wp[h][0] += w * e0;
          wp[h][1] += w * e1;
          wp[h][2] += w * e2;
          col[cc][1] += w * e0;
          col[cc][2] += w * e1;
          col[cc][3] += w * e2;
        } else {
          rs[h] += w;
          wp[h][0] += w * pcol[cc][0];
          wp[h][1] += w * pcol[cc][1];
          wp[h][2] += w * pcol[cc][2];
          col[cc][0] += w;
          col[cc][1] += w * pi[0];
          col[cc][2] += w * pi[1];
          col[cc][3] += w * pi[2];
        }
      }
      // column sides over the strip's rows: lanes of equal tq
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            col[cc][k] += __shfl_xor_sync(0xffffffffu, col[cc][k], off);
      if (gq == 0) {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          int j = cfs[c] * 8 + 2 * tq + cc;
          if (j < A) {
            float* o = slab + j * 3;
#pragma unroll
            for (int k = 0; k < 3; ++k)
              o[k] = HAS_CELL ? col[cc][k + 1]
                              : pcol[cc][k] * col[cc][0] - col[cc][k + 1];
          }
        }
      }
    }
  }

  // Row sides: the quad's columns, then the warps in order.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], off);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        wp[h][k] += __shfl_xor_sync(0xffffffffu, wp[h][k], off);
    }
  if (tq == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* o = rp_s[warp][gq + 8 * h];
      o[0] = rs[h];
      o[1] = wp[h][0];
      o[2] = wp[h][1];
      o[3] = wp[h][2];
    }
  }
  __syncthreads();
  if (tid < MG_ROWS && r_base + tid < A) {
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int w = 0; w < MG_W; ++w)
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] += rp_s[w][tid][k];
    float* o = row_part + ((size_t)s * A + r_base + tid) * 3;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      o[k] = HAS_CELL ? -v[k + 1] : pr_s[tid][k] * v[0] - v[k + 1];
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

// cheb_fwd and cheb_bwd_gx at the bf16 and bf16x3 tiers, on the tensor
// cores.
//
// Replaces _cheb_fwd_kernel (flashmd_tpu/ops/pallas/cheb_kernel.py:394:
// chain_matvec :421-429, low term :466-471) and _cheb_bwd_kernel with
// need_gd=False (:476: chain_gx :520-531, low term :609-617), as
// cheb_rows_ffma_kernel does at fp32. Bound: operations, 2 * live pairs * F
// FLOP per order product at 989 TFLOP/s (three times that at bf16x3): at
// the cheb slice (871,318 live pairs of 128 molecules, F = 128) 0.0108 ms
// for the 48 forward orders, 0.0111 ms for the 49 gx orders. The
// recurrence adds one FMA per pair and order against F multiply-adds.
//
// Design. One warp per CTA and per (16-row strip, 64-feature chunk,
// molecule); the CTA owns those output elements and sums them in a fixed
// order (no atomics: bitwise reproducible). Pairs are taken in 16 x 16
// fragments, the A operand of mma.m16n8k16 (rows i, K = source atoms j);
// the output strip 16 x 64 is eight n-tiles, 32 float32 accumulators per
// lane.
// 1. Skip rule. The warp tests every 16 x 16 fragment of its strip: it
//    runs only if some pair has z != 1.0f exactly (warp vote, compacted
//    list in shared memory). At z == 1 (d >= rcut, or out of range and
//    parked at 2 rcut by pair_geom) both seeds, (1-z)^2 and (1-z), are
//    exactly zero, so every order's basis value is zero and the fragment
//    adds nothing: skipping it is exact. Not "d < rcut, i != j" as in the
//    gd kernel: the diagonal pair sits at z = -1 and contributes
//    sum_m c_m Ttil_m(-1) x[i], which the epilogue removes as w0 x[i].
//    At the slice's start positions 19,072 of 36,992 fragments run (0.54x
//    all pairs). The linear term runs as one more product only on
//    fragments holding a pair with low = min(d - d_min, 0) != 0 (a second
//    list); low is exactly zero elsewhere.
// 2. The basis from the recurrence in the A-fragment layout: lane l holds
//    the pairs (l/4 + {0, 8}, 2(l%4) + {0, 1} + {0, 8}) of a fragment,
//    seeds T_0 = s, T_1 = s z with s = (1-z)^2 (fwd) or (1-z) (gx) from
//    the pair geometry, and steps T_{m+1} = 2z T_m - T_{m-1} in registers,
//    two orders in flight; each order's A operand is rounded (bf16) or
//    split (bf16x3) from those registers. No basis tile, no barrier.
// 3. Operands. Forward: x at this lane's B-fragment places, rounded or
//    split once per fragment and held for all M orders; the product P_m =
//    bf16(Ttil_m) @ bf16(x) is taken over a run of two fragments and
//    then scaled, acc += c_m * P_m, one FMA per accumulator: the
//    coefficient multiplies after the product, as in the reference. gx:
//    bf16(q_k * g) is formed per order in registers from g held in float32
//    (the float32 product, then round or split) and accumulated directly,
//    acc += That_k @ B (at bf16x3 each order's three passes go to a fresh
//    accumulator, added in float32). Coefficient rows (and w_lin for the
//    linear term) are staged once in shared memory, permuted so that a
//    lane reads its features with two or four 16-byte loads per order.
// 4. bf16x3 is three mma passes into one float32 accumulator (hi*hi,
//    lo*hi, hi*lo, the reference's _mxu_dot order).
// 5. Epilogue: out = acc - w0 * in (the diagonal's share), masked to
//    A x F. A and F are padded to 16 and 64 by zero operands.
// Reached at the cheb slice (H100 80GB HBM3, 700 W; chip_smoke, PERF.md
// §6): fwd 0.345 ms bf16 (3.1 % of the bound, 15x the CUDA-core kernel),
// gx 0.452 ms (2.5 %). What holds it there: the fragments run are 5.6x
// the live pairs (the 16 x 16 grain at A = 266), and per mma a lane also
// issues the scale FMAs (fwd) or forms B = bf16(q_k g) (gx: six
// instructions per mma), with one warp per CTA.
// Tried and measured at the slice's shapes (tools/cheb_rows_variants.py,
// times in PERF.md §6): a forward run of one, two or three fragments per
// scaling (two is fastest at bf16 and at bf16x3; three reaches 254
// registers); gx at bf16x3 with every order's passes summed in the mma
// accumulator (faster, but the tensor core's float32 sum is not round to
// nearest: it lies as far from the split twin as from the fp32 one, so
// each order takes a fresh accumulator added in float32); the cell's
// lattice held in registers (spills gx bf16x3 cell). A first form with
// the run as a generic lambda crashed nvcc (cicc segfault).
constexpr int RM_ROWS = 16;
constexpr int RM_FC = 64;
constexpr int RM_NT = RM_FC / 8;

// Fragments per run: two for the forward's product, one for gx.
template <bool GX>
constexpr int RM_NJ = GX ? 1 : 2;

// Row stride of the staged coefficients: gx lanes read 8 features each at
// gq * 8; forward lanes read 16 at tq * 20 (padded: no bank conflict).
template <bool GX>
constexpr int RM_CROW = GX ? RM_FC : 80;

// Place of chunk feature fl = 8t + n in a staged coefficient row: gx lane
// gq needs n = gq of every n-tile t; forward lane tq needs n = 2tq + {0,1}
// (its accumulator columns) of every t.
template <bool GX>
__device__ __forceinline__ int rm_cidx(int fl) {
  int t = fl >> 3, n = fl & 7;
  if constexpr (GX) return n * 8 + t;
  return (n >> 1) * 20 + 2 * t + (n & 1);
}

// Row and column of pair p of this lane in a 16 x 16 fragment at (r_base,
// j0), A-fragment order: p = 2 (h + 2 kk) + c -> row gq + 8h, column
// 2 tq + c + 8 kk.
__device__ __forceinline__ void rm_pair(int p, int r_base, int j0, int gq,
                                        int tq, int& r, int& j) {
  r = r_base + gq + 8 * ((p >> 1) & 1);
  j = j0 + 2 * tq + (p & 1) + 8 * (p >> 2);
}

// d and z of this lane's eight pairs of the fragment at columns j0..j0+15;
// prow holds the positions of rows gq and gq + 8 of the strip. The cell's
// 18 scalars are read from shared memory at each call (volatile), so that
// they are not held in registers across the order loop.
template <bool HAS_CELL>
__device__ __forceinline__ void rm_frag_geom(
    const float (&prow)[2][3], const float* pos, const float* geo_s,
    int r_base, int j0, int A, int gq, int tq, float rcut, float d_min,
    float scale, float (&d)[8], float (&z)[8]) {
  float geo[18];
  if (HAS_CELL) {
#pragma unroll
    for (int k = 0; k < 18; ++k)
      geo[k] = reinterpret_cast<const volatile float*>(geo_s)[k];
  }
  float pc[4][3];  // columns 2 tq + c + 8 kk at index c + 2 kk
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    int j = j0 + 2 * tq + (q & 1) + 8 * (q >> 1);
#pragma unroll
    for (int k = 0; k < 3; ++k) pc[q][k] = j < A ? pos[j * 3 + k] : 0.0f;
  }
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    int r, j;
    rm_pair(p, r_base, j0, gq, tq, r, j);
    pair_geom<HAS_CELL>(prow[(p >> 1) & 1], pc[(p & 1) + 2 * (p >> 2)], geo,
                        r < A && j < A, rcut, d_min, scale, d[p], z[p]);
  }
}

// low = min(d - d_min, 0) off the diagonal in range, else 0.
__device__ __forceinline__ float rm_low(float d, float d_min, int r, int j,
                                        int A) {
  return (r < A && j < A && r != j) ? fminf(d - d_min, 0.0f) : 0.0f;
}

// One order of a run into acc. Forward: acc += c_m * (bf16(T_m) @
// bf16(x)) over the run's fragments, c_m from the staged row cr at this
// lane's accumulator columns; gx: acc += bf16(T_k) @ bf16(q_k g), q_k from
// cr at this lane's B-fragment features. bf16x3: three passes each.
template <int TIER, bool GX, int NJ>
__device__ __forceinline__ void rm_product(
    const float (&tm)[NJ][8], const float* cr,
    const unsigned (&xh)[NJ][RM_NT][2], const unsigned (&xl)[NJ][RM_NT][2],
    const float (&gv)[NJ][RM_NT][4], int gq, int tq,
    float (&acc)[RM_NT][4]) {
  constexpr bool X3 = TIER == TIER_X3;
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  unsigned ah[NJ][4], al[NJ][4];
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (X3)
        split_bf16x2(tm[jj][2 * i], tm[jj][2 * i + 1], ah[jj][i], al[jj][i]);
      else
        ah[jj][i] = pack_bf16x2(tm[jj][2 * i], tm[jj][2 * i + 1]);
    }
  if constexpr (GX) {
    const float4 qa = *reinterpret_cast<const float4*>(cr + gq * 8);
    const float4 qb = *reinterpret_cast<const float4*>(cr + gq * 8 + 4);
    const float qv[RM_NT] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
    for (int t = 0; t < RM_NT; ++t)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        unsigned bh[2], bl[2];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          float v0 = qv[t] * gv[jj][t][2 * kk];
          float v1 = qv[t] * gv[jj][t][2 * kk + 1];
          if constexpr (X3)
            split_bf16x2(v0, v1, bh[kk], bl[kk]);
          else
            bh[kk] = pack_bf16x2(v0, v1);
        }
        if constexpr (X3) {
          // the order's three passes apart, then added in float32: summed
          // in the tensor core's accumulator over all orders they drift
          // from the split twin by ~3e-5 of max|gx|, as far as from fp32
          float p[4];
          mma_bf16(p, ah[jj], bh[0], bh[1], zero);
          mma_bf16(p, al[jj], bh[0], bh[1], p);
          mma_bf16(p, ah[jj], bl[0], bl[1], p);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[t][e] += p[e];
        } else {
          mma_bf16(acc[t], ah[jj], bh[0], bh[1], acc[t]);
        }
      }
  } else {
    float cv[2 * RM_NT];
#pragma unroll
    for (int v = 0; v < RM_NT / 2; ++v) {
      const float4 c4 = *reinterpret_cast<const float4*>(cr + tq * 20 + 4 * v);
      cv[4 * v] = c4.x;
      cv[4 * v + 1] = c4.y;
      cv[4 * v + 2] = c4.z;
      cv[4 * v + 3] = c4.w;
    }
#pragma unroll
    for (int t = 0; t < RM_NT; ++t) {
      float p[4];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        if (jj == 0)
          mma_bf16(p, ah[jj], xh[jj][t][0], xh[jj][t][1], zero);
        else
          mma_bf16(p, ah[jj], xh[jj][t][0], xh[jj][t][1], p);
        if constexpr (X3) {
          mma_bf16(p, al[jj], xh[jj][t][0], xh[jj][t][1], p);
          mma_bf16(p, ah[jj], xl[jj][t][0], xl[jj][t][1], p);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[t][e] = fmaf(cv[2 * t + (e & 1)], p[e], acc[t][e]);
    }
  }
}

// One run of NJ fragments (cfs[jj] < 0: absent, zero operands) into acc:
// every order (LOW = false) or the linear term (LOW = true: basis low,
// coefficient row M).
template <int TIER, bool GX, bool HAS_CELL, bool LOW, int NJ>
__device__ __forceinline__ void rm_run(
    const int (&cfs)[NJ], const float* in, const float* pos,
    const float* geo, const float (&prow)[2][3], const float* coef_s,
    int r_base, int f0, int A, int F, int M, float rcut, float d_min,
    float scale, int gq, int tq, float (&acc)[RM_NT][4]) {
  constexpr bool X3 = TIER == TIER_X3;
  constexpr int CROW = RM_CROW<GX>;
  // B-side operands at this lane's places: feature f0 + 8t + gq (n = gq),
  // source atoms j0 + 2tq + {0, 1} and + 8 (k). Forward: x rounded or
  // split once for all orders; gx: g in float32.
  unsigned xh[NJ][RM_NT][2], xl[NJ][RM_NT][2];
  float gv[NJ][RM_NT][4];
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
    for (int t = 0; t < RM_NT; ++t) {
      int f = f0 + 8 * t + gq;
      bool fin = cfs[jj] >= 0 && f < F;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        int j = cfs[jj] * RM_ROWS + 2 * tq + 8 * kk;
        float v0 = fin && j < A ? in[(size_t)j * F + f] : 0.0f;
        float v1 = fin && j + 1 < A ? in[(size_t)(j + 1) * F + f] : 0.0f;
        if constexpr (GX) {
          gv[jj][t][2 * kk] = v0;
          gv[jj][t][2 * kk + 1] = v1;
        } else if constexpr (X3) {
          split_bf16x2(v0, v1, xh[jj][t][kk], xl[jj][t][kk]);
        } else {
          xh[jj][t][kk] = pack_bf16x2(v0, v1);
        }
      }
    }
  // basis seeds T_0 (ta), T_1 (tb) and 2z; the linear term's low in ta
  float ta[NJ][8], tb[NJ][8], z2[NJ][8];
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    float d[8], z[8];
    if (cfs[jj] >= 0) {
      rm_frag_geom<HAS_CELL>(prow, pos, geo, r_base, cfs[jj] * RM_ROWS, A,
                             gq, tq, rcut, d_min, scale, d, z);
    } else {
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        d[p] = 2.0f * rcut;
        z[p] = 1.0f;
      }
    }
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      if constexpr (LOW) {
        int r, j;
        rm_pair(p, r_base, cfs[jj] * RM_ROWS, gq, tq, r, j);
        ta[jj][p] = cfs[jj] >= 0 ? rm_low(d[p], d_min, r, j, A) : 0.0f;
      } else {
        float u = 1.0f - z[p];
        float seed = GX ? u : u * u;
        ta[jj][p] = seed;
        tb[jj][p] = seed * z[p];
        z2[jj][p] = 2.0f * z[p];
      }
    }
  }
  if constexpr (LOW) {
    rm_product<TIER, GX, NJ>(ta, coef_s + (size_t)M * CROW, xh, xl, gv, gq,
                             tq, acc);
  } else {
    // orders in pairs: ta = T_m, tb = T_{m+1}, advanced in place
    int m = 0;
    for (; m + 1 < M; m += 2) {
      rm_product<TIER, GX, NJ>(ta, coef_s + (size_t)m * CROW, xh, xl, gv,
                               gq, tq, acc);
      rm_product<TIER, GX, NJ>(tb, coef_s + (size_t)(m + 1) * CROW, xh, xl,
                               gv, gq, tq, acc);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          ta[jj][p] = z2[jj][p] * tb[jj][p] - ta[jj][p];
          tb[jj][p] = z2[jj][p] * ta[jj][p] - tb[jj][p];
        }
    }
    if (m < M)
      rm_product<TIER, GX, NJ>(ta, coef_s + (size_t)m * CROW, xh, xl, gv, gq,
                               tq, acc);
  }
}

template <int TIER, bool GX, bool HAS_CELL>
__global__ void __launch_bounds__(32)
cheb_rows_mma_kernel(const float* __restrict__ pos,
                     const float* __restrict__ in,
                     const float* __restrict__ coef,
                     const float* __restrict__ w0,
                     const float* __restrict__ w_lin,
                     const float* __restrict__ cell,
                     const float* __restrict__ inv, float* __restrict__ out,
                     int A, int F, int M, float rcut, float d_min,
                     float scale) {
  constexpr int NJ = RM_NJ<GX>;
  constexpr int CROW = RM_CROW<GX>;
  const int n_jf = (A + RM_ROWS - 1) / RM_ROWS;
  extern __shared__ float4 rm_smem4[];
  float* coef_s = reinterpret_cast<float*>(rm_smem4);  // [M + 1][CROW]
  int* list_s = reinterpret_cast<int*>(coef_s + (size_t)(M + 1) * CROW);
  int* low_s = list_s + n_jf;  // [n_jf] each
  __shared__ float geo_s[18];

  const int s = blockIdx.z;
  const int r_base = blockIdx.x * RM_ROWS;
  const int f0 = blockIdx.y * RM_FC;
  const int lane = threadIdx.x;
  const int gq = lane >> 2, tq = lane & 3;
  pos += (size_t)s * A * 3;
  in += (size_t)s * A * F;
  out += (size_t)s * A * F;

  // coefficient rows 0..M-1 and w_lin as row M, zero past F
  for (int e = lane; e < (M + 1) * RM_FC; e += 32) {
    int m = e / RM_FC, fl = e % RM_FC, f = f0 + fl;
    float v = 0.0f;
    if (f < F)
      v = m < M ? coef[(size_t)m * F + f]
                : (w_lin != nullptr ? w_lin[f] : 0.0f);
    coef_s[m * CROW + rm_cidx<GX>(fl)] = v;
  }
  stage_cell<HAS_CELL>(geo_s, cell, inv, s, lane);
  float prow[2][3];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int r = r_base + gq + 8 * h;
#pragma unroll
    for (int k = 0; k < 3; ++k) prow[h][k] = r < A ? pos[r * 3 + k] : 0.0f;
  }
  __syncwarp();

  // 1. The fragments that run: z != 1 somewhere (all orders), low != 0
  // somewhere (the linear term).
  int n_live = 0, n_low = 0;
  for (int cf = 0; cf < n_jf; ++cf) {
    float d[8], z[8];
    rm_frag_geom<HAS_CELL>(prow, pos, geo_s, r_base, cf * RM_ROWS, A, gq,
                           tq, rcut, d_min, scale, d, z);
    bool live = false, low = false;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      int r, j;
      rm_pair(p, r_base, cf * RM_ROWS, gq, tq, r, j);
      live |= z[p] != 1.0f;
      low |= rm_low(d[p], d_min, r, j, A) != 0.0f;
    }
    if (__any_sync(0xffffffffu, live)) {
      if (lane == 0) list_s[n_live] = cf;
      ++n_live;
    }
    if (w_lin != nullptr && __any_sync(0xffffffffu, low)) {
      if (lane == 0) low_s[n_low] = cf;
      ++n_low;
    }
  }
  __syncwarp();

  float acc[RM_NT][4];
#pragma unroll
  for (int t = 0; t < RM_NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;

  // 2. The live fragments in list order, runs of NJ.
  for (int q0 = 0; q0 < n_live; q0 += NJ) {
    int cfs[NJ];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      cfs[jj] = q0 + jj < n_live ? list_s[q0 + jj] : -1;
    rm_run<TIER, GX, HAS_CELL, false, NJ>(cfs, in, pos, geo_s, prow, coef_s,
                                          r_base, f0, A, F, M, rcut, d_min,
                                          scale, gq, tq, acc);
  }
  // 3. The linear term on its fragments.
  for (int q0 = 0; q0 < n_low; q0 += NJ) {
    int cfs[NJ];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      cfs[jj] = q0 + jj < n_low ? low_s[q0 + jj] : -1;
    rm_run<TIER, GX, HAS_CELL, true, NJ>(cfs, in, pos, geo_s, prow, coef_s,
                                         r_base, f0, A, F, M, rcut, d_min,
                                         scale, gq, tq, acc);
  }

  // 4. The diagonal (z = -1) contributed w0 * in[i].
#pragma unroll
  for (int t = 0; t < RM_NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int r = r_base + gq + 8 * (e >> 1);
      int f = f0 + 8 * t + 2 * tq + (e & 1);
      if (r < A && f < F) {
        size_t o = (size_t)r * F + f;
        out[o] = acc[t][e] - w0[f] * in[o];
      }
    }
}

// cheb_bwd_gxgd at the bf16 and bf16x3 tiers, on the tensor cores.
//
// Replaces _cheb_bwd_kernel with need_gx=True, need_gd=True (flashmd_tpu/
// ops/pallas/cheb_kernel.py:476: chain_gx :520-531 and chain_gd :533-545
// on one recurrence, low term :609-617, gpos epilogue :639-685), as
// cheb_gxgd_ffma_kernel does at fp32. Bound: operations, 2 * live pairs * F
// FLOP per order product at 989 TFLOP/s (three times that at bf16x3),
// MQ gx orders plus M2 gd orders: at the per-block slice (871,318 live
// pairs, F = 128, MQ 49, M2 64) 0.0255 ms. The recurrence adds one FMA
// per pair and order and gd one more, against 2F multiply-adds of
// product.
//
// Design. One CTA of GM_W warps per (16-row strip, molecule); pairs in
// the 16 x 16 fragments of cheb_rows_mma_kernel, skipped by its rule (a
// fragment runs only if some pair has z != 1: the diagonal runs, which gx
// needs). All warps take the same fragment at once, each over its own
// 32-feature chunks of F (warp w: chunks w, w + GM_W, ...):
// 1. The warp holds T_m, T_{m+1} and 2z of its lane's 8 pairs as That_m =
//    (1-z) T_m in registers (seeds 1-z and (1-z) z), in the order of the
//    fragment's two m16n8 accumulator tiles, which is also the A layout of
//    one m16k16 tile: the same eight floats feed both halves.
// 2. gd half, orders m < M2: U_m = bf16(c2_m g[rows]) bf16(x[cols])^T over
//    the chunk (mma.m16n8k16, two k-steps, two n-tiles), gd += That_m U_m
//    in the accumulator layout. gd is linear in the features, so the
//    chunks' partial gd sum exactly; x's B fragments are rounded (split)
//    once per fragment and chunk and held for all orders.
// 3. gx half, orders m < MQ: acc[rows, chunk] += bf16(That_m) bf16(q_m
//    g[cols]) (packed from the same registers as the A operand, the B
//    operand formed per order from g held in float32); at bf16x3 each
//    order's three passes go to a fresh accumulator added in float32, as
//    in cheb_rows_mma_kernel. The linear term runs as one more product on
//    fragments holding a pair with low = min(d - d_min, 0) != 0. The gx
//    accumulators live in shared memory between fragments, each lane's
//    own slots: no barrier, any F.
// 4. Epilogue per fragment: the warps' gd (double-buffered in shared
//    memory, one barrier per fragment) summed in warp order by warp 0,
//    W = gd / d on pairs with d < rcut off the diagonal in range; row sides
//    in warp 0's registers over the fragments in list order, column sides
//    to this strip's slab of col_part (dead fragments' columns zero),
//    summed by gd_reduce_kernel in slab order. gx = acc - w0 g at the end.
//    No atomics: bitwise reproducible.
constexpr int GM_W = 4;
constexpr int GM_FC = 32;
constexpr int GM_ROWS = 16;

// Place of chunk feature fl (0..31) in a staged coefficient row. q (and
// w_lin): lane gq reads n = gq of the four n-tiles t (fl = 8t + n) as one
// float4. c2: lane tq reads its A-fragment features 16 ks + 8 h + 2 tq + b
// as two float4s.
__device__ __forceinline__ int gm_qidx(int fl) {
  return (fl & 7) * 4 + (fl >> 3);
}

__device__ __forceinline__ int gm_cidx(int fl) {
  return ((fl >> 1) & 3) * 8 + (fl >> 4) * 4 + ((fl >> 3) & 1) * 2 + (fl & 1);
}

// One order on one fragment and chunk: gd += h * U_m (c2m != nullptr) and
// acc += bf16(h) bf16(q_m g[cols]) (qm != nullptr). h is in the order of
// rm_pair: p = 4 nt + e is accumulator element e of n-tile nt.
template <int TIER>
__device__ __forceinline__ void gm_order(
    const float (&h)[8], const float* c2m, const float* qm, int gq, int tq,
    const float2 (&gr)[2][4], const unsigned (&xh)[2][2][2],
    const unsigned (&xl)[2][2][2], const float (&gc)[4][4], float (&gd)[8],
    float (&acc)[4][4]) {
  constexpr bool X3 = TIER == TIER_X3;
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (c2m != nullptr) {
    float u[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const float4 c = *reinterpret_cast<const float4*>(c2m + tq * 8 + ks * 4);
      // A = c2_m g at (row gq | gq + 8) x (k | k + 8)
      const float2 av[4] = {
          make_float2(c.x * gr[ks][0].x, c.y * gr[ks][0].y),
          make_float2(c.x * gr[ks][1].x, c.y * gr[ks][1].y),
          make_float2(c.z * gr[ks][2].x, c.w * gr[ks][2].y),
          make_float2(c.z * gr[ks][3].x, c.w * gr[ks][3].y)};
      unsigned ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (X3)
          split_bf16x2(av[i].x, av[i].y, ah[i], al[i]);
        else
          ah[i] = pack_bf16x2(av[i].x, av[i].y);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        if (ks == 0)
          mma_bf16(u[nt], ah, xh[ks][nt][0], xh[ks][nt][1], zero);
        else
          mma_bf16(u[nt], ah, xh[ks][nt][0], xh[ks][nt][1], u[nt]);
        if constexpr (X3) {
          mma_bf16(u[nt], al, xh[ks][nt][0], xh[ks][nt][1], u[nt]);
          mma_bf16(u[nt], ah, xl[ks][nt][0], xl[ks][nt][1], u[nt]);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < 8; ++p) gd[p] += h[p] * u[p >> 2][p & 3];
  }
  if (qm != nullptr) {
    unsigned ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (X3)
        split_bf16x2(h[2 * i], h[2 * i + 1], ah[i], al[i]);
      else
        ah[i] = pack_bf16x2(h[2 * i], h[2 * i + 1]);
    }
    const float4 q4 = *reinterpret_cast<const float4*>(qm + gq * 4);
    const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      unsigned bh[2], bl[2];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        float v0 = qv[nt] * gc[nt][2 * kk];
        float v1 = qv[nt] * gc[nt][2 * kk + 1];
        if constexpr (X3)
          split_bf16x2(v0, v1, bh[kk], bl[kk]);
        else
          bh[kk] = pack_bf16x2(v0, v1);
      }
      if constexpr (X3) {
        float p[4];
        mma_bf16(p, ah, bh[0], bh[1], zero);
        mma_bf16(p, al, bh[0], bh[1], p);
        mma_bf16(p, ah, bl[0], bl[1], p);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] += p[e];
      } else {
        mma_bf16(acc[nt], ah, bh[0], bh[1], acc[nt]);
      }
    }
  }
}

// Every order of one fragment (columns j0..j0+15) over the chunk at
// feature fc0: gd += sum_m That_m U_m, and this lane's gx accumulators
// (acc_s, 16 floats in shared memory) += sum_k That_k (q_k g) plus the
// linear term where `low`.
template <int TIER>
__device__ __forceinline__ void gm_chunk(
    const float* q_s, const float* c2_s, float* acc_s, const float* x,
    const float* g, int FP, int fc0, int r_base, int j0, int A, int F,
    int MQ, int M2, int gq, int tq, const float (&z)[8],
    const float (&lowv)[8], bool low, float (&gd)[8]) {
  constexpr bool X3 = TIER == TIER_X3;
  // x at this lane's B places of U: column j0 + 8 nt + gq, features fc0 +
  // 16 ks + 2 tq + 8 h + {0, 1}; rounded or split once for all orders
  unsigned xh[2][2][2], xl[2][2][2];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int j = j0 + 8 * nt + gq, k = fc0 + 16 * ks + 2 * tq + 8 * h;
        float v0 = j < A && k < F ? x[(size_t)j * F + k] : 0.0f;
        float v1 = j < A && k + 1 < F ? x[(size_t)j * F + k + 1] : 0.0f;
        if constexpr (X3)
          split_bf16x2(v0, v1, xh[ks][nt][h], xl[ks][nt][h]);
        else
          xh[ks][nt][h] = pack_bf16x2(v0, v1);
      }
  // g at this lane's A places of U (rows gq | gq + 8 of the strip, the
  // same features), float32: c2_m multiplies it per order
  float2 gr[2][4];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int r = r_base + gq + 8 * (i & 1);
      int k = fc0 + 16 * ks + 2 * tq + 8 * (i >> 1);
      gr[ks][i].x = r < A && k < F ? g[(size_t)r * F + k] : 0.0f;
      gr[ks][i].y = r < A && k + 1 < F ? g[(size_t)r * F + k + 1] : 0.0f;
    }
  // g at this lane's B places of the gx product: feature fc0 + 8 nt + gq,
  // columns j0 + 2 tq + {0, 1} + 8 kk, float32: q_k multiplies it per order
  float gc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      int f = fc0 + 8 * nt + gq, j = j0 + 2 * tq + (c & 1) + 8 * (c >> 1);
      gc[nt][c] = j < A && f < F ? g[(size_t)j * F + f] : 0.0f;
    }
  float acc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const float4 a4 = reinterpret_cast<const float4*>(acc_s)[nt];
    acc[nt][0] = a4.x;
    acc[nt][1] = a4.y;
    acc[nt][2] = a4.z;
    acc[nt][3] = a4.w;
  }
  // orders in pairs: ha = That_m, hb = That_{m+1}, advanced in place
  float ha[8], hb[8], z2[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    ha[p] = 1.0f - z[p];
    hb[p] = ha[p] * z[p];
    z2[p] = 2.0f * z[p];
  }
  const int M = MQ > M2 ? MQ : M2;
  const float* cm = c2_s + fc0;
  const float* qm = q_s + fc0;
  int m = 0;
  for (; m + 1 < M; m += 2) {
    gm_order<TIER>(ha, m < M2 ? cm + (size_t)m * FP : nullptr,
                   m < MQ ? qm + (size_t)m * FP : nullptr, gq, tq, gr, xh,
                   xl, gc, gd, acc);
    gm_order<TIER>(hb, m + 1 < M2 ? cm + (size_t)(m + 1) * FP : nullptr,
                   m + 1 < MQ ? qm + (size_t)(m + 1) * FP : nullptr, gq, tq,
                   gr, xh, xl, gc, gd, acc);
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      ha[p] = z2[p] * hb[p] - ha[p];
      hb[p] = z2[p] * ha[p] - hb[p];
    }
  }
  if (m < M)
    gm_order<TIER>(ha, m < M2 ? cm + (size_t)m * FP : nullptr,
                   m < MQ ? qm + (size_t)m * FP : nullptr, gq, tq, gr, xh,
                   xl, gc, gd, acc);
  // the linear term: basis low, operand w_lin g (staged as q's row MQ)
  if (low)
    gm_order<TIER>(lowv, nullptr, qm + (size_t)MQ * FP, gq, tq, gr, xh, xl,
                   gc, gd, acc);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
    reinterpret_cast<float4*>(acc_s)[nt] =
        make_float4(acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3]);
}

// bf16: three blocks (12 warps) per SM, at most 168 registers a thread
// (no spills; 17 % faster than two, tools/bwd_variants.py); bf16x3 spills
// there and keeps up to 255.
template <int TIER, bool HAS_CELL>
__global__ void __launch_bounds__(GM_W * 32, TIER == TIER_X3 ? 1 : 3)
cheb_gxgd_mma_kernel(const float* __restrict__ pos,
                     const float* __restrict__ x, const float* __restrict__ g,
                     const float* __restrict__ q, const float* __restrict__ c2,
                     const float* __restrict__ w0,
                     const float* __restrict__ w_lin,
                     const float* __restrict__ cell,
                     const float* __restrict__ inv, float* __restrict__ gx,
                     float* __restrict__ row_part,
                     float* __restrict__ col_part, int A, int F, int MQ,
                     int M2, int n_strips, float rcut, float d_min,
                     float scale) {
  const int n_jf = (A + GM_ROWS - 1) / GM_ROWS;
  const int n_ch = (F + GM_FC - 1) / GM_FC;
  const int FP = n_ch * GM_FC;
  extern __shared__ float4 gm_smem4[];
  float* q_s = reinterpret_cast<float*>(gm_smem4);  // [MQ + 1][FP]
  float* c2_s = q_s + (size_t)(MQ + 1) * FP;        // [M2][FP]
  float* gx_s = c2_s + (size_t)M2 * FP;             // [n_ch][32 lanes][16]
  float* gd_s = gx_s + (size_t)n_ch * 512;          // [2][GM_W][32][8]
  int* flag_s = reinterpret_cast<int*>(gd_s + 2 * GM_W * 256);  // [n_jf]
  int* list_s = flag_s + n_jf;                                  // [n_jf]
  __shared__ float geo_s[18];
  __shared__ int n_live_s;

  const int s = blockIdx.y;
  const int strip = blockIdx.x;
  const int r_base = strip * GM_ROWS;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  pos += (size_t)s * A * 3;
  x += (size_t)s * A * F;
  g += (size_t)s * A * F;
  gx += (size_t)s * A * F;
  float* slab = col_part + ((size_t)s * n_strips + strip) * A * 3;

  // q rows 0..MQ-1 and w_lin as row MQ, c2 rows, permuted per chunk, zero
  // past F; the gx accumulators zero
  for (int e = tid; e < (MQ + 1) * FP; e += GM_W * 32) {
    int m = e / FP, f = e % FP;
    float v = 0.0f;
    if (f < F)
      v = m < MQ ? q[(size_t)m * F + f]
                 : (w_lin != nullptr ? w_lin[f] : 0.0f);
    q_s[(size_t)m * FP + (f & ~31) + gm_qidx(f & 31)] = v;
  }
  for (int e = tid; e < M2 * FP; e += GM_W * 32) {
    int m = e / FP, f = e % FP;
    c2_s[(size_t)m * FP + (f & ~31) + gm_cidx(f & 31)] =
        f < F ? c2[(size_t)m * F + f] : 0.0f;
  }
  for (int e = tid; e < n_ch * 512; e += GM_W * 32) gx_s[e] = 0.0f;
  stage_cell<HAS_CELL>(geo_s, cell, inv, s, tid);
  float prow[2][3];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int r = r_base + gq + 8 * h;
#pragma unroll
    for (int k = 0; k < 3; ++k) prow[h][k] = r < A ? pos[r * 3 + k] : 0.0f;
  }
  __syncthreads();

  // 1. The fragments that run (bit 0: z != 1 somewhere) and those with a
  // linear term (bit 1: low != 0 somewhere), compacted in column order.
  for (int cf = warp; cf < n_jf; cf += GM_W) {
    float d[8], z[8];
    rm_frag_geom<HAS_CELL>(prow, pos, geo_s, r_base, cf * GM_ROWS, A, gq, tq,
                           rcut, d_min, scale, d, z);
    bool live = false, low = false;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      int r, j;
      rm_pair(p, r_base, cf * GM_ROWS, gq, tq, r, j);
      live |= z[p] != 1.0f;
      low |= rm_low(d[p], d_min, r, j, A) != 0.0f;
    }
    int any = __any_sync(0xffffffffu, live);
    int any_low = w_lin != nullptr && __any_sync(0xffffffffu, low);
    if (lane == 0) flag_s[cf] = any | (any_low << 1);
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < n_jf; base += 32) {
      int cf = base + lane;
      int fl = cf < n_jf ? flag_s[cf] : 0;
      unsigned vote = __ballot_sync(0xffffffffu, fl & 1);
      if (fl & 1)
        list_s[n + __popc(vote & ((1u << lane) - 1u))] = cf * 2 + (fl >> 1);
      n += __popc(vote);
    }
    if (lane == 0) n_live_s = n;
  }
  // dead fragments' columns of this strip's slab are zero
  for (int e = tid; e < A * 3; e += GM_W * 32)
    if (!(flag_s[e / (3 * GM_ROWS)] & 1)) slab[e] = 0.0f;
  __syncthreads();
  const int n_live = n_live_s;

  float rs[2] = {0.0f, 0.0f};
  float wp[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};

  // 2-4. The live fragments in list order, every warp on each.
  for (int qi = 0; qi < n_live; ++qi) {
    const int ent = list_s[qi];
    const int j0 = (ent >> 1) * GM_ROWS;
    float d[8], z[8], lowv[8];
    rm_frag_geom<HAS_CELL>(prow, pos, geo_s, r_base, j0, A, gq, tq, rcut,
                           d_min, scale, d, z);
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      int r, j;
      rm_pair(p, r_base, j0, gq, tq, r, j);
      lowv[p] = rm_low(d[p], d_min, r, j, A);
    }
    float gd[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int ch = warp; ch < n_ch; ch += GM_W)
      gm_chunk<TIER>(q_s, c2_s, gx_s + ch * 512 + lane * 16, x, g, FP,
                     ch * GM_FC, r_base, j0, A, F, MQ, M2, gq, tq, z, lowv,
                     ent & 1, gd);
    float* gdb = gd_s + (qi & 1) * GM_W * 256;
    float4* mine = reinterpret_cast<float4*>(gdb + warp * 256 + lane * 8);
    mine[0] = make_float4(gd[0], gd[1], gd[2], gd[3]);
    mine[1] = make_float4(gd[4], gd[5], gd[6], gd[7]);
    __syncthreads();  // every warp's gd of this fragment is in buffer qi & 1
    if (warp != 0) continue;

    // W = gd / d on live pairs, the warps' gd summed in warp order
    float col[4][4] = {};
    float pc[4][3];  // columns j0 + 2 tq + (c & 1) + 8 (c >> 1)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      int j = j0 + 2 * tq + (c & 1) + 8 * (c >> 1);
#pragma unroll
      for (int k = 0; k < 3; ++k) pc[c][k] = j < A ? pos[j * 3 + k] : 0.0f;
    }
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      float v = gdb[lane * 8 + p];
#pragma unroll
      for (int w = 1; w < GM_W; ++w) v += gdb[w * 256 + lane * 8 + p];
      int r, j;
      rm_pair(p, r_base, j0, gq, tq, r, j);
      bool keep = r < A && j < A && r != j && d[p] < rcut;
      float wv = keep ? v / d[p] : 0.0f;
      int h = (p >> 1) & 1, c = (p & 1) + 2 * (p >> 2);
      if (HAS_CELL) {
        float e0, e1, e2;
        pair_rel<true>(prow[h], pc[c], geo_s, e0, e1, e2);
        wp[h][0] += wv * e0;
        wp[h][1] += wv * e1;
        wp[h][2] += wv * e2;
        col[c][1] += wv * e0;
        col[c][2] += wv * e1;
        col[c][3] += wv * e2;
      } else {
        rs[h] += wv;
        wp[h][0] += wv * pc[c][0];
        wp[h][1] += wv * pc[c][1];
        wp[h][2] += wv * pc[c][2];
        col[c][0] += wv;
        col[c][1] += wv * prow[h][0];
        col[c][2] += wv * prow[h][1];
        col[c][3] += wv * prow[h][2];
      }
    }
    // column sides over the strip's rows: lanes of equal tq
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          col[c][k] += __shfl_xor_sync(0xffffffffu, col[c][k], off);
    if (gq == 0) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int j = j0 + 2 * tq + (c & 1) + 8 * (c >> 1);
        if (j < A) {
#pragma unroll
          for (int k = 0; k < 3; ++k)
            slab[j * 3 + k] = HAS_CELL ? col[c][k + 1]
                                       : pc[c][k] * col[c][0] - col[c][k + 1];
        }
      }
    }
  }

  // Row sides: warp 0's quads, in column order within the quad.
  if (warp == 0) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], off);
#pragma unroll
        for (int k = 0; k < 3; ++k)
          wp[h][k] += __shfl_xor_sync(0xffffffffu, wp[h][k], off);
      }
    if (tq == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int r = r_base + gq + 8 * h;
        if (r < A) {
          float* o = row_part + ((size_t)s * A + r) * 3;
#pragma unroll
          for (int k = 0; k < 3; ++k)
            o[k] = HAS_CELL ? -wp[h][k] : prow[h][k] * rs[h] - wp[h][k];
        }
      }
    }
  }

  // gx = acc - w0 g (the diagonal's share), each warp its own chunks.
  for (int ch = warp; ch < n_ch; ch += GM_W) {
    const float* a = gx_s + ch * 512 + lane * 16;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int r = r_base + gq + 8 * (e >> 1);
        int f = ch * GM_FC + 8 * nt + 2 * tq + (e & 1);
        if (r < A && f < F) {
          size_t o = (size_t)r * F + f;
          gx[o] = a[nt * 4 + e] - w0[f] * g[o];
        }
      }
  }
}

inline float fit_scale(float rcut, float d_min) {
  return (float)(2.0 / ((double)rcut - (double)d_min));
}

// f(std::integral_constant<int, TIER>) for the tiers the kernels are built
// for; cudaErrorInvalidValue for any other code.
template <class Fn>
int with_tier(int tier, Fn&& f) {
  switch (tier) {
    case TIER_FP32:
      return f(std::integral_constant<int, TIER_FP32>{});
    case TIER_BF16:
      return f(std::integral_constant<int, TIER_BF16>{});
    case TIER_X3:
      return f(std::integral_constant<int, TIER_X3>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15u) == 0;
}

// fp32: a grid of (blocks over the S * A rows, feature chunks of LF_FC),
// as many blocks as the card holds at once, shared out over the chunks;
// the results do not depend on the grid (each row is summed by one warp
// in its own order). The attribute call also refuses a C too large for
// shared memory.
template <class K>
int lf_grid(K kernel, size_t smem, int S, int A, int F, dim3& grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev, n_sm, occ;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, LF_W * 32,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  int n_fc = (F + LF_FC - 1) / LF_FC;
  int want = (n_sm * occ + n_fc - 1) / n_fc;
  int most = (S * A + LF_W - 1) / LF_W;
  grid = dim3(want < most ? want : most, n_fc);
  return 0;
}

template <bool GX, bool HAS_CELL>
int launch_rows_ffma(const float* pos, const float* in, const float* coef,
                     const float* w0, const float* w_lin, const float* cell,
                     const float* inv, float* out, int S, int A, int F, int M,
                     float rcut, float d_min, float scale,
                     cudaStream_t stream) {
  size_t smem = sizeof(float) * ((size_t)(M + 1) * LF_FC +
                                 (size_t)LF_W * LF_ROWS_WARP);
  dim3 grid;
  int rc = lf_grid(cheb_rows_ffma_kernel<GX, HAS_CELL>, smem, S, A, F, grid);
  if (rc != 0) return rc;
  int vec = F % 4 == 0 && aligned16(in);
  cheb_rows_ffma_kernel<GX, HAS_CELL><<<grid, LF_W * 32, smem, stream>>>(
      pos, in, coef, w0, w_lin, cell, inv, out, S, A, F, M, rcut, d_min,
      scale, vec);
  return (int)cudaGetLastError();
}

// bf16 and bf16x3: one warp per (16-row strip, 64-feature chunk, molecule).
template <int TIER, bool GX, bool HAS_CELL>
int launch_rows_mma(const float* pos, const float* in, const float* coef,
                    const float* w0, const float* w_lin, const float* cell,
                    const float* inv, float* out, int S, int A, int F, int M,
                    float rcut, float d_min, float scale,
                    cudaStream_t stream) {
  int n_jf = (A + RM_ROWS - 1) / RM_ROWS;
  size_t smem = sizeof(float) * (size_t)(M + 1) * RM_CROW<GX> +
                sizeof(int) * 2 * (size_t)n_jf;
  cudaError_t err = cudaFuncSetAttribute(
      cheb_rows_mma_kernel<TIER, GX, HAS_CELL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_jf, (F + RM_FC - 1) / RM_FC, S);
  cheb_rows_mma_kernel<TIER, GX, HAS_CELL><<<grid, 32, smem, stream>>>(
      pos, in, coef, w0, w_lin, cell, inv, out, A, F, M, rcut, d_min, scale);
  return (int)cudaGetLastError();
}

template <bool GX>
int launch_rows(const float* pos, const float* in, const float* coef,
                const float* w0, const float* w_lin, const float* cell,
                const float* inv, float* out, int S, int A, int F, int M,
                float rcut, float d_min, int tier, cudaStream_t stream) {
  if ((cell == nullptr) != (inv == nullptr))
    return (int)cudaErrorInvalidValue;
  if (S * A == 0) return 0;
  float scale = fit_scale(rcut, d_min);
  int rc = with_tier(tier, [&](auto t) {
    constexpr int T = decltype(t)::value;
    if constexpr (T == TIER_FP32) {
      return cell != nullptr
                 ? launch_rows_ffma<GX, true>(pos, in, coef, w0, w_lin, cell,
                                              inv, out, S, A, F, M, rcut,
                                              d_min, scale, stream)
                 : launch_rows_ffma<GX, false>(pos, in, coef, w0, w_lin,
                                               cell, inv, out, S, A, F, M,
                                               rcut, d_min, scale, stream);
    } else {
      return cell != nullptr
                 ? launch_rows_mma<T, GX, true>(pos, in, coef, w0, w_lin,
                                                cell, inv, out, S, A, F, M,
                                                rcut, d_min, scale, stream)
                 : launch_rows_mma<T, GX, false>(pos, in, coef, w0, w_lin,
                                                 cell, inv, out, S, A, F, M,
                                                 rcut, d_min, scale, stream);
    }
  });
  return rc != 0 ? rc : (int)cudaGetLastError();
}

// col_part slabs of cheb_bwd_gd's and cheb_bwd_gxgd's kernels (the
// wrappers size col_part with ops/cheb_kernel.py's gd_slabs, which the
// entry points check against this): fp32, one per feature chunk after the
// first; bf16 and bf16x3, one per 16-row strip.
inline int gd_slabs_of(int A, int F, int tier) {
  return tier == TIER_FP32 ? (F + LF_FC - 1) / LF_FC - 1
                           : (A + MG_ROWS - 1) / MG_ROWS;
}

template <int TIER, bool HAS_CELL>
int launch_gd(const float* pos, const float* x, const float* g,
              const float* c2, const float* cell, const float* inv,
              float* row_part, float* col_part, int S, int A, int F, int M,
              float rcut, float d_min, cudaStream_t stream) {
  int n_tiles = gd_slabs_of(A, F, TIER);
  float scale = fit_scale(rcut, d_min);
  cudaError_t err;
  if constexpr (TIER == TIER_FP32) {
    size_t smem = sizeof(float) * ((size_t)M * LF_FC +
                                   (size_t)LF_W * LF_GD_WARP);
    dim3 grid;
    int rc = lf_grid(cheb_gd_ffma_kernel<HAS_CELL>, smem, S, A, F, grid);
    if (rc != 0) return rc;
    int vec = F % 4 == 0 && aligned16(x) && aligned16(g);
    cheb_gd_ffma_kernel<HAS_CELL><<<grid, LF_W * 32, smem, stream>>>(
        pos, x, g, c2, cell, inv, row_part, col_part, S, A, F, M, n_tiles,
        rcut, d_min, scale, vec);
  } else {
    dim3 grid(n_tiles, S);
    constexpr int FC = MG_FC<TIER>;
    size_t smem = sizeof(float) * 2 * ((size_t)M * FC + MG_ROWS * (FC + 8)) +
                  sizeof(int) * 2 * (size_t)((A + 7) / 8);
    err = cudaFuncSetAttribute(cheb_gd_mma_kernel<TIER, HAS_CELL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    cheb_gd_mma_kernel<TIER, HAS_CELL><<<grid, MG_W * 32, smem, stream>>>(
        pos, x, g, c2, cell, inv, row_part, col_part, A, F, M, n_tiles, rcut,
        d_min, scale);
  }
  return (int)cudaGetLastError();
}

// col_part holds n_slabs = gd_slabs_of(A, F, tier) slabs, as cheb_bwd_gd's
// (cheb_gxgd_mma_kernel's strips are MG_ROWS rows too); at fp32 with no
// slab (F <= LF_FC) the kernel writes gpos itself.
template <int TIER, bool HAS_CELL>
int launch_gxgd(const float* pos, const float* x, const float* g,
                const float* q, const float* c2, const float* w0,
                const float* w_lin, const float* cell, const float* inv,
                float* gx, float* row_part, float* col_part, float* gpos,
                int S, int A, int F, int MQ, int M2, int n_slabs, float rcut,
                float d_min, cudaStream_t stream) {
  float scale = fit_scale(rcut, d_min);
  cudaError_t err;
  if constexpr (TIER == TIER_FP32) {
    size_t smem = sizeof(float) * ((size_t)(MQ + 1 + M2) * LF_FC +
                                   (size_t)LF_W * GG_WARP);
    dim3 grid;
    int rc = lf_grid(cheb_gxgd_ffma_kernel<HAS_CELL>, smem, S, A, F, grid);
    if (rc != 0) return rc;
    int vec = F % 4 == 0 && aligned16(x) && aligned16(g);
    cheb_gxgd_ffma_kernel<HAS_CELL><<<grid, LF_W * 32, smem, stream>>>(
        pos, x, g, q, c2, w0, w_lin, cell, inv, gx,
        n_slabs == 0 ? gpos : row_part, col_part, S, A, F, MQ, M2, n_slabs,
        rcut, d_min, scale, vec);
  } else {
    size_t fp = (size_t)(F + GM_FC - 1) / GM_FC * GM_FC;
    size_t smem = sizeof(float) * ((size_t)(MQ + 1 + M2) * fp + fp * 16 +
                                   2 * GM_W * 256) +
                  sizeof(int) * 2 * (size_t)n_slabs;
    err = cudaFuncSetAttribute(cheb_gxgd_mma_kernel<TIER, HAS_CELL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(n_slabs, S);
    cheb_gxgd_mma_kernel<TIER, HAS_CELL><<<grid, GM_W * 32, smem, stream>>>(
        pos, x, g, q, c2, w0, w_lin, cell, inv, gx, row_part, col_part, A, F,
        MQ, M2, n_slabs, rcut, d_min, scale);
  }
  return (int)cudaGetLastError();
}

// gpos = row side + column-side partials, in tile order.
int launch_gd_reduce(const float* row_part, const float* col_part,
                     float* gpos, int S, int A, int n_tiles,
                     cudaStream_t stream) {
  int total = S * A * 3;
  gd_reduce_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
      row_part, col_part, gpos, S, A, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int cheb_fwd(const float* pos, const float* x, const float* c,
             const float* w0, const float* w_lin, const float* cell,
             const float* inv, float* out, int S, int A, int F, int M,
             float rcut, float d_min, int tier, void* stream) {
  return launch_rows<false>(pos, x, c, w0, w_lin, cell, inv, out, S, A, F,
                            M, rcut, d_min, tier, (cudaStream_t)stream);
}

int cheb_bwd_gx(const float* pos, const float* g, const float* q,
                const float* w0, const float* w_lin, const float* cell,
                const float* inv, float* gx, int S, int A, int F, int M,
                float rcut, float d_min, int tier, void* stream) {
  return launch_rows<true>(pos, g, q, w0, w_lin, cell, inv, gx, S, A, F, M,
                           rcut, d_min, tier, (cudaStream_t)stream);
}

// col_part holds n_slabs slabs, which must be the tier's count.
int cheb_bwd_gd(const float* pos, const float* x, const float* g,
                const float* c2, const float* cell, const float* inv,
                float* row_part, float* col_part, float* gpos, int S, int A,
                int F, int M, int n_slabs, float rcut, float d_min, int tier,
                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((cell == nullptr) != (inv == nullptr) ||
      n_slabs != gd_slabs_of(A, F, tier))
    return (int)cudaErrorInvalidValue;
  if (S * A == 0) return 0;
  int rc = with_tier(tier, [&](auto t) {
    constexpr int T = decltype(t)::value;
    return cell != nullptr
               ? launch_gd<T, true>(pos, x, g, c2, cell, inv, row_part,
                                    col_part, S, A, F, M, rcut, d_min, st)
               : launch_gd<T, false>(pos, x, g, c2, cell, inv, row_part,
                                     col_part, S, A, F, M, rcut, d_min, st);
  });
  if (rc != 0) return rc;
  return launch_gd_reduce(row_part, col_part, gpos, S, A, n_slabs, st);
}

// col_part holds n_slabs slabs, which must be the tier's count (as
// cheb_bwd_gd's); at fp32 with none, one launch and no reduce.
int cheb_bwd_gxgd(const float* pos, const float* x, const float* g,
                  const float* q, const float* c2, const float* w0,
                  const float* w_lin, const float* cell, const float* inv,
                  float* gx, float* row_part, float* col_part, float* gpos,
                  int S, int A, int F, int MQ, int M2, int n_slabs,
                  float rcut, float d_min, int tier, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((cell == nullptr) != (inv == nullptr) ||
      n_slabs != gd_slabs_of(A, F, tier))
    return (int)cudaErrorInvalidValue;
  if (S * A == 0) return 0;
  int rc = with_tier(tier, [&](auto t) {
    constexpr int T = decltype(t)::value;
    return cell != nullptr
               ? launch_gxgd<T, true>(pos, x, g, q, c2, w0, w_lin, cell, inv,
                                      gx, row_part, col_part, gpos, S, A, F,
                                      MQ, M2, n_slabs, rcut, d_min, st)
               : launch_gxgd<T, false>(pos, x, g, q, c2, w0, w_lin, cell,
                                       inv, gx, row_part, col_part, gpos, S,
                                       A, F, MQ, M2, n_slabs, rcut, d_min,
                                       st);
  });
  if (rc != 0 || n_slabs == 0) return rc;
  return launch_gd_reduce(row_part, col_part, gpos, S, A, n_slabs, st);
}

}  // extern "C"
