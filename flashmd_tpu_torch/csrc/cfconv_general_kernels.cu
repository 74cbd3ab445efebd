// General-width exact-filter CFConv kernels for Hopper (sm_90a), plain C
// interface for ctypes. Built by flashmd_tpu_torch/ops/_build.py beside the
// tuned kernels of cfconv_dense_kernels.cu and cfconv_kernels.cu, whose
// tiles assume F = 128 filters and at most 64 radial functions
// (cfconv_tile.cuh). These take any F >= 1 and R >= 1, at fp32 and bf16;
// ops/cfconv_general.py routes every width the tuned kernels do not take
// here (F > 128 or R > 64; narrower filters are zero-padded to 128 and run
// on the tuned kernels).
//
// Two entry points, each for the dense (all pairs) and the neighbour-matrix
// path, replace the same TPU kernels as the tuned ones:
//
//   cfconv_general_fwd  <- cfconv_dense.py _fwd_kernel (:126) and
//                          cfconv.py _fwd_kernel (:137), one launch:
//     gf_dense_fwd_kernel, gf_nbr_fwd_kernel (fp32; gw_dense_fwd_kernel,
//     gw_nbr_fwd_kernel where their weights find no room; bf16 on the
//     tensor cores: gw_dense_fwd_mma_kernel, gw_nbr_fwd_mma_kernel, and
//     with the weights streamed gp_dense_fwd_kernel, gp_nbr_fwd_kernel):
//                          out[i] = sum_j W_ij cut_ij x[j] over the live
//                          pairs (d < rc, j != i) or live slots (mask set,
//                          d < rc, j = idx[i, k])
//   cfconv_general_bwd  <- cfconv_dense.py _bwd_kernel (:147) and
//                          cfconv.py _bwd_kernel (:163), two or three
//                          launches:
//     gf_bwd_kernel<GX, NBR, PANEL> (gw_bwd_kernel<GX, NBR, GT>; bf16:
//                          gw_bwd_mma_kernel<GX, NBR>, streamed
//                          gp_bwd_kernel<GX, NBR>): gd of
//                          every pair or slot (zero where dead) and,
//                          dense with GX, gx of the item's rows
//     dense_cfconv_gpos / cfconv_gpos (the tuned files' gpos passes)
//     gf_nbr_gx_kernel (gw_nbr_gx_kernel; bf16: gw_nbr_gx_mma_kernel,
//                          streamed gp_nbr_gx_kernel;
//                          neighbour matrix, when
//                          gx is asked for): gx[a] =
//                          sum over a's live incoming slots, in source-CSR
//                          order, of W cut g[i], W computed again
//
// with the geometry, rbf and filter MLP of the tuned kernels (pair_geom;
// rbf = exp(coeff (d - offset)^2) cut, W = tanh(rbf w0 + b0) w1).
//
// What bounds them on the H100: per live pair or slot the MLP costs
// R F + F F multiply-adds (78,336 at F 256, R 50; 23,296 at F 64, R 300)
// in the forward, twice that in the backward's first pass, against a few
// hundred bytes of input: arithmetic, at the 67 TFLOP/s float32 peak of
// the CUDA cores (fp32) and the 989 TFLOP/s bf16 peak of the tensor cores
// (bf16). The bf16 tier runs on the tensor cores, in
// cfconv_general_mma_kernels.cu (the entry points below hand it tiers 2
// and 3): gw_*_mma_kernel wherever its bf16 weights and one warp's tiles
// fit in a block's shared memory, gp_*_kernel where only panels of them do
// (F 256 R 200, F 640 R 8: family "streamed" of ops/cfconv_general.py); at
// wider widths (F 4,096 at R 8, say) it routes bf16 to the CUDA-core
// kernels here at tier 1 (family "wide"). cfconv_general.cuh holds what
// both sources share (the item loop, spans and votes, cp.async). The
// CUDA-core tiers run the kernels of
// the section "The CUDA-core tiers with their weights in shared memory"
// (gf_*: weights staged per block, or streamed through it in panels shared
// by the block's warps; 8 pairs x 8 columns a lane) wherever gf_layout finds
// room, and the first design's kernels (gw_*, below) where it finds none
// (Fp above 576) and for the forward and the gx pass at Fp = 64
// (gf_kind_layout). Design of the first design's kernels, the tuned kernels'
// ring with widths that are runtime values:
// - A persistent grid; each warp owns work items of DM_RW rows and votes
//   their pairs or slots 32 at a time into its live-pair ring (ring_push);
//   every 16 entries are one tile. Sums run in ring, slot and CSR order;
//   no atomics; results are bitwise reproducible.
// - Features in column chunks of 64 (a lane: 8 pairs x 4 columns, 32
//   accumulators, register-tiled float32 FMAs), R in chunks of 64 whose rbf
//   is computed from d and the offsets into a [16][64] tile when it is
//   needed. The tile's activations ([16][Fp] a0, and in the backward its
//   (1 - a0^2), then the cotangent and gt0) stay in the warp's shared
//   memory; w0, w1 and their transposes are read from device memory
//   through the read-only path (L1, L2: w1 at F 256 is 256 KB, more than
//   a block's shared memory holds beside the tiles). Warps a block: as many
//   as shared memory holds, at most 16 (8 in the backward). A width whose
//   tiles do not fit one warp's share of shared memory (Fp above 1,536 in
//   the backward, above 2,816 in the forward and the gx pass) keeps them
//   in a device-memory workspace instead (GT), same code.
// - The wrapper hands the weights zero-padded to Fp = F rounded up to 64
//   and Rq = R rounded up to 64 (w0 [Rq][Fp], w0^T [Fp][Rq], b0 [Fp], w1
//   and w1^T [Fp][Fp], offsets [Rq]) and rounded to bf16 at that tier, and
//   x and g padded to Fp: padded columns give tanh(0) = 0 and add exact
//   zeros, so no load is masked.
// - Precision tiers: tier 1 (bf16) rounds the operands of the four products to
//   bf16 where the twins do (rbf, a0, g_i x_j cut, gt0 here; the weights in
//   the wrapper); the products of bf16 values are exact in float32 and
//   accumulate in float32. tanh, the geometry, s_cut, gx and all sums stay
//   float32.
// - The neighbour-matrix backward's gx pass computes W again over the
//   source CSR (the tuned bf16 route) at both tiers instead of storing it:
//   the stored W would take 3.07 GB at S 128, A 266, K 88, F 256.

#include <type_traits>

#include "cfconv_general.cuh"
#include "cfconv_tile.cuh"

extern "C" int dense_cfconv_gpos(const float* pos, const float* gd,
                                 float* gpos, int S, int A, void* stream);
extern "C" int cfconv_gpos(const float* pos, const int* idx,
                           const unsigned char* mask, const int* offsets,
                           const int* slots, const float* gd, float* gpos,
                           int S, int A, int K, void* stream);
// The tensor-core tiers (tiers 2 and 3), in cfconv_general_mma_kernels.cu.
extern "C" int cfconv_general_mma_fwd(int nbr, const float* pos,
                                      const int* idx,
                                      const unsigned char* mask,
                                      const float* x, const float* w0,
                                      const float* b0, const float* w1,
                                      const float* off, const float* coeff,
                                      float* out, int S, int A, int K, int Fq,
                                      int R, int Rq, float rcut, int tier,
                                      void* stream);
extern "C" int cfconv_general_mma_bwd(
    int nbr, const float* pos, const int* idx, const unsigned char* mask,
    const int* csr_offsets, const int* csr_slots, const float* x,
    const float* g, const float* w0, const float* b0, const float* w1,
    const float* off, const float* coeff, float* gd, float* gpos, float* gx,
    int S, int A, int K, int Fq, int R, int Rq, float rcut, int tier,
    void* stream);

namespace {

constexpr int GW_PP = 8;        // pairs per lane: two groups of 8 pairs
constexpr int GW_CW = 64;       // columns per chunk: 16 lanes x 4
constexpr int GW_RC = 64;       // radial functions per rbf chunk
// Warps a block at most: 16 of the forward tiles (at most 128 registers a
// thread), 8 of the backward's, whose s_cut, se, sg and row indices beside
// the product's 64 registers would spill under 128.
constexpr int GW_MAX_WARPS = 16;
constexpr int GW_BWD_MAX_WARPS = 8;
constexpr int GW_GT_WARPS = 8;  // warps a block, tiles in device memory

// The weights and widths of a launch: w0 [Rq][Fp], w0t [Fp][Rq], b0 [Fp],
// w1 and w1t [Fp][Fp], off [Rq] (zero-padded, bf16-rounded at that tier);
// ws the per-warp tiles in device memory (GT launches) or null.
struct GwArgs {
  const float* w0;
  const float* w0t;
  const float* b0;
  const float* w1;
  const float* w1t;
  const float* off;
  const float* coeff;
  float* ws;
  int Fp, R, Rq, bf16, warp_floats;
  float rcut, arg_scale, dcut_scale;
};

// Floats of one warp's area: the activation tile [16][Fp] (and, in the
// backward, the (1 - a0^2) / gt0 tile [16][Fp]), the rbf / W cut chunk
// [16][64], per-pair d, cut, dcut [16][4], the item's rows [DM_RW][Fp] and
// the ring.
int gw_warp_floats(bool bwd, int Fp) {
  return ((bwd ? 2 : 1) * GW_TILE + DM_RW) * Fp + GW_TILE * GW_CW +
         4 * GW_TILE + DM_RING;
}

// Warps a block, dynamic shared memory and whether the tiles go to device
// memory: shared memory while one warp's area fits.
void gw_shape(bool bwd, int Fp, int& warps, int& smem, bool& gt) {
  long per = 4L * gw_warp_floats(bwd, Fp);
  gt = per > GW_SMEM_MAX;
  if (gt) {
    warps = GW_GT_WARPS;
    smem = 0;
  } else {
    const int most = bwd ? GW_BWD_MAX_WARPS : GW_MAX_WARPS;
    warps = (int)(GW_SMEM_MAX / per);
    if (warps > most) warps = most;
    smem = (int)(warps * per);
  }
}

__device__ __forceinline__ float gw_round(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// acc[q][c] += sum_{k < nk} a[q lda + k] w[k ldw + c] for the lane's pairs
// q < 8 (rows of a) and 4 columns c of w; nk a multiple of 4, the sum over
// k in order. a in the warp's tiles, w through the read-only path.
__device__ __forceinline__ void gw_prod(float (&acc)[GW_PP][4],
                                        const float* a, int lda,
                                        const float* __restrict__ w, int ldw,
                                        int nk) {
#pragma unroll 1
  for (int k = 0; k < nk; k += 4) {
    float4 av[GW_PP];
#pragma unroll
    for (int q = 0; q < GW_PP; ++q)
      av[q] = *reinterpret_cast<const float4*>(a + q * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b =
          __ldg(reinterpret_cast<const float4*>(w + (size_t)(k + kk) * ldw));
#pragma unroll
      for (int q = 0; q < GW_PP; ++q) {
        const float aq = kk == 0 ? av[q].x : kk == 1 ? av[q].y
                       : kk == 2 ? av[q].z : av[q].w;
        acc[q][0] = fmaf(aq, b.x, acc[q][0]);
        acc[q][1] = fmaf(aq, b.y, acc[q][1]);
        acc[q][2] = fmaf(aq, b.z, acc[q][2]);
        acc[q][3] = fmaf(aq, b.w, acc[q][3]);
      }
    }
  }
}

__device__ __forceinline__ void gw_zero(float (&acc)[GW_PP][4]) {
#pragma unroll
  for (int q = 0; q < GW_PP; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[q][c] = 0.0f;
}

// d, cut, dcut of the ring's entries head .. head + nv - 1 of the item at
// row r0 into pd_s [16][4] (padding entries: d = rc, cut = dcut = 0).
template <bool NBR>
__device__ __forceinline__ void gw_geometry(const int* ring, int head,
                                            int nv, int r0, const float* pos,
                                            const int* idx, int stride,
                                            float* pd_s, const GwArgs& a,
                                            int lane) {
  if (lane < GW_TILE) {
    float d = a.rcut, cut = 0.0f, dcut = 0.0f;
    if (lane < nv) {
      int ent = ring[(head + lane) & (DM_RING - 1)];
      float rel[3];
      pair_geom(pos + (r0 + (ent >> 16)) * 3,
                pos + df_partner<NBR>(idx, stride, r0, ent) * 3, true, a.rcut,
                a.arg_scale, a.dcut_scale, d, cut, dcut, rel);
    }
    pd_s[4 * lane] = d;
    pd_s[4 * lane + 1] = cut;
    pd_s[4 * lane + 2] = dcut;
  }
  __syncwarp();
}

// rbf of radial functions r0c .. r0c + 63 of the tile's pairs into ch_s
// [16][64], zero past R and for padding entries, tier-rounded.
__device__ __forceinline__ void gw_rbf_chunk(float* ch_s, const float* pd_s,
                                             int r0c, int nv, float coeff,
                                             const GwArgs& a, int lane) {
  for (int e = lane; e < GW_TILE * GW_RC; e += 32) {
    const int p = e / GW_RC, r = r0c + e % GW_RC;
    float v = 0.0f;
    if (p < nv && r < a.R) {
      const float dr = pd_s[4 * p] - a.off[r];
      v = expf(coeff * (dr * dr)) * pd_s[4 * p + 1];
    }
    ch_s[e] = gw_round(v, a.bf16);
  }
}

// a0 = tanh(rbf w0 + b0) of the tile's pairs into act_s [16][Fp], tier-
// rounded (the operand of W = a0 w1); with FAC also (1 - a0^2) of the
// float32 a0 into fac_s. Column chunks of 64; for each, R in chunks of 64
// (the rbf chunk computed once when R <= 64).
template <bool FAC>
__device__ __forceinline__ void gw_a0(float* act_s, float* fac_s, float* ch_s,
                                      const float* pd_s, int nv, float coeff,
                                      const GwArgs& a, int lane) {
  const int fg = lane & 15, p0 = GW_PP * (lane >> 4);
  const int nrc = (a.R + GW_RC - 1) / GW_RC;
  const int r4 = (a.R + 3) & ~3;
  for (int cc = 0; cc < a.Fp; cc += GW_CW) {
    const int col = cc + 4 * fg;
    float acc[GW_PP][4];
    gw_zero(acc);
    for (int rc = 0; rc < nrc; ++rc) {
      const int r0c = rc * GW_RC;
      if (nrc > 1 || cc == 0) {
        __syncwarp();  // the previous chunk is read before it is replaced
        gw_rbf_chunk(ch_s, pd_s, r0c, nv, coeff, a, lane);
        __syncwarp();
      }
      gw_prod(acc, ch_s + p0 * GW_RC, GW_RC, a.w0 + (size_t)r0c * a.Fp + col,
              a.Fp, min(GW_RC, r4 - r0c));
    }
    const float4 b = *reinterpret_cast<const float4*>(a.b0 + col);
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int q = 0; q < GW_PP; ++q) {
      float v[4], f[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float t = tanhf(acc[q][c] + bv[c]);
        v[c] = gw_round(t, a.bf16);
        f[c] = 1.0f - t * t;
      }
      const size_t o = (size_t)(p0 + q) * a.Fp + col;
      *reinterpret_cast<float4*>(act_s + o) = make_float4(v[0], v[1], v[2],
                                                          v[3]);
      if (FAC)
        *reinterpret_cast<float4*>(fac_s + o) = make_float4(f[0], f[1], f[2],
                                                            f[3]);
    }
  }
  __syncwarp();
}

// rows_s rows += v_s[t] src[j_t] over columns col0 .. col0 + 63 for t < nv,
// the ring's entries head .. in order ((row - r0) << 16 | j_t), v_s
// [16][64]: a running sum per row segment, lane l on columns col0 + 2 l,
// + 1 (src rows of stride Fp read coalesced).
__device__ __forceinline__ void gw_ring_sum(const int* ring, int head, int nv,
                                            const float* v_s,
                                            const float* src, int col0,
                                            float* rows_s, int Fp, int lane) {
  const int c = col0 + 2 * lane;
  float2 run = make_float2(0.0f, 0.0f);
  int cur = ring[head & (DM_RING - 1)] >> 16;
#pragma unroll 1
  for (int t = 0; t < nv; ++t) {
    const int ent = ring[(head + t) & (DM_RING - 1)], r = ent >> 16;
    if (r != cur) {
      float2* o = reinterpret_cast<float2*>(rows_s + cur * Fp + c);
      const float2 v = *o;
      *o = make_float2(v.x + run.x, v.y + run.y);
      run = make_float2(0.0f, 0.0f);
      cur = r;
    }
    const float2 v = *reinterpret_cast<const float2*>(v_s + t * GW_CW +
                                                      2 * lane);
    const float2 sp = *reinterpret_cast<const float2*>(
        src + (size_t)(ent & 0xffff) * Fp + c);
    run.x += __fmul_rn(v.x, sp.x);
    run.y += __fmul_rn(v.y, sp.y);
  }
  float2* o = reinterpret_cast<float2*>(rows_s + cur * Fp + c);
  const float2 v = *o;
  *o = make_float2(v.x + run.x, v.y + run.y);
}

// W cut of the lane's pairs and columns (acc = W, chunk at col0 + 4 fg) into
// ch_s [16][64].
__device__ __forceinline__ void gw_stage_wcut(float* ch_s,
                                              const float (&acc)[GW_PP][4],
                                              const float* pd_s, int lane) {
  const int fg = lane & 15, p0 = GW_PP * (lane >> 4);
#pragma unroll
  for (int q = 0; q < GW_PP; ++q) {
    const float cutp = pd_s[4 * (p0 + q) + 1];
    *reinterpret_cast<float4*>(ch_s + (p0 + q) * GW_CW + 4 * fg) =
        make_float4(acc[q][0] * cutp, acc[q][1] * cutp, acc[q][2] * cutp,
                    acc[q][3] * cutp);
  }
}

// One forward tile: the ring's entries head .. head + nv - 1 (nv <= 16) of
// the item at row r0, each (row - r0) << 16 | j (pointers at its molecule).
// a0 (gw_a0), then per column chunk W = a0 w1, W cut staged and rows_s
// rows += (W cut) src_j in ring order.
__device__ __forceinline__ void gw_fwd_tile(const int* ring, int head, int nv,
                                            int r0, const float* pos,
                                            const float* src, float* act_s,
                                            float* ch_s, float* pd_s,
                                            float* rows_s, float coeff,
                                            const GwArgs& a, int lane) {
  const int fg = lane & 15, p0 = GW_PP * (lane >> 4);
  gw_geometry<false>(ring, head, nv, r0, pos, nullptr, 0, pd_s, a, lane);
  gw_a0<false>(act_s, nullptr, ch_s, pd_s, nv, coeff, a, lane);
  for (int cc = 0; cc < a.Fp; cc += GW_CW) {
    float acc[GW_PP][4];
    gw_zero(acc);
    gw_prod(acc, act_s + p0 * a.Fp, a.Fp, a.w1 + cc + 4 * fg, a.Fp, a.Fp);
    gw_stage_wcut(ch_s, acc, pd_s, lane);
    __syncwarp();
    gw_ring_sum(ring, head, nv, ch_s, src, cc, rows_s, a.Fp, lane);
    __syncwarp();  // ch_s is read before the next chunk writes it
  }
}

// One backward tile: the ring's entries head .. head + nv - 1 (nv <= 16) of
// the item at row r0 (pointers at its molecule), each (row - r0) << 16 | e,
// e the partner j (dense) or, with NBR, the slot k of the row, whose
// partner is idx[row][k]; gd lands at gd[row * stride + e]. In order: a0
// and (1 - a0^2); per column chunk W = a0 w1, s_cut += sum (g_i W) x_j
// and, with GX (dense), rows_s rows += (W cut) g_j in ring order; the
// cotangent (g_i x_j) cut into act_s in a0's place; per column chunk ga0 =
// cot w1^T and gt0 = ga0 (1 - a0^2) into fac_s in place; per chunk of R
// grbf = gt0 w0^T, se = sum_r grbf e_r, sg = sum_r grbf e_r (d - offset_r);
// gd = cut 2 coeff sg + (s_cut + se) dcut.
template <bool GX, bool NBR>
__device__ __forceinline__ void gw_bwd_tile(
    const int* ring, int head, int nv, int r0, const float* pos,
    const int* idx, int stride, const float* x, const float* g, float* act_s,
    float* fac_s, float* ch_s, float* pd_s, float* rows_s, float* gd,
    float coeff, const GwArgs& a, int lane) {
  static_assert(!(GX && NBR), "the neighbour-matrix gx runs over the CSR");
  const int fg = lane & 15, p0 = GW_PP * (lane >> 4);
  const int Fp = a.Fp;
  gw_geometry<NBR>(ring, head, nv, r0, pos, idx, stride, pd_s, a, lane);
  gw_a0<true>(act_s, fac_s, ch_s, pd_s, nv, coeff, a, lane);

  // the rows of g_i and x_j of the lane's pairs (padding: the item's first)
  int gi_row[GW_PP], xj_row[GW_PP];
#pragma unroll
  for (int q = 0; q < GW_PP; ++q) {
    const int p = p0 + q;
    const int ent = p < nv ? ring[(head + p) & (DM_RING - 1)] : 0;
    gi_row[q] = r0 + (ent >> 16);
    xj_row[q] = df_partner<NBR>(idx, stride, r0, ent);
  }

  // W, s_cut and (dense, GX) the gx rows
  float sc[GW_PP];
#pragma unroll
  for (int q = 0; q < GW_PP; ++q) sc[q] = 0.0f;
  for (int cc = 0; cc < Fp; cc += GW_CW) {
    const int col = cc + 4 * fg;
    float acc[GW_PP][4];
    gw_zero(acc);
    gw_prod(acc, act_s + p0 * Fp, Fp, a.w1 + col, Fp, Fp);
#pragma unroll
    for (int q = 0; q < GW_PP; ++q) {
      const float4 gv =
          *reinterpret_cast<const float4*>(g + (size_t)gi_row[q] * Fp + col);
      const float4 xv =
          *reinterpret_cast<const float4*>(x + (size_t)xj_row[q] * Fp + col);
      float s = sc[q];
      s += (gv.x * acc[q][0]) * xv.x;
      s += (gv.y * acc[q][1]) * xv.y;
      s += (gv.z * acc[q][2]) * xv.z;
      s += (gv.w * acc[q][3]) * xv.w;
      sc[q] = s;
    }
    if (GX) {
      gw_stage_wcut(ch_s, acc, pd_s, lane);
      __syncwarp();
      gw_ring_sum(ring, head, nv, ch_s, g, cc, rows_s, Fp, lane);
      __syncwarp();
    }
  }
#pragma unroll
  for (int q = 0; q < GW_PP; ++q) sc[q] = sum16(sc[q]);
  __syncwarp();  // a0 is read by every chunk's product before cot replaces it

  // cot = (g_i x_j) cut, tier-rounded, into act_s
  for (int cc = 0; cc < Fp; cc += GW_CW) {
    const int col = cc + 4 * fg;
#pragma unroll
    for (int q = 0; q < GW_PP; ++q) {
      const float cutp = pd_s[4 * (p0 + q) + 1];
      const float4 gv =
          *reinterpret_cast<const float4*>(g + (size_t)gi_row[q] * Fp + col);
      const float4 xv =
          *reinterpret_cast<const float4*>(x + (size_t)xj_row[q] * Fp + col);
      *reinterpret_cast<float4*>(act_s + (size_t)(p0 + q) * Fp + col) =
          make_float4(gw_round((gv.x * xv.x) * cutp, a.bf16),
                      gw_round((gv.y * xv.y) * cutp, a.bf16),
                      gw_round((gv.z * xv.z) * cutp, a.bf16),
                      gw_round((gv.w * xv.w) * cutp, a.bf16));
    }
  }
  __syncwarp();

  // ga0 = cot w1^T; gt0 = ga0 (1 - a0^2), tier-rounded, over fac_s
  for (int cc = 0; cc < Fp; cc += GW_CW) {
    const int col = cc + 4 * fg;
    float acc[GW_PP][4];
    gw_zero(acc);
    gw_prod(acc, act_s + p0 * Fp, Fp, a.w1t + col, Fp, Fp);
#pragma unroll
    for (int q = 0; q < GW_PP; ++q) {
      float4* f = reinterpret_cast<float4*>(fac_s + (size_t)(p0 + q) * Fp +
                                            col);
      const float4 fv = *f;
      *f = make_float4(gw_round(acc[q][0] * fv.x, a.bf16),
                       gw_round(acc[q][1] * fv.y, a.bf16),
                       gw_round(acc[q][2] * fv.z, a.bf16),
                       gw_round(acc[q][3] * fv.w, a.bf16));
    }
  }
  __syncwarp();

  // grbf = gt0 w0^T in chunks of 64 radial functions; se, sg
  float se[GW_PP], sg[GW_PP];
#pragma unroll
  for (int q = 0; q < GW_PP; ++q) se[q] = sg[q] = 0.0f;
  for (int rc = 0; rc < a.Rq; rc += GW_RC) {
    float acc[GW_PP][4];
    gw_zero(acc);
    gw_prod(acc, fac_s + p0 * Fp, Fp, a.w0t + rc + 4 * fg, a.Rq, Fp);
    const float4 o4 = *reinterpret_cast<const float4*>(a.off + rc + 4 * fg);
    const float offr[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
    for (int q = 0; q < GW_PP; ++q) {
      const float dp = pd_s[4 * (p0 + q)];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (rc + 4 * fg + c < a.R) {
          const float dr = dp - offr[c];
          const float ge = acc[q][c] * expf(coeff * (dr * dr));
          se[q] += ge;
          sg[q] += ge * dr;
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < GW_PP; ++q) {
    se[q] = sum16(se[q]);
    sg[q] = sum16(sg[q]);
  }
  if (fg == 0) {
#pragma unroll
    for (int q = 0; q < GW_PP; ++q) {
      const int p = p0 + q;
      if (p < nv) {
        const int ent = ring[(head + p) & (DM_RING - 1)];
        gd[(size_t)(r0 + (ent >> 16)) * stride + (ent & 0xffff)] =
            pd_s[4 * p + 1] * (2.0f * coeff) * sg[q] +
            (sc[q] + se[q]) * pd_s[4 * p + 2];
      }
    }
  }
  __syncwarp();  // the ring and the tiles are read before they are written
}

// The start of this warp's area: in the block's dynamic shared memory, or
// with GT in the device-memory workspace a.ws (one area per warp of the
// grid).
template <bool GT>
__device__ __forceinline__ float* gw_area(float4* smem, const GwArgs& a,
                                          int warp) {
  if (GT)
    return a.ws +
           ((size_t)blockIdx.x * (blockDim.x >> 5) + warp) * a.warp_floats;
  return reinterpret_cast<float*>(smem) + (size_t)warp * a.warp_floats;
}

// The body of a first-design forward-tile kernel: gw_items over
// gw_fwd_tile, summing (W cut) src[j] into the item's rows; out [S][A][Fp].
template <bool GT, typename Span, typename Vote>
__device__ __forceinline__ void gw_fwd_items(float4* smem,
                                             const float* __restrict__ pos,
                                             const float* __restrict__ src,
                                             float* __restrict__ out, int S,
                                             int A, const GwArgs& a,
                                             Span span, Vote vote) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, Fp = a.Fp;
  float* act_s = gw_area<GT>(smem, a, warp);     // [16][Fp]
  float* ch_s = act_s + GW_TILE * Fp;            // [16][64]
  float* pd_s = ch_s + GW_TILE * GW_CW;          // [16][4]
  float* rows_s = pd_s + 4 * GW_TILE;            // [DM_RW][Fp]
  int* ring = reinterpret_cast<int*>(rows_s + DM_RW * Fp);  // [DM_RING]
  const float coeff = *a.coeff;
  gw_items<false, true>(
      S, A, Fp, rows_s, ring, out, pos, span, vote,
      [&](int head, int nv, int r0, int s, const float* ps) {
        gw_fwd_tile(ring, head, nv, r0, ps, src + (size_t)s * A * Fp, act_s,
                    ch_s, pd_s, rows_s, coeff, a, lane);
      });
}

// Forward, all pairs: out[i] = sum_{j != i, d < rc} W_ij cut_ij x[j].
template <bool GT>
__global__ void __launch_bounds__(GW_MAX_WARPS * 32, 1)
gw_dense_fwd_kernel(const float* __restrict__ pos,
                    const float* __restrict__ x, float* __restrict__ out,
                    int S, int A, GwArgs a) {
  extern __shared__ float4 gw_smem4[];
  gw_fwd_items<GT>(gw_smem4, pos, x, out, S, A, a, dense_span(A),
                   dense_vote(a.rcut, a.arg_scale, a.dcut_scale));
}

// Forward, neighbour matrix: out[i] = sum over the live slots k (mask set,
// d < rc; all K voted, masked slots skipped before idx is read) of W cut
// x[idx[i, k]], in slot order.
template <bool GT>
__global__ void __launch_bounds__(GW_MAX_WARPS * 32, 1)
gw_nbr_fwd_kernel(const float* __restrict__ pos, const float* __restrict__ x,
                  const int* __restrict__ idx,
                  const unsigned char* __restrict__ mask,
                  float* __restrict__ out, int S, int A, int K, GwArgs a) {
  extern __shared__ float4 gw_smem4[];
  gw_fwd_items<GT>(gw_smem4, pos, x, out, S, A, a, nbr_span(K),
                   nbr_vote(idx, mask, A, K, a.rcut, a.arg_scale,
                            a.dcut_scale));
}

// Backward, gx pass of the neighbour matrix: gx[a] = sum over a's incoming
// slots (i, k) in source-CSR order with d < rc of W_ik cut_ik g[i], W
// computed again (the forward tile with g in place of x).
template <bool GT>
__global__ void __launch_bounds__(GW_MAX_WARPS * 32, 1)
gw_nbr_gx_kernel(const float* __restrict__ pos,
                 const int* __restrict__ offsets,
                 const int* __restrict__ slots, const float* __restrict__ g,
                 float* __restrict__ gx, int S, int A, int K, GwArgs a) {
  extern __shared__ float4 gw_smem4[];
  gw_fwd_items<GT>(gw_smem4, pos, g, gx, S, A, a, csr_span(offsets, A),
                   csr_vote(slots, A, K, a.rcut, a.arg_scale, a.dcut_scale));
}

// Backward, first pass: gd of every pair (dense, [S, A, A]) or slot (NBR,
// [S, A, K]) of a work item's rows, zero where dead (bwd_vote), and with
// GX (dense) gx of the item's rows [S][A][Fp]; the live entries 16 at a
// time through gw_bwd_tile.
template <bool GX, bool NBR, bool GT>
__global__ void __launch_bounds__(GW_BWD_MAX_WARPS * 32, 1)
gw_bwd_kernel(const float* __restrict__ pos, const int* __restrict__ idx,
              const unsigned char* __restrict__ mask,
              const float* __restrict__ x, const float* __restrict__ g,
              float* __restrict__ gd, float* __restrict__ gx, int S, int A,
              int K, GwArgs a) {
  extern __shared__ float4 gw_smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, Fp = a.Fp;
  float* act_s = gw_area<GT>(gw_smem4, a, warp);  // [16][Fp]
  float* fac_s = act_s + GW_TILE * Fp;            // [16][Fp]
  float* ch_s = fac_s + GW_TILE * Fp;             // [16][64]
  float* pd_s = ch_s + GW_TILE * GW_CW;           // [16][4]
  float* rows_s = pd_s + 4 * GW_TILE;             // [DM_RW][Fp]
  int* ring = reinterpret_cast<int*>(rows_s + DM_RW * Fp);  // [DM_RING]
  const float coeff = *a.coeff;
  const int stride = NBR ? K : A;
  gw_items<false, GX>(
      S, A, Fp, rows_s, ring, gx, pos, [=](int, int) {
        return make_int2(0, stride);
      },
      bwd_vote<NBR>(idx, mask, gd, A, K, a.rcut, a.arg_scale, a.dcut_scale),
      [&](int head, int nv, int r0, int s, const float* ps) {
        gw_bwd_tile<GX, NBR>(ring, head, nv, r0, ps,
                             NBR ? idx + (size_t)s * A * K : nullptr, stride,
                             x + (size_t)s * A * Fp, g + (size_t)s * A * Fp,
                             act_s, fac_s, ch_s, pd_s, rows_s,
                             gd + (size_t)s * A * stride, coeff, a, lane);
      });
}

// ---------------------------------------------------------------------------
// The CUDA-core tiers with their weights in shared memory (gf_*): tiers 0
// (fp32) and 1 (bf16 on the CUDA cores, the "wide" family) wherever
// gf_layout finds room; the kernels above take the widths where it finds
// none. The first design's ring, work items, tiles of 16 entries and
// roundings, with three changes:
// - The weights. Layout GF_STAGED: w0 [R rounded up to 4][Fp + 4] and w1
//   [Fp][Fp + 4] float32, staged once per block, where they fit beside
//   GF_STAGED_MIN warps of the dense backward with gx (F 64 R 300: 100.5
//   KB; F 128 R 100: 121.4 KB). Layout GF_PANELS, where they do not (F
//   256 R 50: w1 alone is 256 KB): each product streams its weight
//   through the block in panels of GF_KP rows (or, for a product with the
//   transpose, GF_KP columns) of one column chunk, double-buffered with
//   cp.async; the block's warps run the product together, one barrier
//   pair a panel, so that each weight byte read from L2 serves every warp
//   of the block (gw_items with SYNC: a warp with no tile left runs
//   padding tiles through the barriers). A product with the weight's
//   transpose reads the weight's rows along k, as df_colprod does, so one
//   copy serves w and w^T; its rows are stored permuted within each block
//   of 64 (gf_perm: row 4 a + c at c m / 4 + a, m the block's rows), so
//   that the 8 lanes of a phase, on rows 4 fg + c, read 8 consecutive
//   rows, which the row strides put in distinct banks.
// - The register tile: 8 pairs x 8 columns a lane (64 accumulators), the
//   columns c0 + 4 fg + {0..3} and c0 + 64 + 4 fg + {0..3} of a 128-column
//   chunk; a trailing chunk of 64 takes 8 x 4 (NC = 4). So at Fp = 64
//   (SchNet's published widths) every tile is 8 x 4 a lane, with twice
//   the shared loads a multiply-add, and the forward tile there loses to
//   the first design's (16 warps a block on L1-resident weights; 2.45 ms
//   against 2.20 at F 64 R 300, S 128, A 266 on the H100 80GB HBM3, 700 W,
//   tools/general_variants.py): the forward and the gx pass at Fp = 64 run
//   the first design's kernels (gf_kind_layout). Each lane's sums
//   (s_cut, se, sg) run over its columns in the first design's order, the
//   ring sums per tile of 16, and every product sums over k in order: the
//   outputs are bitwise those of the kernels above.
// - The rest of the backward: rbf once per tile where Fp <= 128 or R <=
//   64 (else once per 128-column chunk: R exps per 128 R multiply-adds);
//   at Fp <= 128 the cotangent formed from the s_cut loads in W's
//   registers. e_r is computed again for grbf: keeping it would take [16][R]
//   floats a warp (19.2 KB at R 300, a warp's worth at F 64), and at R 50
//   its exps are 0.06 % of the tile's multiply-adds.

constexpr int GF_CW = 128;             // columns of a chunk: 16 lanes x 8
constexpr int GF_KP = 32;              // rows (or columns) of a panel's k
constexpr int GF_LDR = GF_CW + 4;      // row stride of a panel of rows
constexpr int GF_LDC = GF_KP + 4;      // of a panel of a transpose's rows
constexpr int GF_PANEL_FLOATS =
    GF_KP * GF_LDR > GF_CW * GF_LDC ? GF_KP * GF_LDR : GF_CW * GF_LDC;
// Warps a block at most, and the fewest that each layout must fit in the
// dense backward with gx (the largest area).
// (tools/general_variants.py, H100 80GB HBM3, 700 W: the forwards 2-4 %
// slower at 12 warps, the backward at F 64 slower at 4)
constexpr int GF_FWD_MAX_WARPS = 8;
constexpr int GF_BWD_MAX_WARPS = 8;
constexpr int GF_STAGED_MIN = 4;
constexpr int GF_PANELS_MIN = 2;
enum { GF_FWD = 0, GF_BWD = 1, GF_BWD_GX = 2 };

// Floats of one warp's area: t1 [16][min(Fp, 128)] (the rbf chunk [16][64],
// then W cut; in act's place in the forward at Fp <= 128, whose a0 is
// written once its only chunk's product has read the rbf, and read whole
// before W cut), act [16][Fp] (a0, then the cotangent), in the backward fac
// [16][Fp] ((1 - a0^2), then gt0), pd [16][4], the item's rows [DM_RW][Fp]
// (forward and the dense backward with gx), the ring.
long gf_warp_floats(int kind, int Fp) {
  // the forward at Fp <= 128 (one column chunk) keeps t1 in act's place
  const long t1 =
      kind == GF_FWD && Fp <= GF_CW ? 0 : GW_TILE * (long)(Fp < GF_CW ? Fp
                                                                   : GF_CW);
  return t1 + (kind == GF_FWD ? 1L : 2L) * GW_TILE * Fp + 4 * GW_TILE +
         (kind == GF_BWD ? 0L : (long)DM_RW * Fp) + DM_RING;
}

// Floats of the block's weights: staged w0, w1, b0, offsets; or the two
// panel buffers, b0, offsets.
long gf_weight_floats(int layout, int Fp, int R, int Rq) {
  const long r4 = (R + 3) & ~3;
  return (layout == GF_PANELS ? 2L * GF_PANEL_FLOATS
                              : (r4 + Fp) * (Fp + 4L)) + Fp + Rq;
}

// The layout of a width: staged where the weights and GF_STAGED_MIN warps
// of the dense backward with gx fit, else panels where GF_PANELS_MIN warps
// do, else none (the first design's kernels). The same test for every
// kernel, so that the route is a function of the widths:
// ops/cfconv_general.py ffma_layout.
int gf_layout(int Fp, int R, int Rq) {
  const long per = gf_warp_floats(GF_BWD_GX, Fp);
  if (4L * (gf_weight_floats(GF_STAGED, Fp, R, Rq) + GF_STAGED_MIN * per) <=
      GW_SMEM_MAX)
    return GF_STAGED;
  if (4L * (gf_weight_floats(GF_PANELS, Fp, R, Rq) + GF_PANELS_MIN * per) <=
      GW_SMEM_MAX)
    return GF_PANELS;
  return GF_NONE;
}

// The layout of the kernels of `kind`: gf_layout's, except that the
// forward and the gx pass (GF_FWD) at Fp = 64 run the first design's
// kernels, whose 16 warps a block beat an 8 x 4 register tile there.
int gf_kind_layout(int kind, int Fp, int R, int Rq) {
  return kind == GF_FWD && Fp == 64 ? GF_NONE : gf_layout(Fp, R, Rq);
}

// Warps a block (as many as shared memory holds, at most the kind's cap, a
// multiple of 4 from 4 up: one or two on each scheduler) and bytes of
// dynamic shared memory of a launch of `kind` in `layout`.
void gf_shape(int kind, int layout, int Fp, int R, int Rq, int& warps,
              int& smem) {
  const long w = gf_weight_floats(layout, Fp, R, Rq);
  const long per = gf_warp_floats(kind, Fp);
  const long fit = (GW_SMEM_MAX / 4 - w) / per;
  const int most = kind == GF_FWD ? GF_FWD_MAX_WARPS : GF_BWD_MAX_WARPS;
  warps = (int)(fit < most ? fit : most);
  if (warps >= 4) warps &= ~3;
  smem = (int)(4 * (w + (long)warps * per));
}

// The weights of a launch as the tiles read them.
struct GfW {
  const float* w0;   // staged [r4][ld], rows permuted; panels: [Rq][Fp]
  const float* w1;   // staged [Fp][ld], rows permuted; panels: [Fp][Fp]
  const float* b0;   // [Fp], in shared memory
  const float* off;  // [Rq], in shared memory
  float* pbuf;       // panels: the two panel buffers
  float* areas;      // the per-warp areas
  int ld;            // staged: Fp + 4; panels: Fp (device memory)
};

// Row n's place among `rows` rows stored permuted within each block of 64
// (a block of m rows, m a multiple of 4: row 4 a + c at c m / 4 + a).
__device__ __forceinline__ int gf_perm(int n, int rows) {
  const int blk = n & ~63, m4 = min(64, rows - blk) >> 2;
  return blk + (n & 3) * m4 + ((n & 63) >> 2);
}

// Stages the block's weights (GF_STAGED) or points at them (GF_PANELS),
// b0 and the offsets, and returns where everything lies.
template <bool PANEL>
__device__ __forceinline__ GfW gf_stage(float4* smem, const GwArgs& a) {
  float* base = reinterpret_cast<float*>(smem);
  const int Fp = a.Fp;
  GfW W;
  float* b0_s;
  if (PANEL) {
    W.w0 = a.w0;
    W.w1 = a.w1;
    W.ld = Fp;
    W.pbuf = base;
    b0_s = base + 2 * GF_PANEL_FLOATS;
  } else {
    const int r4 = (a.R + 3) & ~3, ld = Fp + 4, cpr = Fp / 4;
    float* w0_s = base;
    float* w1_s = base + (size_t)r4 * ld;
    for (int e = threadIdx.x; e < (r4 + Fp) * cpr; e += blockDim.x) {
      const int row = e / cpr, c = e - row * cpr;
      const bool first = row < r4;
      const float* src = first ? a.w0 + (size_t)row * Fp
                               : a.w1 + (size_t)(row - r4) * Fp;
      float* dst = first ? w0_s + (size_t)gf_perm(row, r4) * ld
                         : w1_s + (size_t)gf_perm(row - r4, Fp) * ld;
      reinterpret_cast<float4*>(dst)[c] =
          __ldg(reinterpret_cast<const float4*>(src) + c);
    }
    W.w0 = w0_s;
    W.w1 = w1_s;
    W.ld = ld;
    W.pbuf = nullptr;
    b0_s = w1_s + (size_t)Fp * ld;
  }
  float* off_s = b0_s + Fp;
  for (int e = threadIdx.x; e < Fp; e += blockDim.x) b0_s[e] = a.b0[e];
  for (int e = threadIdx.x; e < a.Rq; e += blockDim.x) off_s[e] = a.off[e];
  __syncthreads();
  W.b0 = b0_s;
  W.off = off_s;
  W.areas = off_s + a.Rq;
  return W;
}

// A lane's register tile of a product: 8 pairs (those from p0 = 8 (lane /
// 16)) x the columns 4 fg + {0..3} and 64 + 4 fg + {0..3} of a chunk of
// 128 (fg = lane % 16). Column c of the tile in the chunk at c0:
__device__ __forceinline__ int gf_col(int c0, int fg, int c) {
  return c0 + (c < 4 ? 4 * fg + c : 64 + 4 * fg + c - 4);
}

__device__ __forceinline__ void gf_zero(float (&acc)[GW_PP][8]) {
#pragma unroll
  for (int q = 0; q < GW_PP; ++q)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[q][c] = 0.0f;
}

// f(NC, c0) for each chunk of n columns: 128 (NC = 8) while more than 64
// remain, then one of 64 (NC = 4), as std::integral_constant.
template <typename Fn>
__device__ __forceinline__ void gf_for_chunks(int n, Fn f) {
  int c0 = 0;
#pragma unroll 1
  for (; c0 + 64 < n; c0 += GF_CW) f(std::integral_constant<int, 8>(), c0);
  if (c0 < n) f(std::integral_constant<int, 4>(), c0);
}

// The lane's pairs' A values at k .. k + 3 (a at the lane's first pair).
__device__ __forceinline__ void gf_load_a(float4 (&av)[GW_PP], const float* a,
                                          int lda, int k) {
#pragma unroll
  for (int q = 0; q < GW_PP; ++q)
    av[q] = *reinterpret_cast<const float4*>(a + q * lda + k);
}

// acc[q][c] += sum over kk < 4 of av[q][kk] w[kk rstep + col_c - c0 - 4 fg]
// (w at the lane's columns of the weight's row k; rows rstep apart).
template <int NC>
__device__ __forceinline__ void gf_fma_rows(float (&acc)[GW_PP][8],
                                            const float4 (&av)[GW_PP],
                                            const float* w, int rstep) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float4 lo = *reinterpret_cast<const float4*>(w + kk * rstep);
    const float4 hi =
        NC == 8 ? *reinterpret_cast<const float4*>(w + kk * rstep + 64) : lo;
    const float b[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int q = 0; q < GW_PP; ++q) {
      const float aq = kk == 0 ? av[q].x : kk == 1 ? av[q].y
                     : kk == 2 ? av[q].z : av[q].w;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[q][c] = fmaf(aq, b[c], acc[q][c]);
    }
  }
}

// acc[q][c] += sum over kk < 4 of av[q][kk] row_c[kk] (row c at lo + c
// lstep for c < 4, at hi + (c - 4) hstep after, each at k).
template <int NC>
__device__ __forceinline__ void gf_fma_cols(float (&acc)[GW_PP][8],
                                            const float4 (&av)[GW_PP],
                                            const float* lo, int lstep,
                                            const float* hi, int hstep) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float4 b = *reinterpret_cast<const float4*>(
        c < 4 ? lo + c * lstep : hi + (c - 4) * hstep);
#pragma unroll
    for (int q = 0; q < GW_PP; ++q) {
      acc[q][c] = fmaf(av[q].x, b.x, acc[q][c]);
      acc[q][c] = fmaf(av[q].y, b.y, acc[q][c]);
      acc[q][c] = fmaf(av[q].z, b.z, acc[q][c]);
      acc[q][c] = fmaf(av[q].w, b.w, acc[q][c]);
    }
  }
}

// Copies rows k0 .. k0 + kn - 1, columns c0 .. c0 + 16 NC - 1 of w (row
// stride ldw, device memory) into the panel dst [kn][GF_LDR]; one group.
template <int NC>
__device__ __forceinline__ void gf_panel_rows(float* dst, const float* w,
                                              int ldw, int k0, int kn,
                                              int c0) {
  constexpr int C4 = 4 * NC;  // float4 of a row
  for (int e = threadIdx.x; e < kn * C4; e += blockDim.x) {
    const int row = e / C4, c = e - row * C4;
    cp_async16(dst + row * GF_LDR + 4 * c,
               w + (size_t)(k0 + row) * ldw + c0 + 4 * c);
  }
  cp_async_commit();
}

// Copies rows c0 .. of w (those below `rows`, at most 16 NC), columns
// k0 .. k0 + GF_KP - 1, into the panel dst [16 NC][GF_LDC], each row at
// its gf_perm place; one group.
template <int NC>
__device__ __forceinline__ void gf_panel_cols(float* dst, const float* w,
                                              int ldw, int rows, int c0,
                                              int k0) {
  const int nr = min(16 * NC, rows - c0);
  for (int e = threadIdx.x; e < nr * (GF_KP / 4); e += blockDim.x) {
    const int row = e / (GF_KP / 4), c = e - row * (GF_KP / 4);
    cp_async16(dst + gf_perm(row, rows - c0) * GF_LDC + 4 * c,
               w + (size_t)(c0 + row) * ldw + k0 + 4 * c);
  }
  cp_async_commit();
}

// acc[q][c] += sum over k < nk of a[q lda + k] w[k0 + k][col_c] (the
// product with the weight as stored; a at the lane's first pair, pair-
// major, nk a multiple of 4; w's `rows` rows as GfW holds them); the sum
// over k in order. With PANEL every warp of the block calls it with the
// same arguments but `a` and `run` (false: a padding tile, no FMAs).
template <bool PANEL, int NC>
__device__ __forceinline__ void gf_rowprod(float (&acc)[GW_PP][8],
                                           const float* a, int lda, int nk,
                                           const float* w, int rows, int k0,
                                           int c0, const GfW& W, bool run,
                                           int lane) {
  const int fg = lane & 15;
  if (!PANEL) {
    if (!run) return;
#pragma unroll 1
    for (int k = 0; k < nk; k += 4) {
      float4 av[GW_PP];
      gf_load_a(av, a, lda, k);
      const int kw = k0 + k, blk = kw & ~63;
      const int m4 = min(64, rows - blk) >> 2;
      gf_fma_rows<NC>(acc, av,
                         w + (size_t)(blk + ((kw & 63) >> 2)) * W.ld + c0 +
                             4 * fg,
                         m4 * W.ld);
    }
    return;
  }
  const int np = (nk + GF_KP - 1) / GF_KP;
  gf_panel_rows<NC>(W.pbuf, w, W.ld, k0, min(GF_KP, nk), c0);
#pragma unroll 1
  for (int p = 0; p < np; ++p) {
    if (p + 1 < np) {
      const int kb = (p + 1) * GF_KP;
      gf_panel_rows<NC>(W.pbuf + ((p + 1) & 1) * GF_PANEL_FLOATS, w, W.ld,
                        k0 + kb, min(GF_KP, nk - kb), c0);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (run) {
      const float* buf = W.pbuf + (p & 1) * GF_PANEL_FLOATS + 4 * fg;
      const int kb = p * GF_KP, ke = min(nk, kb + GF_KP);
#pragma unroll 1
      for (int k = kb; k < ke; k += 4) {
        float4 av[GW_PP];
        gf_load_a(av, a, lda, k);
        gf_fma_rows<NC>(acc, av, buf + (k - kb) * GF_LDR, GF_LDR);
      }
    }
    __syncthreads();  // the buffer is read before it is written again
  }
}

// acc[q][c] += sum over k < K of a[q lda + k] w[col_c][k] (the product with
// the weight's transpose: its rows as columns; K = Fp, a multiple of 64;
// columns col_c >= rows read some row and are not to be used); the sum over
// k in order. PANEL and run as gf_rowprod.
template <bool PANEL, int NC>
__device__ __forceinline__ void gf_colprod(float (&acc)[GW_PP][8],
                                           const float* a, int lda, int K,
                                           const float* w, int rows, int c0,
                                           const GfW& W, bool run, int lane) {
  const int fg = lane & 15;
  // the lane's rows 4 fg + c of each half's block of 64 (permuted: fg +
  // c m / 4); a lane past the block's rows reads its first row
  int base[2], step[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int b = c0 + 64 * h;
    const int m4 = (rows - b >= 64 ? 64 : rows - b) >> 2;
    const bool ok = fg < m4;
    base[h] = ok ? (PANEL ? 64 * h : b) + fg : 0;
    step[h] = ok ? m4 : 0;
  }
  if (!PANEL) {
    if (!run) return;
    const float* lo = w + (size_t)base[0] * W.ld;
    const float* hi = w + (size_t)base[1] * W.ld;
#pragma unroll 1
    for (int k = 0; k < K; k += 4) {
      float4 av[GW_PP];
      gf_load_a(av, a, lda, k);
      gf_fma_cols<NC>(acc, av, lo + k, step[0] * W.ld, hi + k,
                      step[1] * W.ld);
    }
    return;
  }
  const int np = K / GF_KP;
  gf_panel_cols<NC>(W.pbuf, w, W.ld, rows, c0, 0);
#pragma unroll 1
  for (int p = 0; p < np; ++p) {
    if (p + 1 < np) {
      gf_panel_cols<NC>(W.pbuf + ((p + 1) & 1) * GF_PANEL_FLOATS, w, W.ld,
                        rows, c0, (p + 1) * GF_KP);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (run) {
      const float* buf = W.pbuf + (p & 1) * GF_PANEL_FLOATS;
      const float* lo = buf + base[0] * GF_LDC;
      const float* hi = buf + base[1] * GF_LDC;
#pragma unroll 1
      for (int k = 0; k < GF_KP; k += 4) {
        float4 av[GW_PP];
        gf_load_a(av, a, lda, p * GF_KP + k);
        gf_fma_cols<NC>(acc, av, lo + k, step[0] * GF_LDC, hi + k,
                        step[1] * GF_LDC);
      }
    }
    __syncthreads();  // the buffer is read before it is written again
  }
}

// rbf of radial functions r0c .. r0c + 63 of the tile's pairs into t1_s
// [16][64] (gw_rbf_chunk with the staged offsets).
__device__ __forceinline__ void gf_rbf_chunk(float* t1_s, const float* pd_s,
                                             int r0c, int nv, float coeff,
                                             const GwArgs& a, const GfW& W,
                                             int lane) {
  for (int e = lane; e < GW_TILE * GW_RC; e += 32) {
    const int p = e / GW_RC, r = r0c + e % GW_RC;
    float v = 0.0f;
    if (p < nv && r < a.R) {
      const float dr = pd_s[4 * p] - W.off[r];
      v = expf(coeff * (dr * dr)) * pd_s[4 * p + 1];
    }
    t1_s[e] = gw_round(v, a.bf16);
  }
}

// a0 = tanh(rbf w0 + b0) of the tile's pairs into act_s [16][Fp], tier-
// rounded; with FAC (1 - a0^2) of the float32 a0 into fac_s. Per column
// chunk, R in chunks of 64 (the rbf chunk computed once where R <= 64).
template <bool PANEL, bool FAC>
__device__ __forceinline__ void gf_a0(float* act_s, float* fac_s,
                                      float* t1_s, const float* pd_s, int nv,
                                      float coeff, const GwArgs& a,
                                      const GfW& W, int lane) {
  const int fg = lane & 15, p0 = GW_PP * (lane >> 4), Fp = a.Fp;
  const bool run = nv > 0;
  const int r4 = (a.R + 3) & ~3, nrc = (r4 + GW_RC - 1) / GW_RC;
  gf_for_chunks(Fp, [&](auto nct, int c0) {
    constexpr int NC = decltype(nct)::value;
    float acc[GW_PP][8];
    gf_zero(acc);
#pragma unroll 1
    for (int rc = 0; rc < r4; rc += GW_RC) {
      if (nrc > 1 || c0 == 0) {
        __syncwarp();  // the previous chunk is read before it is replaced
        if (run) gf_rbf_chunk(t1_s, pd_s, rc, nv, coeff, a, W, lane);
        __syncwarp();
      }
      gf_rowprod<PANEL, NC>(acc, t1_s + p0 * GW_RC, GW_RC,
                            min(GW_RC, r4 - rc), W.w0, r4, rc, c0, W, run,
                            lane);
    }
    if (!run) return;
    if (t1_s == act_s) __syncwarp();  // the rbf chunk is read before a0
#pragma unroll
    for (int h = 0; h < NC / 4; ++h) {
      const int col = c0 + 64 * h + 4 * fg;
      const float4 b = *reinterpret_cast<const float4*>(W.b0 + col);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int q = 0; q < GW_PP; ++q) {
        float v[4], f[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float t = tanhf(acc[q][4 * h + c] + bv[c]);
          v[c] = gw_round(t, a.bf16);
          f[c] = 1.0f - t * t;
        }
        const size_t o = (size_t)(p0 + q) * Fp + col;
        *reinterpret_cast<float4*>(act_s + o) =
            make_float4(v[0], v[1], v[2], v[3]);
        if (FAC)
          *reinterpret_cast<float4*>(fac_s + o) =
              make_float4(f[0], f[1], f[2], f[3]);
      }
    }
  });
  __syncwarp();
}

// W cut of the lane's pairs and columns into v_s [rows][ldv] (column c of
// the chunk at 4 fg + c, 64 + 4 fg + c - 4).
template <int NC>
__device__ __forceinline__ void gf_stage_wcut(float* v_s, int ldv,
                                              const float (&acc)[GW_PP][8],
                                              const float* pd_s, int lane) {
  const int fg = lane & 15, p0 = GW_PP * (lane >> 4);
#pragma unroll
  for (int q = 0; q < GW_PP; ++q) {
    const float cutp = pd_s[4 * (p0 + q) + 1];
#pragma unroll
    for (int h = 0; h < NC / 4; ++h)
      *reinterpret_cast<float4*>(v_s + (p0 + q) * ldv + 64 * h + 4 * fg) =
          make_float4(acc[q][4 * h] * cutp, acc[q][4 * h + 1] * cutp,
                      acc[q][4 * h + 2] * cutp, acc[q][4 * h + 3] * cutp);
  }
}

// rows_s rows += v_s[t] src[j_t] over the 32 V columns at c0 for t < nv
// (nv <= 16: one tile of 16, whose sums end in the rows), the ring's
// entries head .. in order ((row - r0) << 16 | j_t): gw_ring_sum with V
// columns a lane (float4 or float2).
template <int V>
__device__ __forceinline__ void gf_ring_sum(const int* ring, int head, int nv,
                                            const float* v_s, int ldv,
                                            const float* src, int c0,
                                            float* rows_s, int Fp, int lane) {
  const int c = V * lane;
  float run[V] = {};
  int cur = ring[head & (DM_RING - 1)] >> 16;
#pragma unroll 1
  for (int t = 0; t < nv; ++t) {
    const int ent = ring[(head + t) & (DM_RING - 1)], r = ent >> 16;
    if (r != cur) {
      float* o = rows_s + cur * Fp + c0 + c;
#pragma unroll
      for (int u = 0; u < V; ++u) o[u] += run[u];
#pragma unroll
      for (int u = 0; u < V; ++u) run[u] = 0.0f;
      cur = r;
    }
    const float* v = v_s + t * ldv + c;
    const float* sp = src + (size_t)(ent & 0xffff) * Fp + c0 + c;
    if constexpr (V == 4) {
      const float4 a4 = *reinterpret_cast<const float4*>(v);
      const float4 b4 = *reinterpret_cast<const float4*>(sp);
      run[0] += __fmul_rn(a4.x, b4.x);
      run[1] += __fmul_rn(a4.y, b4.y);
      run[2] += __fmul_rn(a4.z, b4.z);
      run[3] += __fmul_rn(a4.w, b4.w);
    } else {
      const float2 a2 = *reinterpret_cast<const float2*>(v);
      const float2 b2 = *reinterpret_cast<const float2*>(sp);
      run[0] += __fmul_rn(a2.x, b2.x);
      run[1] += __fmul_rn(a2.y, b2.y);
    }
  }
  float* o = rows_s + cur * Fp + c0 + c;
#pragma unroll
  for (int u = 0; u < V; ++u) o[u] += run[u];
}

// One forward tile (nv may be 0 under PANEL: a padding tile that only
// joins the products' barriers). a0 (gf_a0), then per column chunk W = a0
// w1, W cut staged in t1_s and rows_s rows += (W cut) src_j in ring order:
// gw_fwd_tile's sums, bit for bit.
template <bool PANEL>
__device__ __forceinline__ void gf_fwd_tile(const int* ring, int head,
                                            int nv, int r0, const float* pos,
                                            const float* src, float* t1_s,
                                            float* act_s, float* pd_s,
                                            float* rows_s, float coeff,
                                            const GwArgs& a, const GfW& W,
                                            int lane) {
  const int p0 = GW_PP * (lane >> 4), Fp = a.Fp;
  const bool run = nv > 0;
  const int ldv = min(Fp, GF_CW);
  if (run)
    gw_geometry<false>(ring, head, nv, r0, pos, nullptr, 0, pd_s, a, lane);
  gf_a0<PANEL, false>(act_s, nullptr, t1_s, pd_s, nv, coeff, a, W, lane);
  gf_for_chunks(Fp, [&](auto nct, int c0) {
    constexpr int NC = decltype(nct)::value;
    float acc[GW_PP][8];
    gf_zero(acc);
    gf_rowprod<PANEL, NC>(acc, act_s + p0 * Fp, Fp, Fp, W.w1, Fp, 0, c0, W,
                          run, lane);
    if (!run) return;
    if (t1_s == act_s) __syncwarp();  // a0 is read before W cut
    gf_stage_wcut<NC>(t1_s, ldv, acc, pd_s, lane);
    __syncwarp();
    gf_ring_sum<NC / 2>(ring, head, nv, t1_s, ldv, src, c0, rows_s, Fp, lane);
    __syncwarp();  // t1_s is read before the next chunk writes it
  });
}

// One backward tile (nv may be 0 under PANEL, as gf_fwd_tile): gw_bwd_tile's
// steps and roundings. a0 and (1 - a0^2); per column chunk W = a0 w1,
// s_cut += sum (g_i W) x_j and, with GX (dense), rows_s rows += (W cut)
// g_j in ring order; the cotangent (g_i x_j) cut into act_s in a0's place
// (at Fp <= 128 from the s_cut loads, in W's registers); per column chunk
// ga0 = cot w1^T and gt0 = ga0 (1 - a0^2) into fac_s in place; per chunk
// of R grbf = gt0 w0^T, se = sum_r grbf e_r, sg = sum_r grbf e_r (d -
// offset_r); gd = cut 2 coeff sg + (s_cut + se) dcut.
template <bool GX, bool NBR, bool PANEL>
__device__ __forceinline__ void gf_bwd_tile(
    const int* ring, int head, int nv, int r0, const float* pos,
    const int* idx, int stride, const float* x, const float* g, float* t1_s,
    float* act_s, float* fac_s, float* pd_s, float* rows_s, float* gd,
    float coeff, const GwArgs& a, const GfW& W, int lane) {
  static_assert(!(GX && NBR), "the neighbour-matrix gx runs over the CSR");
  const int fg = lane & 15, p0 = GW_PP * (lane >> 4), Fp = a.Fp;
  const bool run = nv > 0, one = Fp <= GF_CW;
  const int ldv = min(Fp, GF_CW), r4 = (a.R + 3) & ~3;
  if (run)
    gw_geometry<NBR>(ring, head, nv, r0, pos, idx, stride, pd_s, a, lane);
  gf_a0<PANEL, true>(act_s, fac_s, t1_s, pd_s, nv, coeff, a, W, lane);

  // the rows of g_i and x_j of the lane's pair p0 + q (padding: the item's
  // first), read from the ring where they are needed: held for the tile,
  // their 16 registers push the backward past 255
  auto rows_of = [&](int q, const float*& gi, const float*& xj) {
    const int p = p0 + q;
    const int ent = p < nv ? ring[(head + p) & (DM_RING - 1)] : 0;
    gi = g + (size_t)(r0 + (ent >> 16)) * Fp;
    xj = x + (size_t)df_partner<NBR>(idx, stride, r0, ent) * Fp;
  };

  // W, s_cut, (dense, GX) the gx rows and (one chunk) the cotangent
  float sc[GW_PP];
#pragma unroll
  for (int q = 0; q < GW_PP; ++q) sc[q] = 0.0f;
  gf_for_chunks(Fp, [&](auto nct, int c0) {
    constexpr int NC = decltype(nct)::value;
    float acc[GW_PP][8];
    gf_zero(acc);
    gf_rowprod<PANEL, NC>(acc, act_s + p0 * Fp, Fp, Fp, W.w1, Fp, 0, c0, W,
                          run, lane);
    if (!run) return;
    if (GX) gf_stage_wcut<NC>(t1_s, ldv, acc, pd_s, lane);
#pragma unroll
    for (int q = 0; q < GW_PP; ++q) {
      const float *gi, *xj;
      rows_of(q, gi, xj);
      float gv[8], xv[8];
#pragma unroll
      for (int h = 0; h < NC / 4; ++h) {
        const int col = c0 + 64 * h + 4 * fg;
        const float4 g4 = *reinterpret_cast<const float4*>(gi + col);
        const float4 x4 = *reinterpret_cast<const float4*>(xj + col);
        gv[4 * h] = g4.x; gv[4 * h + 1] = g4.y;
        gv[4 * h + 2] = g4.z; gv[4 * h + 3] = g4.w;
        xv[4 * h] = x4.x; xv[4 * h + 1] = x4.y;
        xv[4 * h + 2] = x4.z; xv[4 * h + 3] = x4.w;
      }
      float s = sc[q];
#pragma unroll
      for (int c = 0; c < NC; ++c) s += (gv[c] * acc[q][c]) * xv[c];
      sc[q] = s;
      if (one) {
        const float cutp = pd_s[4 * (p0 + q) + 1];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[q][c] = gw_round((gv[c] * xv[c]) * cutp, a.bf16);
      }
    }
    __syncwarp();  // W cut staged; every lane's product has read a0
    if (GX) {
      gf_ring_sum<NC / 2>(ring, head, nv, t1_s, ldv, g, c0, rows_s, Fp, lane);
      __syncwarp();
    }
    if (one) {
#pragma unroll
      for (int q = 0; q < GW_PP; ++q)
#pragma unroll
        for (int h = 0; h < NC / 4; ++h)
          *reinterpret_cast<float4*>(act_s + (size_t)(p0 + q) * Fp + c0 +
                                     64 * h + 4 * fg) =
              make_float4(acc[q][4 * h], acc[q][4 * h + 1],
                          acc[q][4 * h + 2], acc[q][4 * h + 3]);
    }
  });
  if (run) {
#pragma unroll
    for (int q = 0; q < GW_PP; ++q) sc[q] = sum16(sc[q]);
    if (!one) {
      // cot = (g_i x_j) cut, tier-rounded, into act_s (a0 read by every
      // chunk's product)
      __syncwarp();
#pragma unroll 1
      for (int cc = 0; cc < Fp; cc += GW_CW) {
        const int col = cc + 4 * fg;
#pragma unroll
        for (int q = 0; q < GW_PP; ++q) {
          const float *gi, *xj;
          rows_of(q, gi, xj);
          const float cutp = pd_s[4 * (p0 + q) + 1];
          const float4 gv = *reinterpret_cast<const float4*>(gi + col);
          const float4 xv = *reinterpret_cast<const float4*>(xj + col);
          *reinterpret_cast<float4*>(act_s + (size_t)(p0 + q) * Fp + col) =
              make_float4(gw_round((gv.x * xv.x) * cutp, a.bf16),
                          gw_round((gv.y * xv.y) * cutp, a.bf16),
                          gw_round((gv.z * xv.z) * cutp, a.bf16),
                          gw_round((gv.w * xv.w) * cutp, a.bf16));
        }
      }
    }
    __syncwarp();
  }

  // ga0 = cot w1^T; gt0 = ga0 (1 - a0^2), tier-rounded, over fac_s
  gf_for_chunks(Fp, [&](auto nct, int c0) {
    constexpr int NC = decltype(nct)::value;
    float acc[GW_PP][8];
    gf_zero(acc);
    gf_colprod<PANEL, NC>(acc, act_s + p0 * Fp, Fp, Fp, W.w1, Fp, c0, W, run,
                          lane);
    if (!run) return;
#pragma unroll
    for (int q = 0; q < GW_PP; ++q)
#pragma unroll
      for (int h = 0; h < NC / 4; ++h) {
        float4* f = reinterpret_cast<float4*>(fac_s + (size_t)(p0 + q) * Fp +
                                              c0 + 64 * h + 4 * fg);
        const float4 fv = *f;
        *f = make_float4(gw_round(acc[q][4 * h] * fv.x, a.bf16),
                         gw_round(acc[q][4 * h + 1] * fv.y, a.bf16),
                         gw_round(acc[q][4 * h + 2] * fv.z, a.bf16),
                         gw_round(acc[q][4 * h + 3] * fv.w, a.bf16));
      }
  });
  if (run) __syncwarp();

  // grbf = gt0 w0^T over R in column chunks; se, sg
  float se[GW_PP], sg[GW_PP];
#pragma unroll
  for (int q = 0; q < GW_PP; ++q) se[q] = sg[q] = 0.0f;
  gf_for_chunks(r4, [&](auto nct, int c0) {
    constexpr int NC = decltype(nct)::value;
    float acc[GW_PP][8];
    gf_zero(acc);
    gf_colprod<PANEL, NC>(acc, fac_s + p0 * Fp, Fp, Fp, W.w0, r4, c0, W, run,
                          lane);
    if (!run) return;
#pragma unroll
    for (int q = 0; q < GW_PP; ++q) {
      const float dp = pd_s[4 * (p0 + q)];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int r = gf_col(c0, fg, c);
        if (r < a.R) {
          const float dr = dp - W.off[r];
          const float ge = acc[q][c] * expf(coeff * (dr * dr));
          se[q] += ge;
          sg[q] += ge * dr;
        }
      }
    }
  });
  if (!run) return;
#pragma unroll
  for (int q = 0; q < GW_PP; ++q) {
    se[q] = sum16(se[q]);
    sg[q] = sum16(sg[q]);
  }
  if (fg == 0) {
#pragma unroll
    for (int q = 0; q < GW_PP; ++q) {
      const int p = p0 + q;
      if (p < nv) {
        const int ent = ring[(head + p) & (DM_RING - 1)];
        gd[(size_t)(r0 + (ent >> 16)) * stride + (ent & 0xffff)] =
            pd_s[4 * p + 1] * (2.0f * coeff) * sg[q] +
            (sc[q] + se[q]) * pd_s[4 * p + 2];
      }
    }
  }
  __syncwarp();  // the ring and the tiles are read before they are written
}

// The body of a forward-tile kernel of this design: gw_items (SYNC with
// PANEL) over gf_fwd_tile; out [S][A][Fp].
template <bool PANEL, typename Span, typename Vote>
__device__ __forceinline__ void gf_fwd_items(float4* smem,
                                             const float* __restrict__ pos,
                                             const float* __restrict__ src,
                                             float* __restrict__ out, int S,
                                             int A, const GwArgs& a,
                                             Span span, Vote vote) {
  const GfW W = gf_stage<PANEL>(smem, a);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, Fp = a.Fp;
  float* t1_s = W.areas + (size_t)warp * a.warp_floats;      // [16][ldv]
  float* act_s = Fp <= GF_CW ? t1_s : t1_s + GW_TILE * GF_CW;  // [16][Fp]
  float* pd_s = act_s + GW_TILE * Fp;                          // [16][4]
  float* rows_s = pd_s + 4 * GW_TILE;                      // [DM_RW][Fp]
  int* ring = reinterpret_cast<int*>(rows_s + DM_RW * Fp);  // [DM_RING]
  const float coeff = *a.coeff;
  gw_items<PANEL, true>(
      S, A, Fp, rows_s, ring, out, pos, span, vote,
      [&](int head, int nv, int r0, int s, const float* ps) {
        gf_fwd_tile<PANEL>(ring, head, nv, r0, ps, src + (size_t)s * A * Fp,
                           t1_s, act_s, pd_s, rows_s, coeff, a, W, lane);
      });
}

// Forward, all pairs (gw_dense_fwd_kernel's sums).
template <bool PANEL>
__global__ void __launch_bounds__(GF_FWD_MAX_WARPS * 32, 1)
gf_dense_fwd_kernel(const float* __restrict__ pos,
                    const float* __restrict__ x, float* __restrict__ out,
                    int S, int A, GwArgs a) {
  extern __shared__ float4 gw_smem4[];
  gf_fwd_items<PANEL>(gw_smem4, pos, x, out, S, A, a, dense_span(A),
                      dense_vote(a.rcut, a.arg_scale, a.dcut_scale));
}

// Forward, neighbour matrix (gw_nbr_fwd_kernel's sums).
template <bool PANEL>
__global__ void __launch_bounds__(GF_FWD_MAX_WARPS * 32, 1)
gf_nbr_fwd_kernel(const float* __restrict__ pos, const float* __restrict__ x,
                  const int* __restrict__ idx,
                  const unsigned char* __restrict__ mask,
                  float* __restrict__ out, int S, int A, int K, GwArgs a) {
  extern __shared__ float4 gw_smem4[];
  gf_fwd_items<PANEL>(gw_smem4, pos, x, out, S, A, a, nbr_span(K),
                      nbr_vote(idx, mask, A, K, a.rcut, a.arg_scale,
                               a.dcut_scale));
}

// Backward, gx pass of the neighbour matrix over the source CSR, W
// computed again (gw_nbr_gx_kernel's sums).
template <bool PANEL>
__global__ void __launch_bounds__(GF_FWD_MAX_WARPS * 32, 1)
gf_nbr_gx_kernel(const float* __restrict__ pos,
                 const int* __restrict__ offsets,
                 const int* __restrict__ slots, const float* __restrict__ g,
                 float* __restrict__ gx, int S, int A, int K, GwArgs a) {
  extern __shared__ float4 gw_smem4[];
  gf_fwd_items<PANEL>(gw_smem4, pos, g, gx, S, A, a, csr_span(offsets, A),
                      csr_vote(slots, A, K, a.rcut, a.arg_scale,
                               a.dcut_scale));
}

// Backward, first pass (gw_bwd_kernel's vote, gd = 0 writes and sums)
// through gf_bwd_tile.
template <bool GX, bool NBR, bool PANEL>
__global__ void __launch_bounds__(GF_BWD_MAX_WARPS * 32, 1)
gf_bwd_kernel(const float* __restrict__ pos, const int* __restrict__ idx,
              const unsigned char* __restrict__ mask,
              const float* __restrict__ x, const float* __restrict__ g,
              float* __restrict__ gd, float* __restrict__ gx, int S, int A,
              int K, GwArgs a) {
  extern __shared__ float4 gw_smem4[];
  const GfW W = gf_stage<PANEL>(gw_smem4, a);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, Fp = a.Fp;
  float* t1_s = W.areas + (size_t)warp * a.warp_floats;  // [16][ldv]
  float* act_s = t1_s + GW_TILE * min(Fp, GF_CW);         // [16][Fp]
  float* fac_s = act_s + GW_TILE * Fp;                    // [16][Fp]
  float* pd_s = fac_s + GW_TILE * Fp;                     // [16][4]
  int* ring = reinterpret_cast<int*>(pd_s + 4 * GW_TILE); // [DM_RING]
  float* rows_s = reinterpret_cast<float*>(ring + DM_RING);  // GX: [DM_RW][Fp]
  const float coeff = *a.coeff;
  const int stride = NBR ? K : A;
  gw_items<PANEL, GX>(
      S, A, Fp, rows_s, ring, gx, pos, [=](int, int) {
        return make_int2(0, stride);
      },
      bwd_vote<NBR>(idx, mask, gd, A, K, a.rcut, a.arg_scale, a.dcut_scale),
      [&](int head, int nv, int r0, int s, const float* ps) {
        gf_bwd_tile<GX, NBR, PANEL>(
            ring, head, nv, r0, ps, NBR ? idx + (size_t)s * A * K : nullptr,
            stride, x + (size_t)s * A * Fp, g + (size_t)s * A * Fp, t1_s,
            act_s, fac_s, pd_s, rows_s, gd + (size_t)s * A * stride, coeff, a,
            W, lane);
      });
}

bool sizes_ok(int nbr, int S, int A, int K, int Fp, int R, int Rq) {
  return S >= 1 && A >= 1 && A <= RING_MAX && (!nbr || (K >= 1 &&
         K <= RING_MAX && (long long)S * A * K < (1LL << 31))) &&
         Fp >= GW_CW && Fp % GW_CW == 0 && R >= 1 &&
         Rq == (R + GW_RC - 1) / GW_RC * GW_RC;
}

// The launch's GwArgs; gw_launch sets warp_floats for each kernel.
GwArgs make_args(const float* w0, const float* w0t, const float* b0,
                 const float* w1, const float* w1t, const float* off,
                 const float* coeff, float* ws, int Fp, int R, int Rq,
                 int bf16, float rcut) {
  GwArgs a;
  a.w0 = w0;
  a.w0t = w0t;
  a.b0 = b0;
  a.w1 = w1;
  a.w1t = w1t;
  a.off = off;
  a.coeff = coeff;
  a.ws = ws;
  a.Fp = Fp;
  a.R = R;
  a.Rq = Rq;
  a.bf16 = bf16 ? 1 : 0;
  a.warp_floats = 0;
  a.rcut = rcut;
  a.arg_scale = (float)(PI / (double)rcut);
  a.dcut_scale = (float)(-0.5 * (PI / (double)rcut));
  return a;
}

// Launches kernel_s (tiles in shared memory) or, where gw_shape says so,
// kernel_g (tiles in a.ws); `args` points at `a`, set here for the launch.
template <typename KS, typename KG>
cudaError_t gw_launch(KS kernel_s, KG kernel_g, bool bwd, int Fp, GwArgs& a,
                      int n_items, cudaStream_t stream, void** args) {
  int warps, smem;
  bool gt;
  gw_shape(bwd, Fp, warps, smem, gt);
  a.warp_floats = gw_warp_floats(bwd, Fp);
  if (gt) {
    if (a.ws == nullptr) return cudaErrorInvalidValue;
    return launch_persistent(kernel_g, warps, smem, n_items, stream, args);
  }
  return launch_persistent(kernel_s, warps, smem, n_items, stream, args);
}

// Launches a kernel of this design with gf_shape's warps and shared
// memory for `kind` in `layout`; `args` points at `a`, whose warp_floats is
// set here for the launch.
template <typename K>
cudaError_t gf_launch(K kernel, int kind, int layout, GwArgs& a, int n_items,
                      cudaStream_t stream, void** args) {
  int warps, smem;
  gf_shape(kind, layout, a.Fp, a.R, a.Rq, warps, smem);
  if (warps < 1) return cudaErrorInvalidValue;
  a.warp_floats = (int)gf_warp_floats(kind, a.Fp);
  return launch_persistent(kernel, warps, smem, n_items, stream, args);
}

}  // namespace

extern "C" {

// Forward at any width: nbr 0 all pairs (idx, mask, K unused), 1 the
// neighbour matrix idx [S, A, K] int32 / mask [S, A, K] bytes. tier 0 fp32
// and 1 bf16 on the CUDA cores: x and out [S, A, Fp], the weights as GwArgs
// says (Fp = F rounded up to 64, Rq = R rounded up to 64), ws null unless
// cfconv_general_ws_floats(0, Fp) > 0, then that many floats. tiers 2
// and 3, bf16 on the tensor cores (cfconv_general_mma_fwd: Fp = F and Rq =
// R rounded up to 16, w0 and w1 bf16, w0t, w1t and ws unused).
int cfconv_general_fwd(int nbr, const float* pos, const int* idx,
                       const unsigned char* mask, const float* x,
                       const float* w0, const float* w0t, const float* b0,
                       const float* w1, const float* w1t, const float* off,
                       const float* coeff, float* out, float* ws, int S,
                       int A, int K, int Fp, int R, int Rq, float rcut,
                       int tier, void* stream) {
  const int n_items = S * ((A + DM_RW - 1) / DM_RW);
  cudaStream_t st = (cudaStream_t)stream;
  if (tier >= 2)
    return cfconv_general_mma_fwd(nbr, pos, idx, mask, x, w0, b0, w1, off,
                                  coeff, out, S, A, K, Fp, R, Rq, rcut, tier,
                                  stream);
  if (!sizes_ok(nbr, S, A, K, Fp, R, Rq)) return (int)cudaErrorInvalidValue;
  GwArgs a = make_args(w0, w0t, b0, w1, w1t, off, coeff, ws, Fp, R, Rq, tier,
                       rcut);
  const int layout = gf_kind_layout(GF_FWD, Fp, R, Rq);
  if (layout != GF_NONE) {
    const bool pn = layout == GF_PANELS;
    if (nbr) {
      void* args[] = {&pos, &x, &idx, &mask, &out, &S, &A, &K, &a};
      return (int)gf_launch(
          pn ? gf_nbr_fwd_kernel<true> : gf_nbr_fwd_kernel<false>, GF_FWD,
          layout, a, n_items, st, args);
    }
    void* args[] = {&pos, &x, &out, &S, &A, &a};
    return (int)gf_launch(
        pn ? gf_dense_fwd_kernel<true> : gf_dense_fwd_kernel<false>, GF_FWD,
        layout, a, n_items, st, args);
  }
  if (nbr) {
    void* args[] = {&pos, &x, &idx, &mask, &out, &S, &A, &K, &a};
    return (int)gw_launch(gw_nbr_fwd_kernel<false>, gw_nbr_fwd_kernel<true>,
                          false, Fp, a, n_items, st, args);
  }
  void* args[] = {&pos, &x, &out, &S, &A, &a};
  return (int)gw_launch(gw_dense_fwd_kernel<false>,
                        gw_dense_fwd_kernel<true>, false, Fp, a, n_items, st,
                        args);
}

// Backward at any width: gd a workspace of S * A * A (dense) or S * A * K
// (nbr) floats, every entry written before the gpos pass reads it; gx
// [S, A, Fp] or null (then not computed). x and g [S, A, Fp]. The
// neighbour matrix also takes its source CSR (csr_offsets [S * A + 1],
// csr_slots). Tiers and weights as cfconv_general_fwd; ws null unless
// cfconv_general_ws_floats(1, Fp) > 0, then that many floats (the gx pass
// shares it).
int cfconv_general_bwd(int nbr, const float* pos, const int* idx,
                       const unsigned char* mask, const int* csr_offsets,
                       const int* csr_slots, const float* x, const float* g,
                       const float* w0, const float* w0t, const float* b0,
                       const float* w1, const float* w1t, const float* off,
                       const float* coeff, float* gd, float* gpos, float* gx,
                       float* ws, int S, int A, int K, int Fp, int R, int Rq,
                       float rcut, int tier, void* stream) {
  const int n_items = S * ((A + DM_RW - 1) / DM_RW);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (tier >= 2)
    return cfconv_general_mma_bwd(nbr, pos, idx, mask, csr_offsets,
                                  csr_slots, x, g, w0, b0, w1, off, coeff,
                                  gd, gpos, gx, S, A, K, Fp, R, Rq, rcut,
                                  tier, stream);
  if (!sizes_ok(nbr, S, A, K, Fp, R, Rq)) return (int)cudaErrorInvalidValue;
  GwArgs a = make_args(w0, w0t, b0, w1, w1t, off, coeff, ws, Fp, R, Rq, tier,
                       rcut);
  void* args[] = {&pos, &idx, &mask, &x, &g, &gd, &gx, &S, &A, &K, &a};
  const int layout = gf_layout(Fp, R, Rq);
  const bool pn = layout == GF_PANELS;
  if (layout == GF_NONE) {
    if (nbr)
      err = gw_launch(gw_bwd_kernel<false, true, false>,
                      gw_bwd_kernel<false, true, true>, true, Fp, a, n_items,
                      st, args);
    else if (gx)
      err = gw_launch(gw_bwd_kernel<true, false, false>,
                      gw_bwd_kernel<true, false, true>, true, Fp, a, n_items,
                      st, args);
    else
      err = gw_launch(gw_bwd_kernel<false, false, false>,
                      gw_bwd_kernel<false, false, true>, true, Fp, a, n_items,
                      st, args);
  } else if (nbr) {
    err = gf_launch(pn ? gf_bwd_kernel<false, true, true>
                       : gf_bwd_kernel<false, true, false>,
                    GF_BWD, layout, a, n_items, st, args);
  } else if (gx) {
    err = gf_launch(pn ? gf_bwd_kernel<true, false, true>
                       : gf_bwd_kernel<true, false, false>,
                    GF_BWD_GX, layout, a, n_items, st, args);
  } else {
    err = gf_launch(pn ? gf_bwd_kernel<false, false, true>
                       : gf_bwd_kernel<false, false, false>,
                    GF_BWD, layout, a, n_items, st, args);
  }
  if (err != cudaSuccess) return (int)err;
  if (!nbr) return dense_cfconv_gpos(pos, gd, gpos, S, A, stream);
  int rc = cfconv_gpos(pos, idx, mask, csr_offsets, csr_slots, gd, gpos, S,
                       A, K, stream);
  if (rc != 0 || gx == nullptr) return rc;
  void* gargs[] = {&pos, &csr_offsets, &csr_slots, &g, &gx, &S, &A, &K, &a};
  const int gx_layout = gf_kind_layout(GF_FWD, Fp, R, Rq);
  if (gx_layout == GF_NONE)
    return (int)gw_launch(gw_nbr_gx_kernel<false>, gw_nbr_gx_kernel<true>,
                          false, Fp, a, n_items, st, gargs);
  return (int)gf_launch(gx_layout == GF_PANELS ? gf_nbr_gx_kernel<true>
                                               : gf_nbr_gx_kernel<false>,
                        GF_FWD, gx_layout, a, n_items, st, gargs);
}

// The layout of the CUDA-core tiers' kernels of `kind` (0 the forward and
// the gx pass, 1 a backward, 2 the dense backward with gx) at width Fp (F
// rounded up to 64), R and Rq (R rounded up to 64): 0 the weights staged
// whole in shared memory, 1 streamed in panels, -1 neither (the first
// design's kernels).
int cfconv_general_layout(int kind, int Fp, int R, int Rq) {
  return gf_kind_layout(kind, Fp, R, Rq);
}

// Warps a block of the CUDA-core tiers' kernel of `kind` (as
// cfconv_general_layout) at width Fp, R, Rq: gf_shape's, or gw_shape's
// where that layout is -1.
int cfconv_general_warps(int kind, int Fp, int R, int Rq) {
  int warps, smem;
  const int layout = gf_kind_layout(kind, Fp, R, Rq);
  if (layout == GF_NONE) {
    bool gt;
    gw_shape(kind != GF_FWD, Fp, warps, smem, gt);
  } else {
    gf_shape(kind, layout, Fp, R, Rq, warps, smem);
  }
  return warps;
}

// Floats of the device-memory tile workspace of a forward (bwd 0) or
// backward (1) launch at width Fp: 0 while one warp's tiles fit in shared
// memory, else one area per warp of a persistent grid (the backward's
// covers its gx pass).
int cfconv_general_ws_floats(int bwd, int Fp) {
  int warps, smem, dev, n_sm;
  bool gt;
  gw_shape(bwd != 0, Fp, warps, smem, gt);
  if (!gt) return 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  long long n = (long long)n_sm * warps * gw_warp_floats(bwd != 0, Fp);
  return n < (1LL << 31) ? (int)n : -1;
}

}  // extern "C"
