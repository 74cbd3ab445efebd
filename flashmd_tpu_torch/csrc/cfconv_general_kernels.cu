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
//     gw_dense_fwd_kernel, gw_nbr_fwd_kernel:
//                          out[i] = sum_j W_ij cut_ij x[j] over the live
//                          pairs (d < rc, j != i) or live slots (mask set,
//                          d < rc, j = idx[i, k])
//   cfconv_general_bwd  <- cfconv_dense.py _bwd_kernel (:147) and
//                          cfconv.py _bwd_kernel (:163), two or three
//                          launches:
//     gw_bwd_kernel<GX, NBR>: gd of every pair or slot (zero where dead) and,
//                          dense with GX, gx of the item's rows
//     dense_cfconv_gpos / cfconv_gpos (the tuned files' gpos passes)
//     gw_nbr_gx_kernel (neighbour matrix, when gx is asked for): gx[a] =
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
// the CUDA cores (both tiers run there). Design, the tuned kernels' ring
// with widths that are runtime values:
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
// - Precision tiers: bf16 != 0 rounds the operands of the four products to
//   bf16 where the twins do (rbf, a0, g_i x_j cut, gt0 here; the weights in
//   the wrapper); the products of bf16 values are exact in float32 and
//   accumulate in float32. tanh, the geometry, s_cut, gx and all sums stay
//   float32.
// - The neighbour-matrix backward's gx pass computes W again over the
//   source CSR (the tuned bf16 route) at both tiers instead of storing it:
//   the stored W would take 3.07 GB at S 128, A 266, K 88, F 256.

#include "cfconv_tile.cuh"

extern "C" int dense_cfconv_gpos(const float* pos, const float* gd,
                                 float* gpos, int S, int A, void* stream);
extern "C" int cfconv_gpos(const float* pos, const int* idx,
                           const unsigned char* mask, const int* offsets,
                           const int* slots, const float* gd, float* gpos,
                           int S, int A, int K, void* stream);

namespace {

constexpr int GW_PP = 8;        // pairs per lane: two groups of 8 pairs
constexpr int GW_CW = 64;       // columns per chunk: 16 lanes x 4
constexpr int GW_RC = 64;       // radial functions per rbf chunk
constexpr int GW_TILE = 16;     // ring entries per tile
// Warps a block at most: 16 of the forward tiles (at most 128 registers a
// thread), 8 of the backward's, whose s_cut, se, sg and row indices beside
// the product's 64 registers would spill under 128.
constexpr int GW_MAX_WARPS = 16;
constexpr int GW_BWD_MAX_WARPS = 8;
constexpr int GW_GT_WARPS = 8;  // warps a block, tiles in device memory
constexpr int GW_SMEM_MAX = 232448;

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

// The body of a forward-tile kernel: each warp owns work items of DM_RW
// rows of one molecule s. For each row i it walks the entries e of span(s,
// i) = [begin, end), 32 at a time, and vote(s, ps, i, e, j) says whether
// entry e is live and sets its partner j; the live ones enter the ring as
// (i - r0) << 16 | j and run through gw_fwd_tile, 16 at a time, then the
// tail, summing (W cut) src[j] into the item's rows, which are stored to
// out [S][A][Fp] (rows with no live entry as zeros).
template <bool GT, typename Span, typename Vote>
__device__ __forceinline__ void gw_fwd_items(float4* smem,
                                             const float* __restrict__ pos,
                                             const float* __restrict__ src,
                                             float* __restrict__ out, int S,
                                             int A, const GwArgs& a,
                                             Span span, Vote vote) {
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, Fp = a.Fp;
  float* act_s = gw_area<GT>(smem, a, warp);     // [16][Fp]
  float* ch_s = act_s + GW_TILE * Fp;            // [16][64]
  float* pd_s = ch_s + GW_TILE * GW_CW;          // [16][4]
  float* rows_s = pd_s + 4 * GW_TILE;            // [DM_RW][Fp]
  int* ring = reinterpret_cast<int*>(rows_s + DM_RW * Fp);  // [DM_RING]
  const float coeff = *a.coeff;

  const int n_groups = (A + DM_RW - 1) / DM_RW;
  const int n_items = S * n_groups;
  for (int item = blockIdx.x * warps + warp; item < n_items;
       item += gridDim.x * warps) {
    const int s = item / n_groups, r0 = (item % n_groups) * DM_RW;
    const float* ps = pos + (size_t)s * A * 3;
    const float* ss = src + (size_t)s * A * Fp;
    for (int e = lane; e < DM_RW * Fp; e += 32) rows_s[e] = 0.0f;
    __syncwarp();

    int head = 0, tail = 0;
    for (int rr = 0; rr < DM_RW && r0 + rr < A; ++rr) {
      const int2 range = span(s, r0 + rr);
      for (int eb = range.x; eb < range.y; eb += 32) {
        int e = eb + lane, j = 0;
        bool live = e < range.y && vote(s, ps, r0 + rr, e, j);
        tail = ring_push(ring, tail, live, (rr << 16) | j, lane);
        for (; tail - head >= GW_TILE; head += GW_TILE)
          gw_fwd_tile(ring, head, GW_TILE, r0, ps, ss, act_s, ch_s, pd_s,
                      rows_s, coeff, a, lane);
      }
    }
    if (tail > head)
      gw_fwd_tile(ring, head, tail - head, r0, ps, ss, act_s, ch_s, pd_s,
                  rows_s, coeff, a, lane);
    float* os = out + (size_t)s * A * Fp;
    for (int e = 4 * lane; e < DM_RW * Fp; e += 128) {
      const int i = r0 + e / Fp;
      if (i < A)
        *reinterpret_cast<float4*>(os + (size_t)i * Fp + e % Fp) =
            *reinterpret_cast<const float4*>(rows_s + e);
    }
    __syncwarp();  // rows_s is read before the next item writes
  }
}

// Forward, all pairs: out[i] = sum_{j != i, d < rc} W_ij cut_ij x[j].
template <bool GT>
__global__ void __launch_bounds__(GW_MAX_WARPS * 32, 1)
gw_dense_fwd_kernel(const float* __restrict__ pos,
                    const float* __restrict__ x, float* __restrict__ out,
                    int S, int A, GwArgs a) {
  extern __shared__ float4 gw_smem4[];
  gw_fwd_items<GT>(
      gw_smem4, pos, x, out, S, A, a,
      [=](int, int) { return make_int2(0, A); },
      [=](int, const float* ps, int i, int e, int& j) {
        j = e;
        float d, cut, dcut, rel[3];
        return pair_geom(ps + i * 3, ps + j * 3, j != i, a.rcut, a.arg_scale,
                         a.dcut_scale, d, cut, dcut, rel);
      });
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
  gw_fwd_items<GT>(
      gw_smem4, pos, x, out, S, A, a,
      [=](int, int) { return make_int2(0, K); },
      [=](int s, const float* ps, int i, int k, int& j) {
        const size_t slot = ((size_t)s * A + i) * K + k;
        if (!mask[slot]) return false;
        j = idx[slot];
        float d, cut, dcut, rel[3];
        return pair_geom(ps + i * 3, ps + j * 3, true, a.rcut, a.arg_scale,
                         a.dcut_scale, d, cut, dcut, rel);
      });
}

// Backward, gx pass of the neighbour matrix: gx[a] = sum over a's incoming
// slots (i, k) in source-CSR order with d < rc of W_ik cut_ik g[i], W
// computed again (the forward tile with g in place of x). d is that of p_i
// - p_a, bitwise the first pass's, so the live slots are the same.
template <bool GT>
__global__ void __launch_bounds__(GW_MAX_WARPS * 32, 1)
gw_nbr_gx_kernel(const float* __restrict__ pos,
                 const int* __restrict__ offsets,
                 const int* __restrict__ slots, const float* __restrict__ g,
                 float* __restrict__ gx, int S, int A, int K, GwArgs a) {
  extern __shared__ float4 gw_smem4[];
  gw_fwd_items<GT>(
      gw_smem4, pos, g, gx, S, A, a,
      [=](int s, int i) {
        return make_int2(offsets[s * A + i], offsets[s * A + i + 1]);
      },
      [=](int s, const float* ps, int i, int e, int& j) {
        j = slots[e] / K - s * A;
        float d, cut, dcut, rel[3];
        return pair_geom(ps + i * 3, ps + j * 3, true, a.rcut, a.arg_scale,
                         a.dcut_scale, d, cut, dcut, rel);
      });
}

// Backward, first pass: gd of every pair (dense, [S, A, A]) or slot (NBR,
// [S, A, K]) of a work item's rows, zero where dead (NBR: masked or d >=
// rc; dense: j == i or d >= rc), and with GX (dense) gx of the item's rows
// [S][A][Fp]. Each warp votes its rows' entries 32 at a time, all of them,
// writes gd = 0 for the dead ones and pushes the live ones as (row - r0)
// << 16 | e into its ring; 16 at a time through gw_bwd_tile.
template <bool GX, bool NBR, bool GT>
__global__ void __launch_bounds__(GW_BWD_MAX_WARPS * 32, 1)
gw_bwd_kernel(const float* __restrict__ pos, const int* __restrict__ idx,
              const unsigned char* __restrict__ mask,
              const float* __restrict__ x, const float* __restrict__ g,
              float* __restrict__ gd, float* __restrict__ gx, int S, int A,
              int K, GwArgs a) {
  extern __shared__ float4 gw_smem4[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, Fp = a.Fp;
  float* act_s = gw_area<GT>(gw_smem4, a, warp);  // [16][Fp]
  float* fac_s = act_s + GW_TILE * Fp;            // [16][Fp]
  float* ch_s = fac_s + GW_TILE * Fp;             // [16][64]
  float* pd_s = ch_s + GW_TILE * GW_CW;           // [16][4]
  float* rows_s = pd_s + 4 * GW_TILE;             // [DM_RW][Fp]
  int* ring = reinterpret_cast<int*>(rows_s + DM_RW * Fp);  // [DM_RING]
  const float coeff = *a.coeff;
  const int stride = NBR ? K : A;

  const int n_groups = (A + DM_RW - 1) / DM_RW;
  const int n_items = S * n_groups;
  for (int item = blockIdx.x * warps + warp; item < n_items;
       item += gridDim.x * warps) {
    const int s = item / n_groups, r0 = (item % n_groups) * DM_RW;
    const float* ps = pos + (size_t)s * A * 3;
    const float* xs = x + (size_t)s * A * Fp;
    const float* gs = g + (size_t)s * A * Fp;
    const int* is = NBR ? idx + (size_t)s * A * K : nullptr;
    const unsigned char* ms = NBR ? mask + (size_t)s * A * K : nullptr;
    float* gds = gd + (size_t)s * A * stride;
    if (GX) {
      for (int e = lane; e < DM_RW * Fp; e += 32) rows_s[e] = 0.0f;
      __syncwarp();
    }

    int head = 0, tail = 0;
    for (int rr = 0; rr < DM_RW && r0 + rr < A; ++rr) {
      const int i = r0 + rr;
      const float* pi = ps + i * 3;
      for (int eb = 0; eb < stride; eb += 32) {
        const int e = eb + lane;
        bool live = false;
        if (e < stride) {
          float d, cut, dcut, rel[3];
          if (NBR) {
            const int slot = i * K + e;
            if (ms[slot])
              live = pair_geom(pi, ps + is[slot] * 3, true, a.rcut,
                               a.arg_scale, a.dcut_scale, d, cut, dcut, rel);
          } else {
            live = pair_geom(pi, ps + e * 3, e != i, a.rcut, a.arg_scale,
                             a.dcut_scale, d, cut, dcut, rel);
          }
          if (!live) gds[(size_t)i * stride + e] = 0.0f;
        }
        tail = ring_push(ring, tail, live, (rr << 16) | e, lane);
        for (; tail - head >= GW_TILE; head += GW_TILE)
          gw_bwd_tile<GX, NBR>(ring, head, GW_TILE, r0, ps, is, stride, xs,
                               gs, act_s, fac_s, ch_s, pd_s, rows_s, gds,
                               coeff, a, lane);
      }
    }
    if (tail > head)
      gw_bwd_tile<GX, NBR>(ring, head, tail - head, r0, ps, is, stride, xs,
                           gs, act_s, fac_s, ch_s, pd_s, rows_s, gds, coeff,
                           a, lane);
    if (GX) {
      float* gxs = gx + (size_t)s * A * Fp;
      for (int e = 4 * lane; e < DM_RW * Fp; e += 128) {
        const int i = r0 + e / Fp;
        if (i < A)
          *reinterpret_cast<float4*>(gxs + (size_t)i * Fp + e % Fp) =
              *reinterpret_cast<const float4*>(rows_s + e);
      }
    }
    __syncwarp();  // rows_s is read before the next item writes
  }
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

}  // namespace

extern "C" {

// Forward at any width: nbr 0 all pairs (idx, mask, K unused), 1 the
// neighbour matrix idx [S, A, K] int32 / mask [S, A, K] bytes. x and out
// [S, A, Fp]; the weights as GwArgs says (Fp = F rounded up to 64, Rq = R
// rounded up to 64); ws null unless cfconv_general_ws_floats(0, Fp) > 0,
// then that many floats.
int cfconv_general_fwd(int nbr, const float* pos, const int* idx,
                       const unsigned char* mask, const float* x,
                       const float* w0, const float* w0t, const float* b0,
                       const float* w1, const float* w1t, const float* off,
                       const float* coeff, float* out, float* ws, int S,
                       int A, int K, int Fp, int R, int Rq, float rcut,
                       int bf16, void* stream) {
  if (!sizes_ok(nbr, S, A, K, Fp, R, Rq)) return (int)cudaErrorInvalidValue;
  GwArgs a = make_args(w0, w0t, b0, w1, w1t, off, coeff, ws, Fp, R, Rq, bf16,
                       rcut);
  const int n_items = S * ((A + DM_RW - 1) / DM_RW);
  cudaStream_t st = (cudaStream_t)stream;
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
// csr_slots). ws null unless cfconv_general_ws_floats(1, Fp) > 0, then
// that many floats (the gx pass shares it).
int cfconv_general_bwd(int nbr, const float* pos, const int* idx,
                       const unsigned char* mask, const int* csr_offsets,
                       const int* csr_slots, const float* x, const float* g,
                       const float* w0, const float* w0t, const float* b0,
                       const float* w1, const float* w1t, const float* off,
                       const float* coeff, float* gd, float* gpos, float* gx,
                       float* ws, int S, int A, int K, int Fp, int R, int Rq,
                       float rcut, int bf16, void* stream) {
  if (!sizes_ok(nbr, S, A, K, Fp, R, Rq)) return (int)cudaErrorInvalidValue;
  GwArgs a = make_args(w0, w0t, b0, w1, w1t, off, coeff, ws, Fp, R, Rq, bf16,
                       rcut);
  const int n_items = S * ((A + DM_RW - 1) / DM_RW);
  cudaStream_t st = (cudaStream_t)stream;
  void* args[] = {&pos, &idx, &mask, &x, &g, &gd, &gx, &S, &A, &K, &a};
  cudaError_t err;
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
  if (err != cudaSuccess) return (int)err;
  if (!nbr) return dense_cfconv_gpos(pos, gd, gpos, S, A, stream);
  int rc = cfconv_gpos(pos, idx, mask, csr_offsets, csr_slots, gd, gpos, S,
                       A, K, stream);
  if (rc != 0 || gx == nullptr) return rc;
  void* gargs[] = {&pos, &csr_offsets, &csr_slots, &g, &gx, &S, &A, &K, &a};
  return (int)gw_launch(gw_nbr_gx_kernel<false>, gw_nbr_gx_kernel<true>,
                        false, Fp, a, n_items, st, gargs);
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
