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
//     gw_dense_fwd_kernel, gw_nbr_fwd_kernel (bf16 on the tensor cores:
//     gw_dense_fwd_mma_kernel, gw_nbr_fwd_mma_kernel):
//                          out[i] = sum_j W_ij cut_ij x[j] over the live
//                          pairs (d < rc, j != i) or live slots (mask set,
//                          d < rc, j = idx[i, k])
//   cfconv_general_bwd  <- cfconv_dense.py _bwd_kernel (:147) and
//                          cfconv.py _bwd_kernel (:163), two or three
//                          launches:
//     gw_bwd_kernel<GX, NBR> (bf16: gw_bwd_mma_kernel<GX, NBR>): gd of
//                          every pair or slot (zero where dead) and,
//                          dense with GX, gx of the item's rows
//     dense_cfconv_gpos / cfconv_gpos (the tuned files' gpos passes)
//     gw_nbr_gx_kernel (bf16: gw_nbr_gx_mma_kernel; neighbour matrix, when
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
// (bf16). The bf16 tier runs on the tensor cores (gw_*_mma_kernel, the
// section "The bf16 tier on the tensor cores" below) wherever its bf16
// weights and one warp's tiles fit in a block's shared memory; at wider
// weights (F 1,600, say) ops/cfconv_general.py routes bf16 to the CUDA-core
// kernels at tier 1 (family "wide"). Design of the CUDA-core kernels, the
// tuned kernels' ring with widths that are runtime values:
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

// ---------------------------------------------------------------------------
// The bf16 tier on the tensor cores (tier GM_TIER of the entry points): the
// ring, work items and reductions above, with the four products as
// mma.sync m16n8k16 bf16 x bf16 -> float32 over M = the tile's 16 ring
// entries (the tuned tiles' fragment helpers of cfconv_tile.cuh, with
// runtime row strides: gm_kstep). Widths are runtime values, so no product
// keeps a whole [16][F] activation in registers: every A operand waits in
// the warp's shared memory as the lane's own bf16 fragments, one uint4 a
// lane and k-step (conflict-free, no ldmatrix), and each product runs in
// column chunks of GM_CW = 64 (32 float32 accumulators a lane). B comes
// from bf16 copies of the weights, staged once per block: w0 [Rq][Fq + 8]
// and w1 [Fq][Fq + 8] (Fq, Rq: F, R rounded up to 16; the +8 keeps ldmatrix
// free of bank conflicts), ldmatrix .trans for a product with the weight as
// stored, plain for one with its transpose, so one copy serves w1 and w1^T.
// At F 256, R 50 the weights take 170,240 of the 232,448 bytes a block may
// hold; activations in shared memory as fragments (rather than in
// registers, which a runtime width cannot index) keep a warp's area at
// 10.5-16.9 KB there: 4 warps a block forward, 3 backward with gx, 5
// without.
//
// Forward tile (gm_fwd_tile): bf16(rbf) fragments (rbf_f), a0 = tanh(rbf w0
// + b0) in column chunks stored as bf16(a0) fragments (act_f), then per
// column chunk W = a0 w1, W cut staged in v_s (over rbf_f, which is read
// no more) 32 columns at a time and summed into the item's rows in ring
// order (gm_wcut_sum), the chunk's src values loaded before its product
// (gm_load_src). Backward tile (gm_bwd_tile): the same a0 and W, with
// s_cut = sum (g_i W) x_j and, GX, the gx rows; then per column chunk ga0
// = cot w1^T with the cotangent bf16((g_i x_j) cut) formed k-step by
// k-step from x and g, the float32 a0 of the chunk for 1 - a0^2, and gt0 =
// bf16(ga0 (1 - a0^2)) into act_f over bf16(a0); then grbf = gt0 w0^T in
// chunks of 64 radial functions into se, sg and gd. The float32 a0 is kept
// in a0_s by the first pass where that costs no warp (F 64, R 300: the
// dense backward with gx 2.68-2.74 ms against 3.09 computing a0 again,
// tools/general_variants.py, H100 80GB HBM3, 700 W), else computed again
// from rbf_f (F 256, where a0_s would take 16 KB a warp). The roundings of
// the twins: rbf, a0, the cotangent, gt0 and the weights (in the
// wrapper); tanh, exp, the geometry, s_cut, se, sg, gx and every sum
// float32.

constexpr int GM_TIER = 2;          // the tier code of these kernels
constexpr int GM_NT = 8;            // n-tiles of a column chunk
constexpr int GM_CW = 8 * GM_NT;    // columns of a chunk
constexpr int GM_VCW = 32;          // columns of the W cut staging
constexpr int GM_LDV = GM_VCW + 4;  // its row stride
// Warps a block at most (tools/general_variants.py, H100 80GB HBM3, 700 W):
// 12 forward (170 registers a thread: the chunk's 32 prefetched src values
// beside its accumulators; 16 spill); 10 backward without gx (204: at F
// 64, R 300 2.23 ms against 8 warps' 2.41), 8 with gx (255: 10 took 3.48
// ms against 2.68 at F 64, R 300 and 11.22 against 9.58 at F 256, R 50).
constexpr int GM_FWD_MAX_WARPS = 12;
constexpr int GM_BWD_MAX_WARPS = 10;
constexpr int GM_BWD_GX_MAX_WARPS = 8;

// The kinds of per-warp area: forward (and the gx pass), backward, and the
// dense backward with gx (the largest).
enum { GM_FWD = 0, GM_BWD = 1, GM_BWD_GX = 2 };

// The launch's bf16 weights w0 [Rq][Fq] and w1 [Fq][Fq] (zero-padded,
// rounded in the wrapper), b0 [Fq] and the offsets [Rq] float32.
struct GmArgs {
  const __nv_bfloat16* w0;
  const __nv_bfloat16* w1;
  const float* b0;
  const float* off;
  const float* coeff;
  int Fq, R, Rq, warp_bytes, keep_a0;
  float rcut, arg_scale, dcut_scale;
};

// The block's staged weights and the start of the per-warp areas.
struct GmSmem {
  const __nv_bfloat16* w0;  // [Rq][ldw]
  const __nv_bfloat16* w1;  // [Fq][ldw]
  const float* b0;          // [Fq]
  const float* off;         // [Rq]
  unsigned char* areas;
  int ldw;
};

long gm_weight_bytes(int Fq, int Rq) {
  return 2L * (Rq + Fq) * (Fq + 8) + 4L * (Fq + Rq);
}

// Bytes of one warp's area: rbf_f [Rq / 16][32] uint4, act_f [Fq / 16][32]
// uint4, the ring; the forward's W cut staging [16][GM_LDV] over rbf_f and
// its rows [DM_RW][Fq]; the dense backward with gx both beside the rest;
// with keep, the backward's float32 a0 a0_s [Fq / 8][32] float4.
long gm_warp_bytes(int kind, int Fq, int Rq, bool keep = false) {
  const long rbf = 32L * Rq, act = 32L * Fq, vs = 4L * GW_TILE * GM_LDV;
  const long rows = 4L * DM_RW * Fq, ring = 4L * DM_RING;
  const long a0 = keep ? 64L * Fq : 0;
  if (kind == GM_FWD) return (rbf > vs ? rbf : vs) + act + rows + ring;
  if (kind == GM_BWD) return rbf + act + a0 + ring;
  return rbf + act + a0 + vs + rows + ring;
}

// Warps a block, dynamic shared memory and, for a backward, whether it
// keeps a0 (keep: where that costs no warp; else it computes a0 again for
// 1 - a0^2) of a launch of `kind`; false where the weights and one warp of
// the largest kind do not fit (the same test for every kind, so that the
// route is a function of the widths: ops/cfconv_general.py
// mma_smem_bytes).
bool gm_shape(int kind, int Fq, int Rq, int& warps, int& smem, bool& keep) {
  const long w = gm_weight_bytes(Fq, Rq);
  if (w + gm_warp_bytes(GM_BWD_GX, Fq, Rq) > GW_SMEM_MAX) return false;
  const int most = kind == GM_FWD  ? GM_FWD_MAX_WARPS
                 : kind == GM_BWD ? GM_BWD_MAX_WARPS
                                  : GM_BWD_GX_MAX_WARPS;
  const long per = gm_warp_bytes(kind, Fq, Rq);
  const long per_keep = gm_warp_bytes(kind, Fq, Rq, true);
  const long fit = (GW_SMEM_MAX - w) / per;
  const long fit_keep = (GW_SMEM_MAX - w) / per_keep;
  warps = (int)(fit < most ? fit : most);
  keep = kind != GM_FWD && (fit_keep < most ? fit_keep : most) == warps;
  smem = (int)(w + warps * (keep ? per_keep : per));
  return true;
}

// Stages the weights into the block's dynamic shared memory.
__device__ __forceinline__ GmSmem gm_stage(float4* smem, const GmArgs& a) {
  const int ldw = a.Fq + 8, cpr = a.Fq / 8;  // uint4 a weight row
  __nv_bfloat16* w0_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* w1_s = w0_s + (size_t)a.Rq * ldw;
  float* b0_s = reinterpret_cast<float*>(w1_s + (size_t)a.Fq * ldw);
  float* off_s = b0_s + a.Fq;
  for (int e = threadIdx.x; e < (a.Rq + a.Fq) * cpr; e += blockDim.x) {
    const int row = e / cpr, c = e - row * cpr;
    const __nv_bfloat16* src = row < a.Rq
        ? a.w0 + (size_t)row * a.Fq : a.w1 + (size_t)(row - a.Rq) * a.Fq;
    reinterpret_cast<uint4*>(w0_s + (size_t)row * ldw)[c] =
        __ldg(reinterpret_cast<const uint4*>(src) + c);
  }
  for (int e = threadIdx.x; e < a.Fq; e += blockDim.x) b0_s[e] = a.b0[e];
  for (int e = threadIdx.x; e < a.Rq; e += blockDim.x) off_s[e] = a.off[e];
  __syncthreads();
  GmSmem w;
  w.w0 = w0_s;
  w.w1 = w1_s;
  w.b0 = b0_s;
  w.off = off_s;
  w.areas = reinterpret_cast<unsigned char*>(off_s + a.Rq);
  w.ldw = ldw;
  return w;
}

// mma_kstep (cfconv_tile.cuh) with a runtime row stride ldw: acc[n-tiles
// 0 .. 2 np_end - 1] += a (k-step at k0) times B; TRANS, B[k][n] =
// w[k][n] (w at the chunk's first column); otherwise B[k][n] = w[n][k] (w
// at the chunk's first row).
template <bool TRANS, int NT>
__device__ __forceinline__ void gm_kstep(float (&acc)[NT][4],
                                         const unsigned (&a)[4],
                                         const __nv_bfloat16* w, int ldw,
                                         int k0, int np_end, int lane) {
  const int mat = lane >> 3, r = lane & 7;
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    if (np >= np_end) break;
    const int n0 = 16 * np;
    const __nv_bfloat16* p =
        TRANS ? w + (size_t)(k0 + 8 * (mat & 1) + r) * ldw + n0 + 8 * (mat >> 1)
              : w + (size_t)(n0 + 8 * (mat >> 1) + r) * ldw + k0 + 8 * (mat & 1);
    const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
    unsigned b[4];
    if (TRANS)
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
          "[%4];\n"
          : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
          : "r"(addr));
    else
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
          : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
          : "r"(addr));
    mma_bf16(acc[2 * np], a, b[0], b[1]);
    mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
  }
}

__device__ __forceinline__ void gm_zero(float (&acc)[GM_NT][4]) {
#pragma unroll
  for (int nt = 0; nt < GM_NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
}

// n-tile pairs of the chunk at column c0 of n columns (a multiple of 16).
__device__ __forceinline__ int gm_np_end(int n, int c0) {
  return min(GM_NT / 2, (n - c0) >> 4);
}

// acc = A times B over k-steps 0 .. nks - 1, A the lane's fragments af
// [nks][32], B from w as gm_kstep says; the sum over k in order.
template <bool TRANS>
__device__ __forceinline__ void gm_prod(float (&acc)[GM_NT][4],
                                        const uint4* af, int nks,
                                        const __nv_bfloat16* w, int ldw,
                                        int np_end, int lane) {
  gm_zero(acc);
#pragma unroll 1
  for (int ks = 0; ks < nks; ++ks) {
    const uint4 v = af[32 * ks + lane];
    const unsigned a[4] = {v.x, v.y, v.z, v.w};
    gm_kstep<TRANS>(acc, a, w, ldw, 16 * ks, np_end, lane);
  }
}

// acc (columns c0 .., np_end n-tile pairs) as bf16 A fragments of k-steps
// c0 / 16 .. into af (mlp_afrag).
__device__ __forceinline__ void gm_store_afrag(uint4* af,
                                               const float (&acc)[GM_NT][4],
                                               int c0, int np_end, int lane) {
#pragma unroll
  for (int ks = 0; ks < GM_NT / 2; ++ks) {
    if (ks >= np_end) break;
    unsigned a[4];
    mlp_afrag(a, acc, ks);
    af[32 * ((c0 >> 4) + ks) + lane] = make_uint4(a[0], a[1], a[2], a[3]);
  }
}

// bf16(rbf) of the lane's pairs (tile rows gq, gq + 8: d[h], cut[h]) as
// its A fragments of the nkr k-steps over R into rbf_f; zero past R.
__device__ __forceinline__ void gm_rbf(uint4* rbf_f, const float (&d)[2],
                                       const float (&cut)[2],
                                       const float* off_s, float coeff, int R,
                                       int nkr, int lane) {
  const int tq = lane & 3;
#pragma unroll 1
  for (int ks = 0; ks < nkr; ++ks) {
    unsigned af[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = i & 1, r = 16 * ks + 8 * (i >> 1) + 2 * tq;
      float v[2];
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const float dr = d[h] - off_s[r + b];
        v[b] = r + b < R ? expf(coeff * (dr * dr)) * cut[h] : 0.0f;
      }
      af[i] = pack_bf16x2(v[0], v[1]);
    }
    rbf_f[32 * ks + lane] = make_uint4(af[0], af[1], af[2], af[3]);
  }
}

// a0 = tanh(bf16(rbf) bf16(w0) + b0), float32, of columns c0 .. (np_end
// n-tile pairs) into acc.
__device__ __forceinline__ void gm_a0(float (&acc)[GM_NT][4],
                                      const uint4* rbf_f, int nkr,
                                      const GmSmem& w, int c0, int np_end,
                                      int lane) {
  gm_prod<true>(acc, rbf_f, nkr, w.w0 + c0, w.ldw, np_end, lane);
  const int tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < GM_NT; ++nt) {
    if (nt >= 2 * np_end) break;
    const float2 b =
        *reinterpret_cast<const float2*>(w.b0 + c0 + 8 * nt + 2 * tq);
    acc[nt][0] = tanhf(acc[nt][0] + b.x);
    acc[nt][1] = tanhf(acc[nt][1] + b.y);
    acc[nt][2] = tanhf(acc[nt][2] + b.x);
    acc[nt][3] = tanhf(acc[nt][3] + b.y);
  }
}

// rbf_f, then bf16(a0) of every column into act_f and, where a0_s is not
// null, the float32 a0 into a0_s [Fq / 8][32] (n-tile, lane).
__device__ __forceinline__ void gm_filter_a0(uint4* rbf_f, uint4* act_f,
                                             float4* a0_s,
                                             const float (&d)[2],
                                             const float (&cut)[2],
                                             float coeff, const GmArgs& a,
                                             const GmSmem& w, int lane) {
  const int nkr = a.Rq >> 4;
  gm_rbf(rbf_f, d, cut, w.off, coeff, a.R, nkr, lane);
#pragma unroll 1
  for (int c0 = 0; c0 < a.Fq; c0 += GM_CW) {
    const int np_end = gm_np_end(a.Fq, c0);
    float acc[GM_NT][4];
    gm_a0(acc, rbf_f, nkr, w, c0, np_end, lane);
    gm_store_afrag(act_f, acc, c0, np_end, lane);
    if (a0_s != nullptr) {
#pragma unroll
      for (int nt = 0; nt < GM_NT; ++nt) {
        if (nt >= 2 * np_end) break;
        a0_s[32 * ((c0 >> 3) + nt) + lane] =
            make_float4(acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3]);
      }
    }
  }
}

// src[j_t] of the ring's entries head .. head + nv - 1 at the columns
// c0 + GM_VCW h + lane of a chunk's two halves h (0 past nv or Fq): loaded
// before the chunk's product, whose MMAs then hide their latency.
__device__ __forceinline__ void gm_load_src(float (&sp)[2][GW_TILE],
                                            const int* ring, int head,
                                            int nv, const float* src, int c0,
                                            int Fq, int lane) {
#pragma unroll
  for (int t = 0; t < GW_TILE; ++t) {
    const float* row =
        src + (size_t)(ring[(head + t) & (DM_RING - 1)] & 0xffff) * Fq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + GM_VCW * h + lane;
      sp[h][t] = t < nv && c < Fq ? row[c] : 0.0f;
    }
  }
}

// The rows (row - r0, two bits each) of the ring's entries head .. head +
// 15, entry t at bits 2 t: read once per tile for its ring sums.
__device__ __forceinline__ unsigned gm_ring_rows(const int* ring, int head,
                                                 int nv) {
  static_assert(DM_RW <= 4 && GW_TILE <= 16, "two bits a row, 32 a tile");
  unsigned rows = 0;
#pragma unroll
  for (int t = 0; t < GW_TILE; ++t)
    if (t < nv) rows |= (unsigned)(ring[(head + t) & (DM_RING - 1)] >> 16)
                        << (2 * t);
  return rows;
}

// rows_s rows += (W cut) src_j over the chunk's columns c0 .. (acc = W of
// np_end n-tile pairs, sp = gm_load_src, rows = gm_ring_rows), entries in
// ring order: in halves of GM_VCW columns, W cut staged in v_s [16][GM_LDV]
// and read back into registers, then lane l sums its column c0 + GM_VCW h
// + l, a running sum per row segment (the staged values are loaded before
// the sum, which then waits on no shared memory but the segments' rows).
__device__ __forceinline__ void gm_wcut_sum(
    const float (&acc)[GM_NT][4], const float (&cut)[2],
    const float (&sp)[2][GW_TILE], float* v_s, unsigned rows, int nv,
    int c0, int np_end, float* rows_s, int Fq, int lane) {
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (2 * half >= np_end) break;
#pragma unroll
    for (int q = 0; q < GM_NT / 2; ++q) {
      const int nt = GM_NT / 2 * half + q;
      if (nt >= 2 * np_end) break;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(v_s + (gq + 8 * h) * GM_LDV + 8 * q +
                                   2 * tq) =
            make_float2(acc[nt][2 * h] * cut[h],
                        acc[nt][2 * h + 1] * cut[h]);
    }
    __syncwarp();
    float v[GW_TILE];
#pragma unroll
    for (int t = 0; t < GW_TILE; ++t) v[t] = v_s[t * GM_LDV + lane];
    __syncwarp();  // v_s is read before the next half, chunk or tile
    const int c = c0 + GM_VCW * half + lane;
    if (c < Fq) {
      float run = 0.0f;
      int cur = rows & 3;
#pragma unroll
      for (int t = 0; t < GW_TILE; ++t) {
        if (t < nv) {
          const int r = (rows >> (2 * t)) & 3;
          if (r != cur) {
            rows_s[cur * Fq + c] += run;
            run = 0.0f;
            cur = r;
          }
          run += __fmul_rn(v[t], sp[half][t]);
        }
      }
      rows_s[cur * Fq + c] += run;
    }
  }
}

// One forward tile on the tensor cores: the ring's entries head .. head +
// nv - 1 (nv <= 16) of the item at row r0, each (row - r0) << 16 | j
// (pointers at its molecule); rows_s rows += (W cut) src_j in ring order.
// v_s lies over rbf_f.
__device__ __forceinline__ void gm_fwd_tile(
    const int* ring, int head, int nv, int r0, const float* pos,
    const float* src, uint4* rbf_f, uint4* act_f, float* v_s, float* rows_s,
    float coeff, const GmArgs& a, const GmSmem& w, int lane) {
  const int gq = lane >> 2;
  float d[2], cut[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = gq + 8 * h;
    const bool ok = t < nv;
    const int ent = ok ? ring[(head + t) & (DM_RING - 1)] : 0;
    float dcut, rel[3];
    pair_geom(pos + (r0 + (ent >> 16)) * 3, pos + (ent & 0xffff) * 3, ok,
              a.rcut, a.arg_scale, a.dcut_scale, d[h], cut[h], dcut, rel);
  }
  const unsigned rows = gm_ring_rows(ring, head, nv);
  gm_filter_a0(rbf_f, act_f, nullptr, d, cut, coeff, a, w, lane);
  __syncwarp();  // rbf_f is read before v_s takes its place
  const int nkf = a.Fq >> 4;
#pragma unroll 1
  for (int c0 = 0; c0 < a.Fq; c0 += GM_CW) {
    const int np_end = gm_np_end(a.Fq, c0);
    float sp[2][GW_TILE], acc[GM_NT][4];
    gm_load_src(sp, ring, head, nv, src, c0, a.Fq, lane);
    gm_prod<true>(acc, act_f, nkf, w.w1 + c0, w.ldw, np_end, lane);
    gm_wcut_sum(acc, cut, sp, v_s, rows, nv, c0, np_end, rows_s, a.Fq,
                lane);
  }
}

// One backward tile on the tensor cores: the ring's entries head .. head +
// nv - 1 of the item at row r0 (pointers at its molecule), each (row - r0)
// << 16 | e, e the partner j (dense) or, with NBR, the slot k of the row;
// gd lands at gd[row * stride + e]. With GX (dense), rows_s rows += (W cut)
// g_j in ring order.
template <bool GX, bool NBR>
__device__ __forceinline__ void gm_bwd_tile(
    const int* ring, int head, int nv, int r0, const float* pos,
    const int* idx, int stride, const float* x, const float* g,
    uint4* rbf_f, uint4* act_f, float4* a0_s, float* v_s, float* rows_s,
    float* gd, float coeff, const GmArgs& a, const GmSmem& w, int lane) {
  static_assert(!(GX && NBR), "the neighbour-matrix gx runs over the CSR");
  const int gq = lane >> 2, tq = lane & 3, Fq = a.Fq;
  const int nkf = Fq >> 4;
  // this lane's pairs: tile rows gq (h = 0) and gq + 8 (h = 1)
  int gi_row[2], xj_row[2], ee[2];
  float d[2], cut[2], dcut[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = gq + 8 * h;
    const bool ok = t < nv;
    const int ent = ok ? ring[(head + t) & (DM_RING - 1)] : 0;
    gi_row[h] = r0 + (ent >> 16);
    ee[h] = ent & 0xffff;
    xj_row[h] = df_partner<NBR>(idx, stride, r0, ent);
    float rel[3];
    pair_geom(pos + gi_row[h] * 3, pos + xj_row[h] * 3, ok, a.rcut,
              a.arg_scale, a.dcut_scale, d[h], cut[h], dcut[h], rel);
  }
  gm_filter_a0(rbf_f, act_f, a.keep_a0 ? a0_s : nullptr, d, cut, coeff, a,
               w, lane);
  const unsigned rows = GX ? gm_ring_rows(ring, head, nv) : 0u;

  // W = bf16(a0) w1 per chunk: s_cut = sum_f (g_i W) x_j; with GX the gx rows
  float sc[2] = {0.0f, 0.0f};
#pragma unroll 1
  for (int c0 = 0; c0 < Fq; c0 += GM_CW) {
    const int np_end = gm_np_end(Fq, c0);
    float sp[2][GW_TILE], acc[GM_NT][4];
    if (GX) gm_load_src(sp, ring, head, nv, g, c0, Fq, lane);
    gm_prod<true>(acc, act_f, nkf, w.w1 + c0, w.ldw, np_end, lane);
#pragma unroll
    for (int nt = 0; nt < GM_NT; ++nt) {
      if (nt >= 2 * np_end) break;
      const int f = c0 + 8 * nt + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 gv =
            *reinterpret_cast<const float2*>(g + (size_t)gi_row[h] * Fq + f);
        const float2 xv =
            *reinterpret_cast<const float2*>(x + (size_t)xj_row[h] * Fq + f);
        sc[h] += (gv.x * acc[nt][2 * h]) * xv.x;
        sc[h] += (gv.y * acc[nt][2 * h + 1]) * xv.y;
      }
    }
    if (GX)
      gm_wcut_sum(acc, cut, sp, v_s, rows, nv, c0, np_end, rows_s, Fq,
                  lane);
  }

  // per chunk: ga0 = bf16((g_i x_j) cut) w1^T, a0 again, gt0 = bf16(ga0
  // (1 - a0^2)) into act_f in bf16(a0)'s place (W has read it)
  const int nkr = a.Rq >> 4;
#pragma unroll 1
  for (int c0 = 0; c0 < Fq; c0 += GM_CW) {
    const int np_end = gm_np_end(Fq, c0);
    float ga[GM_NT][4];
    gm_zero(ga);
    // x_j and g_i of the lane's fragment, loaded one k-step ahead
    float2 xv[4], gv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = i & 1, k = 8 * (i >> 1) + 2 * tq;
      xv[i] = *reinterpret_cast<const float2*>(x + (size_t)xj_row[h] * Fq + k);
      gv[i] = *reinterpret_cast<const float2*>(g + (size_t)gi_row[h] * Fq + k);
    }
#pragma unroll 1
    for (int ks = 0; ks < nkf; ++ks) {
      unsigned af[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float c = cut[i & 1];
        af[i] = pack_bf16x2((gv[i].x * xv[i].x) * c, (gv[i].y * xv[i].y) * c);
      }
      if (ks + 1 < nkf) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i & 1, k = 16 * (ks + 1) + 8 * (i >> 1) + 2 * tq;
          xv[i] = *reinterpret_cast<const float2*>(x + (size_t)xj_row[h] * Fq
                                                   + k);
          gv[i] = *reinterpret_cast<const float2*>(g + (size_t)gi_row[h] * Fq
                                                   + k);
        }
      }
      gm_kstep<false>(ga, af, w.w1 + (size_t)c0 * w.ldw, w.ldw, 16 * ks,
                      np_end, lane);
    }
    float a0[GM_NT][4];
    if (a.keep_a0) {
#pragma unroll
      for (int nt = 0; nt < GM_NT; ++nt) {
        if (nt >= 2 * np_end) break;
        const float4 v = a0_s[32 * ((c0 >> 3) + nt) + lane];
        a0[nt][0] = v.x;
        a0[nt][1] = v.y;
        a0[nt][2] = v.z;
        a0[nt][3] = v.w;
      }
    } else {
      gm_a0(a0, rbf_f, nkr, w, c0, np_end, lane);
    }
#pragma unroll
    for (int nt = 0; nt < GM_NT; ++nt) {
      if (nt >= 2 * np_end) break;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ga[nt][e] *= 1.0f - a0[nt][e] * a0[nt][e];
    }
    gm_store_afrag(act_f, ga, c0, np_end, lane);
  }

  // grbf = bf16(gt0) w0^T in chunks of 64 radial functions; se, sg
  float se[2] = {0.0f, 0.0f}, sg[2] = {0.0f, 0.0f};
#pragma unroll 1
  for (int rc0 = 0; rc0 < a.Rq; rc0 += GM_CW) {
    const int np_end = gm_np_end(a.Rq, rc0);
    float acc[GM_NT][4];
    gm_prod<false>(acc, act_f, nkf, w.w0 + (size_t)rc0 * w.ldw, w.ldw,
                   np_end, lane);
#pragma unroll
    for (int nt = 0; nt < GM_NT; ++nt) {
      if (nt >= 2 * np_end) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = rc0 + 8 * nt + 2 * tq + (e & 1), h = e >> 1;
        if (r < a.R) {
          const float dr = d[h] - w.off[r];
          const float ge = acc[nt][e] * expf(coeff * (dr * dr));
          se[h] += ge;
          sg[h] += ge * dr;
        }
      }
    }
  }

  // gd of the lane's pairs: sums over the quad's columns, then the pair
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sc[h] += __shfl_xor_sync(0xffffffffu, sc[h], o);
      se[h] += __shfl_xor_sync(0xffffffffu, se[h], o);
      sg[h] += __shfl_xor_sync(0xffffffffu, sg[h], o);
    }
  if (tq == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (gq + 8 * h < nv)
        gd[(size_t)gi_row[h] * stride + ee[h]] =
            cut[h] * (2.0f * coeff) * sg[h] + (sc[h] + se[h]) * dcut[h];
  }
  __syncwarp();  // the ring and the tiles are read before they are written
}

// The body of a tensor-core forward-tile kernel: gw_fwd_items with the
// weights staged once per block and gm_fwd_tile; out [S][A][Fq].
template <typename Span, typename Vote>
__device__ __forceinline__ void gm_fwd_items(float4* smem,
                                             const float* __restrict__ pos,
                                             const float* __restrict__ src,
                                             float* __restrict__ out, int S,
                                             int A, const GmArgs& a,
                                             Span span, Vote vote) {
  const GmSmem w = gm_stage(smem, a);
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, Fq = a.Fq;
  unsigned char* area = w.areas + (size_t)warp * a.warp_bytes;
  const int lead = max(32 * a.Rq, 4 * GW_TILE * GM_LDV);
  uint4* rbf_f = reinterpret_cast<uint4*>(area);          // [Rq / 16][32]
  float* v_s = reinterpret_cast<float*>(area);            // [16][GM_LDV]
  uint4* act_f = reinterpret_cast<uint4*>(area + lead);   // [Fq / 16][32]
  float* rows_s = reinterpret_cast<float*>(area + lead + 32 * Fq);
  int* ring = reinterpret_cast<int*>(rows_s + DM_RW * Fq);  // [DM_RING]
  const float coeff = *a.coeff;

  const int n_groups = (A + DM_RW - 1) / DM_RW;
  const int n_items = S * n_groups;
  for (int item = blockIdx.x * warps + warp; item < n_items;
       item += gridDim.x * warps) {
    const int s = item / n_groups, r0 = (item % n_groups) * DM_RW;
    const float* ps = pos + (size_t)s * A * 3;
    const float* ss = src + (size_t)s * A * Fq;
    for (int e = lane; e < DM_RW * Fq; e += 32) rows_s[e] = 0.0f;
    __syncwarp();

    int head = 0, tail = 0;
    for (int rr = 0; rr < DM_RW && r0 + rr < A; ++rr) {
      const int2 range = span(s, r0 + rr);
      for (int eb = range.x; eb < range.y; eb += 32) {
        int e = eb + lane, j = 0;
        bool live = e < range.y && vote(s, ps, r0 + rr, e, j);
        tail = ring_push(ring, tail, live, (rr << 16) | j, lane);
        for (; tail - head >= GW_TILE; head += GW_TILE)
          gm_fwd_tile(ring, head, GW_TILE, r0, ps, ss, rbf_f, act_f, v_s,
                      rows_s, coeff, a, w, lane);
      }
    }
    if (tail > head)
      gm_fwd_tile(ring, head, tail - head, r0, ps, ss, rbf_f, act_f, v_s,
                  rows_s, coeff, a, w, lane);
    float* os = out + (size_t)s * A * Fq;
    for (int e = 4 * lane; e < DM_RW * Fq; e += 128) {
      const int i = r0 + e / Fq;
      if (i < A)
        *reinterpret_cast<float4*>(os + (size_t)i * Fq + e % Fq) =
            *reinterpret_cast<const float4*>(rows_s + e);
    }
    __syncwarp();  // rows_s is read before the next item writes
  }
}

// Forward, all pairs, on the tensor cores (gw_dense_fwd_kernel's vote).
__global__ void __launch_bounds__(GM_FWD_MAX_WARPS * 32, 1)
gw_dense_fwd_mma_kernel(const float* __restrict__ pos,
                        const float* __restrict__ x, float* __restrict__ out,
                        int S, int A, GmArgs a) {
  extern __shared__ float4 gw_smem4[];
  gm_fwd_items(
      gw_smem4, pos, x, out, S, A, a,
      [=](int, int) { return make_int2(0, A); },
      [=](int, const float* ps, int i, int e, int& j) {
        j = e;
        float d, cut, dcut, rel[3];
        return pair_geom(ps + i * 3, ps + j * 3, j != i, a.rcut, a.arg_scale,
                         a.dcut_scale, d, cut, dcut, rel);
      });
}

// Forward, neighbour matrix, on the tensor cores (gw_nbr_fwd_kernel's
// vote: masked slots skipped before idx is read).
__global__ void __launch_bounds__(GM_FWD_MAX_WARPS * 32, 1)
gw_nbr_fwd_mma_kernel(const float* __restrict__ pos,
                      const float* __restrict__ x,
                      const int* __restrict__ idx,
                      const unsigned char* __restrict__ mask,
                      float* __restrict__ out, int S, int A, int K,
                      GmArgs a) {
  extern __shared__ float4 gw_smem4[];
  gm_fwd_items(
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

// Backward, gx pass of the neighbour matrix, on the tensor cores
// (gw_nbr_gx_kernel's walk over the source CSR, W computed again).
__global__ void __launch_bounds__(GM_FWD_MAX_WARPS * 32, 1)
gw_nbr_gx_mma_kernel(const float* __restrict__ pos,
                     const int* __restrict__ offsets,
                     const int* __restrict__ slots,
                     const float* __restrict__ g, float* __restrict__ gx,
                     int S, int A, int K, GmArgs a) {
  extern __shared__ float4 gw_smem4[];
  gm_fwd_items(
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

// Backward, first pass, on the tensor cores: gw_bwd_kernel's vote, gd = 0
// writes and ring, through gm_bwd_tile.
template <bool GX, bool NBR>
__global__ void __launch_bounds__(
    (GX ? GM_BWD_GX_MAX_WARPS : GM_BWD_MAX_WARPS) * 32, 1)
gw_bwd_mma_kernel(const float* __restrict__ pos, const int* __restrict__ idx,
                  const unsigned char* __restrict__ mask,
                  const float* __restrict__ x, const float* __restrict__ g,
                  float* __restrict__ gd, float* __restrict__ gx, int S,
                  int A, int K, GmArgs a) {
  extern __shared__ float4 gw_smem4[];
  const GmSmem w = gm_stage(gw_smem4, a);
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, Fq = a.Fq;
  unsigned char* area = w.areas + (size_t)warp * a.warp_bytes;
  uint4* rbf_f = reinterpret_cast<uint4*>(area);                // [Rq/16][32]
  uint4* act_f = reinterpret_cast<uint4*>(area + 32 * a.Rq);    // [Fq/16][32]
  float4* a0_s = reinterpret_cast<float4*>(area + 32 * a.Rq + 32 * Fq);
  unsigned char* rest =
      area + 32 * a.Rq + 32 * Fq + (a.keep_a0 ? 64 * Fq : 0);   // keep: a0_s
  float* v_s = reinterpret_cast<float*>(rest);                  // GX: [16][GM_LDV]
  float* rows_s = v_s + GW_TILE * GM_LDV;                       // GX: [DM_RW][Fq]
  int* ring = GX ? reinterpret_cast<int*>(rows_s + DM_RW * Fq)
                 : reinterpret_cast<int*>(rest);                // [DM_RING]
  const float coeff = *a.coeff;
  const int stride = NBR ? K : A;

  const int n_groups = (A + DM_RW - 1) / DM_RW;
  const int n_items = S * n_groups;
  for (int item = blockIdx.x * warps + warp; item < n_items;
       item += gridDim.x * warps) {
    const int s = item / n_groups, r0 = (item % n_groups) * DM_RW;
    const float* ps = pos + (size_t)s * A * 3;
    const float* xs = x + (size_t)s * A * Fq;
    const float* gs = g + (size_t)s * A * Fq;
    const int* is = NBR ? idx + (size_t)s * A * K : nullptr;
    const unsigned char* ms = NBR ? mask + (size_t)s * A * K : nullptr;
    float* gds = gd + (size_t)s * A * stride;
    if (GX) {
      for (int e = lane; e < DM_RW * Fq; e += 32) rows_s[e] = 0.0f;
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
          gm_bwd_tile<GX, NBR>(ring, head, GW_TILE, r0, ps, is, stride, xs,
                               gs, rbf_f, act_f, a0_s, v_s, rows_s, gds,
                               coeff, a, w, lane);
      }
    }
    if (tail > head)
      gm_bwd_tile<GX, NBR>(ring, head, tail - head, r0, ps, is, stride, xs,
                           gs, rbf_f, act_f, a0_s, v_s, rows_s, gds, coeff,
                           a, w, lane);
    if (GX) {
      float* gxs = gx + (size_t)s * A * Fq;
      for (int e = 4 * lane; e < DM_RW * Fq; e += 128) {
        const int i = r0 + e / Fq;
        if (i < A)
          *reinterpret_cast<float4*>(gxs + (size_t)i * Fq + e % Fq) =
              *reinterpret_cast<const float4*>(rows_s + e);
      }
    }
    __syncwarp();  // rows_s is read before the next item writes
  }
}

bool gm_sizes_ok(int nbr, int S, int A, int K, int Fq, int R, int Rq) {
  return S >= 1 && A >= 1 && A <= RING_MAX && (!nbr || (K >= 1 &&
         K <= RING_MAX && (long long)S * A * K < (1LL << 31))) &&
         Fq >= 16 && Fq % 16 == 0 && R >= 1 && Rq == (R + 15) / 16 * 16;
}

GmArgs gm_args(const float* w0, const float* w1, const float* b0,
               const float* off, const float* coeff, int Fq, int R, int Rq,
               float rcut) {
  GmArgs a;
  a.w0 = reinterpret_cast<const __nv_bfloat16*>(w0);
  a.w1 = reinterpret_cast<const __nv_bfloat16*>(w1);
  a.b0 = b0;
  a.off = off;
  a.coeff = coeff;
  a.Fq = Fq;
  a.R = R;
  a.Rq = Rq;
  a.warp_bytes = 0;
  a.keep_a0 = 0;
  a.rcut = rcut;
  a.arg_scale = (float)(PI / (double)rcut);
  a.dcut_scale = (float)(-0.5 * (PI / (double)rcut));
  return a;
}

// Launches `kernel` with gm_shape's warps and shared memory for `kind`;
// `args` points at `a`, whose warp_bytes and keep_a0 are set here for the
// launch.
template <typename K>
cudaError_t gm_launch(K kernel, int kind, GmArgs& a, int n_items,
                      cudaStream_t stream, void** args) {
  int warps, smem;
  bool keep;
  if (!gm_shape(kind, a.Fq, a.Rq, warps, smem, keep))
    return cudaErrorInvalidValue;
  a.keep_a0 = keep ? 1 : 0;
  a.warp_bytes = (int)gm_warp_bytes(kind, a.Fq, a.Rq, keep);
  return launch_persistent(kernel, warps, smem, n_items, stream, args);
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
// neighbour matrix idx [S, A, K] int32 / mask [S, A, K] bytes. tier 0 fp32
// and 1 bf16 on the CUDA cores: x and out [S, A, Fp], the weights as GwArgs
// says (Fp = F rounded up to 64, Rq = R rounded up to 64), ws null unless
// cfconv_general_ws_floats(0, Fp) > 0, then that many floats. tier 2
// (GM_TIER) bf16 on the tensor cores: Fp = F and Rq = R rounded up to 16,
// w0 [Rq][Fp] and w1 [Fp][Fp] bf16 (as GmArgs says), w0t, w1t and ws
// unused; refused where the weights do not fit in shared memory (gm_shape).
int cfconv_general_fwd(int nbr, const float* pos, const int* idx,
                       const unsigned char* mask, const float* x,
                       const float* w0, const float* w0t, const float* b0,
                       const float* w1, const float* w1t, const float* off,
                       const float* coeff, float* out, float* ws, int S,
                       int A, int K, int Fp, int R, int Rq, float rcut,
                       int tier, void* stream) {
  const int n_items = S * ((A + DM_RW - 1) / DM_RW);
  cudaStream_t st = (cudaStream_t)stream;
  if (tier == GM_TIER) {
    if (!gm_sizes_ok(nbr, S, A, K, Fp, R, Rq))
      return (int)cudaErrorInvalidValue;
    GmArgs m = gm_args(w0, w1, b0, off, coeff, Fp, R, Rq, rcut);
    if (nbr) {
      void* args[] = {&pos, &x, &idx, &mask, &out, &S, &A, &K, &m};
      return (int)gm_launch(gw_nbr_fwd_mma_kernel, GM_FWD, m, n_items, st,
                            args);
    }
    void* args[] = {&pos, &x, &out, &S, &A, &m};
    return (int)gm_launch(gw_dense_fwd_mma_kernel, GM_FWD, m, n_items, st,
                          args);
  }
  if (!sizes_ok(nbr, S, A, K, Fp, R, Rq)) return (int)cudaErrorInvalidValue;
  GwArgs a = make_args(w0, w0t, b0, w1, w1t, off, coeff, ws, Fp, R, Rq, tier,
                       rcut);
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
  if (tier == GM_TIER) {
    if (!gm_sizes_ok(nbr, S, A, K, Fp, R, Rq))
      return (int)cudaErrorInvalidValue;
    GmArgs m = gm_args(w0, w1, b0, off, coeff, Fp, R, Rq, rcut);
    void* args[] = {&pos, &idx, &mask, &x, &g, &gd, &gx, &S, &A, &K, &m};
    if (nbr)
      err = gm_launch(gw_bwd_mma_kernel<false, true>, GM_BWD, m, n_items, st,
                      args);
    else if (gx)
      err = gm_launch(gw_bwd_mma_kernel<true, false>, GM_BWD_GX, m, n_items,
                      st, args);
    else
      err = gm_launch(gw_bwd_mma_kernel<false, false>, GM_BWD, m, n_items,
                      st, args);
    if (err != cudaSuccess) return (int)err;
    if (!nbr) return dense_cfconv_gpos(pos, gd, gpos, S, A, stream);
    int rc = cfconv_gpos(pos, idx, mask, csr_offsets, csr_slots, gd, gpos, S,
                         A, K, stream);
    if (rc != 0 || gx == nullptr) return rc;
    void* gargs[] = {&pos, &csr_offsets, &csr_slots, &g, &gx, &S, &A, &K, &m};
    return (int)gm_launch(gw_nbr_gx_mma_kernel, GM_FWD, m, n_items, st,
                          gargs);
  }
  if (!sizes_ok(nbr, S, A, K, Fp, R, Rq)) return (int)cudaErrorInvalidValue;
  GwArgs a = make_args(w0, w0t, b0, w1, w1t, off, coeff, ws, Fp, R, Rq, tier,
                       rcut);
  void* args[] = {&pos, &idx, &mask, &x, &g, &gd, &gx, &S, &A, &K, &a};
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
