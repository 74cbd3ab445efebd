"""Design variants of the CFConv kernels, timed on the card.

    python3 tools/bwd_variants.py [function ...]

Each variant is an edited copy of one source of flashmd_tpu_torch/csrc
and, where it edits it, of the shared header cfconv_tile.cuh (text
substitutions), compiled into a library of its own, all in parallel;
ptxas' registers and spills of its tensor-core kernels are printed, then
the function at its slice's shapes is held against its twin and timed
with CUDA events (batch 128, 266 beads, F = 128, bf16; the combined cheb
backward also at bf16x3, on the bf16x3 slice's (64, 96) fit; the dense
and the neighbour-matrix kernels also at fp32, on their CUDA-core
kernels; open boundaries; the neighbour-matrix kernels on the pallas
slice's list). Naming functions (e.g. dense_cfconv_bwd_fp32) builds and
times those alone:

* cheb_bwd_gxgd (cheb_gxgd_mma_kernel, the per-block slice's fit):
  base   -- the source as it is: at bf16 three blocks per SM (at most
            168 registers a thread, 12 warps per SM), at bf16x3 up to 255;
  lb1    -- every tier up to 255 registers (two blocks, 8 warps per SM);
  lb3    -- every tier three blocks per SM.
* dense_cfconv_bwd (dense_bwd_mma_kernel, with gx):
  base   -- the source as it is (8 warps, 4 rows per work item; more
            rows or warps do not fit in shared memory);
  rw2    -- 2 rows per work item (more items, more padded tails);
  inline -- ga0's x_j and g_i loaded in their own k-step, not one ahead
            (the gx instantiation then spills 12 B).
* dense_cfconv_bwd_fp32 (dense_bwd_ffma_kernel, with and without gx):
  base       -- the source as it is (4 warps a block beside the staged
                float32 weights, one per scheduler; the item's gx rows in
                shared memory);
  gx_global  -- the item's gx rows summed in place in device memory (its
                warp owns them);
  row_unroll2, col_unroll2 -- the products with w (a0, W) or with w^T
                (ga0, grbf) unrolled over two 4-step slices of the
                reduction (the source: one);
  w6, w5, w3 -- 6 (as many as shared memory holds), 5 or 3 warps a block;
  gi_smem    -- the item's g rows staged in the warp's shared memory for
                s_cut and the cotangent (the source reads g_i from device
                memory, through L1);
* dense_cfconv_fwd_fp32 (dense_fwd_ffma_kernel):
  base       -- the source as it is (FF_WARPS warps a block beside the
                staged float32 weights);
  w4, w6, w12 -- 4 (one per scheduler, the backward's choice), 6 or 12
                (as many as shared memory holds) warps a block.
* dense_cfconv_fwd (dense_fwd_mma_kernel):
  base   -- the source as it is (16 warps, at most 128 registers);
  w8     -- 8 warps a block (up to 255 registers);
  w12    -- 12 warps a block (up to 168 registers);
  rw2    -- 2 rows per work item.
* cfconv_fwd_fp32 (nbr_fwd_ffma_kernel, then the dense fp32 forward):
  parent     -- the parent's conv_kernel (float32 tiles on every 4 x 16
                chunk of slots that holds a live one, a block per 4 rows);
  base       -- the source as it is (FF_WARPS warps a block);
  w4, w6, w12 -- 4, 6 or 12 warps a block;
  dense_base, dense_parent -- dense_fwd_ffma_kernel on the shared header
                as it is and with the parent's chunk layout put back: its
                times and whether the two agree bitwise.
* cfconv_fwd (nbr_fwd_mma_kernel), as dense_cfconv_fwd:
  base   -- the source as it is (16 warps, at most 128 registers);
  w8     -- 8 warps a block (up to 255 registers);
  w12    -- 12 warps a block (up to 168 registers);
  rw2    -- 2 rows per work item.
* cfconv_bwd (nbr_bwd_mma_kernel, then nbr_gx_mma_kernel, with gx):
  base   -- the source as it is (the gx pass at 16 warps);
  w8     -- the gx pass at 8 warps a block;
  rw2    -- 2 rows (first pass) and atoms (gx pass) per work item.
* cfconv_bwd_fp32 (nbr_bwd_ffma_kernel, then gpos_kernel and the gx pass,
  with gx; each variant's peak device memory above its inputs printed):
  base      -- the source as it is: the first pass stores W of every live
               slot into the [S, A, K, F] workspace, gx_kernel reads it
               back over the source CSR;
  recompute -- no workspace: the first pass without the store, and a gx
               pass (nbr_gx_ffma_kernel) that computes W again, the fp32
               forward's tile over each atom's incoming live slots
               (fwd_items<false> over the CSR, as nbr_gx_mma_kernel at
               bf16).

Needs a CUDA card and nvcc; prints the card's name and power limit last.
"""

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from flashmd_tpu_torch.data.system import collate  # noqa: E402
from flashmd_tpu_torch.models.cheb import _lin_slope  # noqa: E402
from flashmd_tpu_torch.ops import _build  # noqa: E402
from flashmd_tpu_torch.ops import cfconv as cf  # noqa: E402
from flashmd_tpu_torch.ops import cfconv_dense as cd  # noqa: E402
from flashmd_tpu_torch.ops import cheb_kernel as ck  # noqa: E402
from flashmd_tpu_torch.ops._launch import TIER_CODES, _ptr, _stream  # noqa: E402

GXGD_LB = "TIER == TIER_X3 ? 1 : 3)\ncheb_gxgd_mma_kernel"
TILE = "cfconv_tile.cuh"
RW = "constexpr int DM_RW = 4;       // rows per work item"
FW = "constexpr int FW_WARPS = 16;   // warps per block of the forward tiles"
GA_LOOP = """#pragma unroll 1
  for (int ks = 0; ks < 8; ++ks) {
    unsigned af[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int h = i & 1, k = 16 * ks + 8 * (i >> 1) + 2 * tq;
      const float2 xv =
          *reinterpret_cast<const float2*>(x + (size_t)jj[h] * F + k);
      const float2 gv = *reinterpret_cast<const float2*>(gi_s + rr[h] * F + k);
      af[i] = pack_bf16x2((gv.x * xv.x) * cut[h], (gv.y * xv.y) * cut[h]);
    }"""
GA_AHEAD = """  float2 xv[4], gv[4];
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
    }"""
DENSE = "cfconv_dense_kernels.cu"
DF_WARP = """constexpr int DF_WARP_FLOATS = 2 * DF_TILE * F + DM_RW * F + 4 * DF_TILE +
                               DM_RING;"""
DF_GX_S = """  float* gx_s = buf_s + DF_TILE * F;                    // [DM_RW][F]
  float* pd_s = gx_s + DM_RW * F;                       // [DF_TILE][4]"""
DF_GX_ZERO = """    if (GX) {
      for (int e = lane; e < DM_RW * F; e += 32) gx_s[e] = 0.0f;
      __syncwarp();
    }"""
DF_GX_OUT = """    if (GX) {
      float* gxs = gx + (size_t)s * A * F;
      for (int e = 4 * lane; e < DM_RW * F; e += 128) {
        int i = r0 + e / F;
        if (i < A)
          *reinterpret_cast<float4*>(gxs + (size_t)i * F + e % F) =
              *reinterpret_cast<const float4*>(gx_s + e);
      }
    }
"""
DF_W = "constexpr int DF_WARPS = 4;"
DF_GI = """    const float* gi = g + (size_t)(r0 + (ent >> 16)) * F + 4 * fg;"""
DF_PD = """  float* pd_s = gx_s + DM_RW * F;                       // [DF_TILE][4]"""
DF_ZERO = """      for (int e = lane; e < DM_RW * F; e += 32) gx_s[e] = 0.0f;
      __syncwarp();
    }"""
DF_ZERO_GI = """      for (int e = lane; e < DM_RW * F; e += 32) gx_s[e] = 0.0f;
      __syncwarp();
    }
    for (int e = lane; e < DM_RW * F; e += 32) {
      int i = r0 + e / F;
      gx_s[DM_RW * F + e] = i < A ? gs[(size_t)i * F + e % F] : 0.0f;
    }
    __syncwarp();"""
GI_SMEM = {
    TILE: {DF_WARP: DF_WARP.replace("DM_RW * F", "2 * DM_RW * F"),
           DF_GI: "    const float* gi = gx_s + (DM_RW + (ent >> 16)) * F "
                  "+ 4 * fg;"},
    DENSE: {DF_PD: DF_PD.replace("DM_RW * F", "2 * DM_RW * F"),
            DF_ZERO: DF_ZERO_GI}}
DF_K = """#pragma unroll 1
  for (int k = {}; k < {}; k += 4) {{"""
FF_W = "constexpr int FF_WARPS = 8;"
NBR = "cfconv_kernels.cu"
NB_PASS1 = """    err = launch_persistent(gx ? nbr_bwd_ffma_kernel<true>
                               : nbr_bwd_ffma_kernel<false>,"""
NB_WBUF = "      (!bf16 && (gx == nullptr) != (wbuf == nullptr)))"
NB_SIZES = "bool sizes_ok(int S, int A, int K, int Fdim, int R) {"
NB_GX_PASS = """  gx_kernel<<<dim3(A, S), F, 0, st>>>(pos, g, csr_offsets, csr_slots, wbuf,
                                      gx, A, K, rcut, arg_scale, dcut_scale);
  return (int)cudaGetLastError();"""
# the fp32 forward's tile over each atom's incoming live slots of the
# source CSR, g in x's place (nbr_gx_mma_kernel's items at fp32)
NB_GX_FFMA = """__global__ void __launch_bounds__(FF_WARPS * 32, 1)
nbr_gx_ffma_kernel(const float* __restrict__ pos,
                   const int* __restrict__ offsets,
                   const int* __restrict__ slots, const float* __restrict__ g,
                   const float* __restrict__ w0, const float* __restrict__ b0,
                   const float* __restrict__ w1,
                   const float* __restrict__ offset,
                   const float* __restrict__ coeff_p, float* __restrict__ gx,
                   int S, int A, int K, int R, float rcut, float arg_scale,
                   float dcut_scale) {
  extern __shared__ float4 ffma_smem4[];
  fwd_items<false>(
      ffma_smem4, pos, g, w0, b0, w1, offset, coeff_p, gx, S, A, R, rcut,
      arg_scale, dcut_scale,
      [=](int s, int a) {
        return make_int2(offsets[s * A + a], offsets[s * A + a + 1]);
      },
      [=](int s, const float* ps, int a, int e, int& i) {
        i = slots[e] / K - s * A;
        float d, cut, dcut, rel[3];
        return pair_geom(ps + a * 3, ps + i * 3, true, rcut, arg_scale,
                         dcut_scale, d, cut, dcut, rel);
      });
}

"""
# The parent's fp32 neighbour-matrix forward, for the cfconv_fwd_fp32
# variants: the 64-slot chunk layout and its helpers, as the shared header
# had them, and conv_kernel, with its launch on a (row tiles, molecules)
# grid.
CONV_CHUNK = """constexpr int FPT = F / 16;      // features per thread: f = fg + 16 c
constexpr int ROWS = 4;          // destination rows per block
constexpr int COLS = 16;         // partners per row and chunk
constexpr int NP = ROWS * COLS;  // pairs per chunk: p = row * COLS + col
constexpr int LDW = F + 1;       // padded weight row stride
constexpr int LDA = NP + 4;      // padded pair stride of [k][pair] tiles

// w0_s [RMAX][LDW] and w1_s [F][LDW], in floats.
constexpr int W_FLOATS = RMAX * LDW + F * LDW;

// w0 [R, F] -> w0_s [RMAX][LDW] (rows >= R zero), w1 [F, F] -> w1_s
// [F][LDW]; b0 and offsets as they are.
__device__ void load_weights(const float* __restrict__ w0,
                             const float* __restrict__ b0,
                             const float* __restrict__ w1,
                             const float* __restrict__ offset, int R,
                             float* w0_s, float* w1_s, float* b0_s,
                             float* off_s) {
  for (int e = threadIdx.x; e < RMAX * F; e += THREADS) {
    int r = e / F, f = e % F;
    w0_s[r * LDW + f] = r < R ? w0[r * F + f] : 0.0f;
  }
  for (int e = threadIdx.x; e < F * F; e += THREADS)
    w1_s[(e / F) * LDW + e % F] = w1[e];
  for (int e = threadIdx.x; e < F; e += THREADS) b0_s[e] = b0[e];
  for (int e = threadIdx.x; e < RMAX; e += THREADS)
    off_s[e] = e < R ? offset[e] : 0.0f;
}

// acc[i][c] += sum_{k < K} a_s[k * LDA + p0 + i] * b[k * kstride +
// 16 c * cstride] for this thread's 4 pairs (p0..p0+3) and NC columns.
template <int NC>
__device__ __forceinline__ void gemm_tile(const float* __restrict__ a_s,
                                          const float* __restrict__ b, int K,
                                          int kstride, int cstride, int p0,
                                          float (&acc)[4][NC]) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float4 a = *reinterpret_cast<const float4*>(a_s + k * LDA + p0);
    float av[4] = {a.x, a.y, a.z, a.w};
    float bv[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) bv[c] = b[k * kstride + 16 * c * cstride];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
  }
}

__device__ __forceinline__ void store4(float* dst, const float (&v)[4][FPT],
                                       int c) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(v[0][c], v[1][c], v[2][c], v[3][c]);
}

// Launch on a (row tiles of ROWS, molecules) grid with `floats` floats of
// dynamic shared memory.
template <typename K>
cudaError_t launch(K kernel, int floats, int S, int A, cudaStream_t stream,
                   void** args) {
  size_t smem = sizeof(float) * (size_t)floats;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((A + ROWS - 1) / ROWS, S);
  err = cudaLaunchKernel((const void*)kernel, grid, dim3(THREADS), args, smem,
                         stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

"""
CONV_KERNEL = """constexpr int CONV_FLOATS = W_FLOATS + RMAX * LDA + F * LDA + NP * F;

// Slot e of flat row `row`: its partner atom (local index), or -1 where
// the slot is masked.
__device__ __forceinline__ int partner_of(
    const int* __restrict__ idx, const unsigned char* __restrict__ mask,
    int row, int e, int K) {
  int slot = row * K + e;
  return mask[slot] ? idx[slot] : -1;
}

// Forward at fp32: out[i] = sum_k W_ik * cut_ik * x[idx[i, k]]. Grid: (row
// tiles of ROWS, molecules).
__global__ void __launch_bounds__(THREADS, 1)
conv_kernel(const float* __restrict__ pos, const float* __restrict__ x,
            const int* __restrict__ idx,
            const unsigned char* __restrict__ mask,
            const float* __restrict__ w0, const float* __restrict__ b0,
            const float* __restrict__ w1, const float* __restrict__ offset,
            const float* __restrict__ coeff_p, float* __restrict__ out, int A,
            int K, int R, float rcut, float arg_scale, float dcut_scale) {
  extern __shared__ __align__(16) float smem[];
  float* w0_s = smem;               // [RMAX][LDW]
  float* w1_s = w0_s + RMAX * LDW;  // [F][LDW]
  float* rbf_s = w1_s + F * LDW;    // [RMAX][LDA]
  float* a_s = rbf_s + RMAX * LDA;  // [F][LDA]
  float* in_s = a_s + F * LDA;      // [NP][F]: the partners' x
  __shared__ float b0_s[F], off_s[RMAX];
  __shared__ float pr_s[ROWS][3], d_s[NP], cut_s[NP];
  __shared__ int part_s[NP];

  const int s = blockIdx.y;
  const int r0 = blockIdx.x * ROWS;
  const int base = s * A;
  const int tid = threadIdx.x;
  const int fg = tid & 15, pg = tid >> 4, p0 = 4 * pg;
  const float coeff = *coeff_p;

  load_weights(w0, b0, w1, offset, R, w0_s, w1_s, b0_s, off_s);
  if (tid < ROWS * 3) {
    int r = tid / 3, c = tid % 3;
    pr_s[r][c] = r0 + r < A ? pos[(size_t)(base + r0 + r) * 3 + c] : 0.0f;
  }
  float acc[FPT];
#pragma unroll
  for (int c = 0; c < FPT; ++c) acc[c] = 0.0f;

  for (int e0 = 0; e0 < K; e0 += COLS) {
    __syncthreads();  // the previous chunk is done with every tile
    bool live = false;
    if (tid < NP) {
      int rr = tid / COLS, e = e0 + tid % COLS;
      int part = r0 + rr < A && e < K
                     ? partner_of(idx, mask, base + r0 + rr, e, K)
                     : -1;
      part_s[tid] = part;
      float pc[3] = {0.0f, 0.0f, 0.0f};
      if (part >= 0) {
        const float* q = pos + (size_t)(base + part) * 3;
        pc[0] = q[0];
        pc[1] = q[1];
        pc[2] = q[2];
      }
      float d, cut, dcut, rel[3];
      live = pair_geom(pr_s[rr], pc, part >= 0, rcut, arg_scale, dcut_scale,
                       d, cut, dcut, rel);
      d_s[tid] = d;
      cut_s[tid] = cut;
    }
    if (!__syncthreads_or(live)) continue;  // the chunk adds exactly zero

    for (int e = tid; e < NP * F; e += THREADS) {
      int part = part_s[e / F];
      in_s[e] = part >= 0 ? x[(size_t)(base + part) * F + e % F] : 0.0f;
    }
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
      const float* xin = in_s + p * F + fg;
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
    out[(size_t)(base + r0 + rr) * F + f] =
        ((q[0] + q[F]) + q[2 * F]) + q[3 * F];
  }
}

"""
NB_FWD32 = """  return (int)launch_persistent(nbr_fwd_ffma_kernel, FF_WARPS, FF_SMEM,
                                n_items, st, args);"""
NB_FWD32_PARENT = """  void* cargs[] = {&pos, &x, &idx, &mask, &w0, &b0, &w1, &offset, &coeff,
                   &out, &A, &K, &R, &rcut, &arg_scale, &dcut_scale};
  return (int)launch(conv_kernel, CONV_FLOATS, S, A, st, cargs);"""
TILE_PI = "const double PI = 3.14159265358979323846;\n"
# (source, kernels of its ptxas lines ("|" between names), function):
# {variant: {file: {old: new}}}; a file is the source or the shared header.
VARIANTS = {
    ("cheb_kernels.cu", "gxgd_mma_kernel", "cheb_bwd_gxgd"): {
        "base": {},
        "lb1": {"cheb_kernels.cu": {
            GXGD_LB: GXGD_LB.replace("TIER == TIER_X3 ? 1 : 3", "1")}},
        "lb3": {"cheb_kernels.cu": {
            GXGD_LB: GXGD_LB.replace("TIER == TIER_X3 ? 1 : 3", "3")}},
    },
    ("cfconv_dense_kernels.cu", "dense_bwd_mma_kernel", "dense_cfconv_bwd"): {
        "base": {},
        "rw2": {TILE: {RW: RW.replace("4;", "2;")}},
        "inline": {TILE: {GA_AHEAD: GA_LOOP}},
    },
    (DENSE, "dense_bwd_ffma_kernel", "dense_cfconv_bwd_fp32"): {
        "base": {},
        "gx_global": {
            TILE: {DF_WARP: "constexpr int DF_WARP_FLOATS = "
                            "2 * DF_TILE * F + 4 * DF_TILE + DM_RING;"},
            DENSE: {DF_GX_S: "  float* pd_s = buf_s + DF_TILE * F;  "
                             "// [DF_TILE][4]",
                    DF_GX_ZERO: "    // the item's gx rows, in place\n"
                                "    float* gx_s = GX ? gx + ((size_t)s * A"
                                " + r0) * F : nullptr;\n"
                                "    if (GX) {\n"
                                "      for (int e = lane; e < DM_RW * F && "
                                "r0 + e / F < A; e += 32)\n"
                                "        gx_s[e] = 0.0f;\n"
                                "      __syncwarp();\n    }",
                    DF_GX_OUT: ""}},
        "row_unroll2": {TILE: {DF_K.format(0, "K"):
                               DF_K.format(0, "K").replace("1", "2")}},
        "col_unroll2": {TILE: {DF_K.format("k0", "k1"):
                               DF_K.format("k0", "k1").replace("1\n", "2\n")}},
        "w6": {TILE: {DF_W: "constexpr int DF_WARPS = 6;"}},
        "w5": {TILE: {DF_W: "constexpr int DF_WARPS = 5;"}},
        "w3": {TILE: {DF_W: "constexpr int DF_WARPS = 3;"}},
        "gi_smem": GI_SMEM,
    },
    (DENSE, "dense_fwd_ffma_kernel", "dense_cfconv_fwd_fp32"): {
        "base": {},
        "w4": {TILE: {FF_W: FF_W.replace("8;", "4;")}},
        "w6": {TILE: {FF_W: FF_W.replace("8;", "6;")}},
        "w12": {TILE: {FF_W: FF_W.replace("8;", "12;")}},
    },
    (NBR, "_ffma_kernel", "cfconv_bwd_fp32"): {
        "base": {},
        "recompute": {NBR: {
            NB_PASS1: "    err = launch_persistent(nbr_bwd_ffma_kernel<false>,",
            NB_WBUF: "      false)",
            NB_SIZES: NB_GX_FFMA + NB_SIZES,
            NB_GX_PASS: """  void* gargs[] = {&pos, &csr_offsets, &csr_slots, &g, &w0, &b0, &w1,
                   &offset, &coeff, &gx, &S, &A, &K, &R, &rcut, &arg_scale,
                   &dcut_scale};
  return (int)launch_persistent(nbr_gx_ffma_kernel, FF_WARPS, FF_SMEM,
                                n_items, st, gargs);"""}},
    },
    (NBR, "11conv_kernelE|nbr_fwd_ffma_kernelE", "cfconv_fwd_fp32"): {
        "parent": {NBR: {NB_SIZES: CONV_CHUNK + CONV_KERNEL + NB_SIZES,
                         NB_FWD32: NB_FWD32_PARENT}},
        "base": {},
        "w4": {TILE: {FF_W: FF_W.replace("8;", "4;")}},
        "w6": {TILE: {FF_W: FF_W.replace("8;", "6;")}},
        "w12": {TILE: {FF_W: FF_W.replace("8;", "12;")}},
    },
    # the dense fp32 forward built on the header as it is and as the
    # parent had it (with the chunk layout)
    (DENSE, "dense_fwd_ffma_kernel", "cfconv_fwd_fp32"): {
        "dense_base": {},
        "dense_parent": {TILE: {TILE_PI: TILE_PI + "\n" + CONV_CHUNK}},
    },
    ("cfconv_dense_kernels.cu", "dense_fwd_mma_kernel", "dense_cfconv_fwd"): {
        "base": {},
        "w8": {TILE: {FW: FW.replace("16;", "8; ")}},
        "w12": {TILE: {FW: FW.replace("16;", "12;")}},
        "rw2": {TILE: {RW: RW.replace("4;", "2;")}},
    },
    ("cfconv_kernels.cu", "nbr_fwd_mma_kernel", "cfconv_fwd"): {
        "base": {},
        "w8": {TILE: {FW: FW.replace("16;", "8; ")}},
        "w12": {TILE: {FW: FW.replace("16;", "12;")}},
        "rw2": {TILE: {RW: RW.replace("4;", "2;")}},
    },
    ("cfconv_kernels.cu", "nbr_", "cfconv_bwd"): {
        "base": {},
        "w8": {TILE: {FW: FW.replace("16;", "8; ")}},
        "rw2": {TILE: {RW: RW.replace("4;", "2;")}},
    },
}


def build_all(tmp, only=()):
    """{(fn, variant): loaded library} of the functions ``only`` (all when
    empty); prints each variant's ptxas lines for its kernels."""
    procs = {}
    for (source, kernel, fn), variants in VARIANTS.items():
        if only and fn not in only:
            continue
        for name, edits in variants.items():
            out = tmp / f"{fn}_{name}"
            out.mkdir()
            # the edited header beside the source wins over -I's original
            for file in {source, *edits}:
                text = (_build.CSRC / file).read_text()
                for old, new in edits.get(file, {}).items():
                    if text.count(old) != 1:
                        raise SystemExit(f"FAILED: {fn} {name}: "
                                         "substitution not found")
                    text = text.replace(old, new)
                (out / file).write_text(text)
            procs[fn, name, kernel] = subprocess.Popen(
                [_build._nvcc(), *_build._FLAGS, "-I", str(_build.CSRC),
                 "-Xptxas", "-v", "-shared", "-o", str(out / "lib.so"),
                 str(out / source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (fn, name, kernel), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"FAILED: {fn} {name} does not build\n"
                             f"{log[-4000:]}")
        for line in cs.ptxas_summary(log):
            if any(k in line.split(":")[0] for k in kernel.split("|")):
                print(f"variant {fn} {name}: {line[-90:]}")
        lib = ctypes.CDLL(str(tmp / f"{fn}_{name}" / "lib.so"))
        for sym, argtypes in _build._SIGNATURES.items():
            if hasattr(lib, sym):
                getattr(lib, sym).argtypes = argtypes
                getattr(lib, sym).restype = ctypes.c_int
        libs[fn, name] = lib
    return libs


def report(label, call, out, ref, ref32=None):
    """Runs ``call``, holds ``out`` against ``ref`` and times ``call``;
    returns the ms."""
    call()
    torch.cuda.synchronize()
    rel = max(float((o - r).abs().max() / r.abs().max())
              for o, r in zip(out, ref))
    extra = ""
    if ref32 is not None:
        near = max(float(torch.linalg.norm(o - r) / torch.linalg.norm(o - f))
                   for o, r, f in zip(out, ref, ref32))
        extra = f", ||k-p|| / ||k-p_fp32|| {near:.3e}"
    ms = cs.cuda_time_ms(call, warmup=2, iters=20)
    print(f"variant {label}: max|k-p|/max|p| {rel:.3e}{extra}, {ms:.4f} ms")
    return ms


def gxgd_cases(libs, dev):
    for prec in ("bf16", "bf16x3"):
        ff, cfgs = cs._force_fields(dev, cs.BATCH, precision=prec)
        pos = collate(cfgs, device=dev).pos
        c, c2, w0 = ff.schnet_params["cheb_fit"][0]
        w_lin = _lin_slope(c2)
        rcut, d_min = float(ff.rcut), float(ff.schnet_config.cheb_d_min)
        s, a, f = pos.shape[0], pos.shape[1], c.shape[1]
        gen = torch.Generator(device=dev).manual_seed(11)
        x = torch.randn(s, a, f, generator=gen, device=dev)
        g = torch.randn(s, a, f, generator=gen, device=dev)
        q = ck._to_that_basis(c).contiguous()
        args = (c, c2, w0, pos, x, g, rcut)
        ref = ck.cheb_conv_bwd_gxgd_plain(*args, prec, d_min, w_lin)
        ref32 = (ck.cheb_conv_bwd_gxgd_plain(*args, "fp32", d_min, w_lin)
                 if prec == "bf16x3" else None)
        for (fn, name), lib in libs.items():
            if fn != "cheb_bwd_gxgd":
                continue
            n = ck.gd_slabs(a, f, prec)
            gx = torch.empty_like(g)
            gpos = torch.empty_like(pos)
            row = torch.empty(s, a, 3, device=dev)
            col = torch.empty(s, n, a, 3, device=dev)

            def call():
                rc = lib.cheb_bwd_gxgd(
                    _ptr(pos), _ptr(x), _ptr(g), _ptr(q), _ptr(c2),
                    _ptr(w0), _ptr(w_lin), None, None, _ptr(gx), _ptr(row),
                    _ptr(col), _ptr(gpos), s, a, f, q.shape[0],
                    c2.shape[0], n, rcut, d_min, TIER_CODES[prec],
                    _stream())
                if rc:
                    raise SystemExit(f"FAILED: {name}: CUDA {rc}")

            report(f"{fn} {name} {prec}", call, (gpos, gx), ref, ref32)


def _filter_case(dev, message_passing, seed):
    """(force field, start positions, x, g, filter weights, rcut) of the
    dense or the pallas slice."""
    ff, cfgs = cs._force_fields(dev, cs.BATCH,
                                message_passing=message_passing)
    pos = collate(cfgs, device=dev).pos
    layers = ff.schnet_params["interactions"][0]["filter"]["layers"]
    rbf = ff.schnet_params["rbf"]
    w = (layers[0]["w"], layers[0]["b"], layers[1]["w"], rbf["offset"],
         rbf["coeff"])
    gen = torch.Generator(device=dev).manual_seed(seed)
    s, a = pos.shape[0], pos.shape[1]
    f = w[0].shape[1]
    x = torch.randn(s, a, f, generator=gen, device=dev)
    g = torch.randn(s, a, f, generator=gen, device=dev)
    return ff, pos, x, g, w, float(ff.schnet_config.cutoff.cutoff_upper)


def dense_cases(libs, dev):
    _, pos, x, g, w, rcut = _filter_case(dev, "dense", 12)
    s, a = pos.shape[0], pos.shape[1]
    r, f = w[0].shape
    ref_bwd = cd.dense_cfconv_bwd_plain(pos, x, g, *w, rcut, "bf16")
    ref_fwd = (cd.dense_cfconv_fwd_plain(pos, x, *w, rcut, "bf16"),)
    ref_fwd32 = (cd.dense_cfconv_fwd_plain(pos, x, *w, rcut, "fp32"),)
    ref32 = {gx: cd.dense_cfconv_bwd_plain(pos, x, g, *w, rcut, "fp32",
                                           need_gx=gx)
             for gx in (True, False)}
    for (fn, name), lib in libs.items():
        gd = torch.empty(s, a, a, device=dev)
        gpos = torch.empty_like(pos)
        gx = torch.empty_like(g)
        out = torch.empty_like(x)
        if fn == "dense_cfconv_bwd":
            def call():
                rc = lib.dense_cfconv_bwd(
                    _ptr(pos), _ptr(x), _ptr(g), *(_ptr(t) for t in w),
                    _ptr(gd), _ptr(gpos), _ptr(gx), s, a, f, r, rcut, 1,
                    _stream())
                if rc:
                    raise SystemExit(f"FAILED: {name}: CUDA {rc}")

            report(f"{fn} {name} bf16", call, (gpos, gx), ref_bwd)
        elif fn == "dense_cfconv_bwd_fp32":
            for need_gx in (True, False):
                def call(gx_ptr=_ptr(gx) if need_gx else None):
                    rc = lib.dense_cfconv_bwd(
                        _ptr(pos), _ptr(x), _ptr(g), *(_ptr(t) for t in w),
                        _ptr(gd), _ptr(gpos), gx_ptr, s, a, f, r, rcut, 0,
                        _stream())
                    if rc:
                        raise SystemExit(f"FAILED: {name}: CUDA {rc}")

                ref = ref32[need_gx]
                report(f"{fn} {name} {'with' if need_gx else 'no'} gx", call,
                       (gpos, gx) if need_gx else (gpos,),
                       ref if need_gx else ref[:1])
        elif fn in ("dense_cfconv_fwd", "dense_cfconv_fwd_fp32"):
            bf16 = int(fn == "dense_cfconv_fwd")

            def call():
                rc = lib.dense_cfconv_fwd(
                    _ptr(pos), _ptr(x), *(_ptr(t) for t in w), _ptr(out), s,
                    a, f, r, rcut, bf16, _stream())
                if rc:
                    raise SystemExit(f"FAILED: {name}: CUDA {rc}")

            report(f"{fn} {name} {'bf16' if bf16 else 'fp32'}", call, (out,),
                   ref_fwd if bf16 else ref_fwd32)


def nbr_cases(libs, dev):
    from flashmd_tpu_torch.models.forcefield import build_neighbors

    ff, pos, x, g, w, rcut = _filter_case(dev, "pallas", 13)
    nbr = build_neighbors(ff, pos, skin=1.0)
    s, a, k = nbr.idx.shape
    r, f = w[0].shape
    ref = cf.cfconv_bwd_plain(pos, nbr.idx, nbr.mask, x, g, *w, rcut, "bf16")
    ref32 = cf.cfconv_bwd_plain(pos, nbr.idx, nbr.mask, x, g, *w, rcut,
                                "fp32")
    ref_fwd = (cf.cfconv_fwd_plain(pos, nbr.idx, nbr.mask, x, *w, rcut,
                                   "bf16"),)
    for (fn, name), lib in libs.items():
        gd = torch.empty(s, a, k, device=dev)
        gpos = torch.empty_like(pos)
        gx = torch.empty_like(g)
        out = torch.empty_like(x)
        if fn == "cfconv_bwd":
            def call():
                rc = lib.cfconv_bwd(
                    _ptr(pos), _ptr(nbr.idx), _ptr(nbr.mask),
                    _ptr(nbr.csr_offsets), _ptr(nbr.csr_slots), _ptr(x),
                    _ptr(g), *(_ptr(t) for t in w), _ptr(gd), None,
                    _ptr(gpos), _ptr(gx), s, a, k, f, r, rcut, 1, _stream())
                if rc:
                    raise SystemExit(f"FAILED: {name}: CUDA {rc}")

            report(f"{fn} {name} bf16", call, (gpos, gx), ref)
        elif fn == "cfconv_bwd_fp32":
            stored = name != "recompute"

            def call():
                # the workspace as the wrapper allocates it, per call
                wbuf = (torch.empty(s, a, k, f, device=dev) if stored
                        else None)
                rc = lib.cfconv_bwd(
                    _ptr(pos), _ptr(nbr.idx), _ptr(nbr.mask),
                    _ptr(nbr.csr_offsets), _ptr(nbr.csr_slots), _ptr(x),
                    _ptr(g), *(_ptr(t) for t in w), _ptr(gd), _ptr(wbuf),
                    _ptr(gpos), _ptr(gx), s, a, k, f, r, rcut, 0, _stream())
                if rc:
                    raise SystemExit(f"FAILED: {name}: CUDA {rc}")

            report(f"{fn} {name} with gx", call, (gpos, gx), ref32)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            call()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - before
            print(f"variant {fn} {name}: peak device memory above its "
                  f"inputs and outputs {peak} B ({peak / 1e6:.1f} MB)")
        elif fn == "cfconv_fwd":
            def call():
                rc = lib.cfconv_fwd(
                    _ptr(pos), _ptr(nbr.idx), _ptr(nbr.mask), _ptr(x),
                    *(_ptr(t) for t in w), _ptr(out), s, a, k, f, r, rcut,
                    1, _stream())
                if rc:
                    raise SystemExit(f"FAILED: {name}: CUDA {rc}")

            report(f"{fn} {name} bf16", call, (out,), ref_fwd)


def fwd_fp32_cases(libs, dev):
    """cfconv_fwd_fp32: each variant's neighbour-matrix forward on the
    pallas slice's list against the fp32 twin, timed in turns (the
    variants in order, then in reverse); then the dense fp32 forward built
    on the header as it is and as the parent had it, on the dense slice,
    in turns: its times, and whether the two builds agree bitwise."""
    from flashmd_tpu_torch.models.forcefield import build_neighbors

    names = [name for fn, name in libs
             if fn == "cfconv_fwd_fp32" and not name.startswith("dense_")]
    if not names:
        return
    ff, pos, x, _, w, rcut = _filter_case(dev, "pallas", 13)
    nbr = build_neighbors(ff, pos, skin=1.0)
    s, a, k = nbr.idx.shape
    r, f = w[0].shape
    ref = (cf.cfconv_fwd_plain(pos, nbr.idx, nbr.mask, x, *w, rcut, "fp32"),)
    times = {}
    for name in names + names[::-1]:
        lib, out = libs["cfconv_fwd_fp32", name], torch.empty_like(x)

        def call(lib=lib, out=out, name=name):
            rc = lib.cfconv_fwd(
                _ptr(pos), _ptr(nbr.idx), _ptr(nbr.mask), _ptr(x),
                *(_ptr(t) for t in w), _ptr(out), s, a, k, f, r, rcut, 0,
                _stream())
            if rc:
                raise SystemExit(f"FAILED: {name}: CUDA {rc}")

        times.setdefault(name, []).append(
            report(f"cfconv_fwd_fp32 {name}", call, (out,), ref))
    for name, ms in times.items():
        print(f"variant cfconv_fwd_fp32 {name}: {ms[0]:.4f}, {ms[1]:.4f} ms "
              f"(base {times['base'][0]:.4f}, {times['base'][1]:.4f})")

    _, pos, x, _, w, rcut = _filter_case(dev, "dense", 12)
    s, a = pos.shape[0], pos.shape[1]
    r, f = w[0].shape
    ref = (cd.dense_cfconv_fwd_plain(pos, x, *w, rcut, "fp32"),)
    outs = {}
    for name in ("dense_parent", "dense_base", "dense_base", "dense_parent"):
        lib = libs["cfconv_fwd_fp32", name]
        out = outs.setdefault(name, torch.empty_like(x))

        def call(lib=lib, out=out, name=name):
            rc = lib.dense_cfconv_fwd(
                _ptr(pos), _ptr(x), *(_ptr(t) for t in w), _ptr(out), s, a,
                f, r, rcut, 0, _stream())
            if rc:
                raise SystemExit(f"FAILED: {name}: CUDA {rc}")

        report(f"cfconv_fwd_fp32 {name} (dense_cfconv_fwd fp32)", call,
               (out,), ref)
    same = torch.equal(outs["dense_base"], outs["dense_parent"])
    print(f"variant cfconv_fwd_fp32: dense_fwd_ffma_kernel on the header as "
          f"it is and as the parent had it, bitwise the same: {same}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("FAILED: no CUDA device")
    dev = torch.device("cuda", 0)
    libs = build_all(Path(tempfile.mkdtemp()), sys.argv[1:])
    gxgd_cases(libs, dev)
    dense_cases(libs, dev)
    nbr_cases(libs, dev)
    fwd_fp32_cases(libs, dev)
    print(cs.nvidia_smi_line())


if __name__ == "__main__":
    main()
