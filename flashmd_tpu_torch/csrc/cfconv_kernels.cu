// Neighbour-matrix exact-filter CFConv kernels for Hopper (sm_90a), plain C
// interface for ctypes. Built by flashmd_tpu_torch/ops/_build.py; the tile
// code shared with the dense kernels is in cfconv_tile.cuh.
//
// Two entry points replace the TPU kernels of
// flashmd_tpu/ops/pallas/cfconv.py, batched over S molecules, on the padded
// neighbour matrix idx [S, A, K] (int32) / mask [S, A, K] (bool):
//
//   cfconv_fwd  <- _fwd_kernel (:137), one launch:
//     nbr_fwd_ffma_kernel (fp32), nbr_fwd_mma_kernel (bf16):
//                  out[i] = sum_{k: mask} W_ik * cut_ik * x[idx[i, k]]
//   cfconv_bwd  <- _bwd_kernel (:163), two or three launches:
//     nbr_bwd_ffma_kernel (fp32), nbr_bwd_mma_kernel (bf16):
//                  gd[i, k] = d(g_i . out_i)/d d_ik for every slot (one MLP
//                  backward on the cotangent g_i x_j cut, row-owned); at
//                  fp32, when gx is asked for, the first pass also stores
//                  W_ik of every live slot into a [S, A, K, F] workspace
//     gpos_kernel: gpos[a] = -sum_k gd[a, k] u_ak
//                            + sum_{(i, k): idx[i, k] = a} gd[i, k] u_ik
//     gx_kernel (fp32), nbr_gx_mma_kernel (bf16), only when gx is asked
//     for:         gx[a] = sum_{(i, k): idx[i, k] = a} W_ik * cut_ik * g[i]
//
// with u_ik = (p_j - p_i) / d_ik, j = idx[i, k], d = sqrt(max(|p_j -
// p_i|^2, 1e-12)), cut = 0.5 (cos(pi d / rc) + 1) [d < rc], rbf = exp(coeff
// (d - offset)^2) cut, W = tanh(rbf @ w0 + b0) @ w1 (_tile_geometry :77,
// _filter_mlp :111).
//
// What bounds them on the H100: every live slot runs the two-layer filter
// MLP, R*F + F*F = 22,784 multiply-adds at R = 50, F = 128 (twice that in
// the backward's first pass), against a few hundred bytes of input per slot:
// they are bound by arithmetic. Every kernel with a filter MLP runs over the
// live slots only (mask set and d < rc): the forward and the backward's
// first pass are the dense kernels' ring over each row's K slots (16-slot
// tiles on the tensor cores at bf16, register-tiled float32 FMAs on the
// CUDA cores at fp32, w0 and w1 staged once per block of a persistent
// grid), the bf16 backward's gx pass the forward's two products over each
// atom's incoming live slots of the source CSR, with W computed again
// instead of stored (the kernels' notes below). The fp32 gx_kernel does no
// MLP: it reads W back (512 B per live slot) and is bound by memory; it
// skips each dead incoming slot after its geometry and reads W and g rows
// of the live ones as whole 512 B lines. The [slots, F] MLP activations of
// the other kernels never reach device memory.
// The list is sorted nearest first when it is built, but between Verlet
// rebuilds atoms move, and it keeps slots out to rc + skin: a row's live
// slots need not come first, so every kernel looks at all K slots.
//
// Determinism, and the column side: the TPU kernel adds the column side
// (gx[j], gpos[j]) across grid steps (gx_ref[0] +=, gpos_ref[0] +=), which
// needs its in-order grid. Here every output row has one owner and no
// atomics: the backward's first pass writes gd per slot into a [S, A, K]
// workspace, and the column side walks a source CSR of the live slots
// (csr_offsets [S*A + 1], csr_slots: flat slot ids (s A + i) K + k grouped
// by source s A + idx, in slot order, built once per neighbour rebuild by a
// stable sort, see ops/neighborlist.py). That is the exact transpose of the
// list, also when capacity overflow makes the list asymmetric. At fp32 gx
// reads W of each incoming live slot from the workspace that the first
// pass wrote (1.5 GB at S = 128, A = 266, K = 88); at bf16 the gx pass
// computes it again on the tensor cores, and the backward allocates no
// workspace beyond gd. Each sum runs in a fixed order; results are bitwise
// reproducible.
//
// Precision tiers: bf16 != 0 rounds the operands of the four products to
// bf16 where the reference and the plain PyTorch twins in ops/cfconv.py do:
// rbf and w0, a0 and w1 (forward); g_i x_j cut and w1, gt0 and w0
// (backward). tanh, the geometry, the gx message and all sums stay float32.

#include "cfconv_tile.cuh"

namespace {

constexpr int GPOS_ROWS = THREADS / 32;  // one warp per row of gpos

// Forward at fp32, on the CUDA cores: out of a work item's rows.
//
// Replaces _fwd_kernel (flashmd_tpu/ops/pallas/cfconv.py:137) at fp32 (and
// bf16x3, which ops/cfconv.py routes here), as nbr_fwd_mma_kernel does at
// bf16. Bound: operations, per live slot 2 (R F + F F) FLOP of the two
// products (+ 3 F elementwise) at the 67 TFLOP/s float32 peak: 0.5976 ms
// at the pallas slice's start (871,318 live slots, R = 50, F = 128).
//
// Design: nbr_fwd_mma_kernel's items and vote with dense_fwd_ffma_kernel's
// tile (fwd_items<false> over [0, K) with src = x). A persistent grid
// stages w0 and w1 as float32 once per block (101 KB); each of its FF_WARPS
// warps owns work items of DM_RW rows and votes each row's slots 32 at a
// time, all K of them (between Verlet rebuilds a live slot may follow a
// dead one), a slot live where its mask is set and d < rc (a masked slot
// holds the row's own index, at d = 1e-6, so the mask decides; idx is read
// for the masked-in slots only). The live ones enter the ring as (row - r0)
// << 16 | idx[row][k], the partner atom. Every DF_TILE = 16 entries are one
// tile (fwd_ffma_tile): a0 and W as register-tiled float32 FMAs (8 slots x
// 8 columns a lane), tanhf and expf at the twin's places, then out_i +=
// (W cut) x_j in ring order, which is slot order within a row, into the
// item's out rows, which its warp owns; rows with no live slot are stored
// as zeros. No atomics; results are bitwise reproducible.
__global__ void __launch_bounds__(FF_WARPS * 32, 1)
nbr_fwd_ffma_kernel(const float* __restrict__ pos,
                    const float* __restrict__ x, const int* __restrict__ idx,
                    const unsigned char* __restrict__ mask,
                    const float* __restrict__ w0,
                    const float* __restrict__ b0,
                    const float* __restrict__ w1,
                    const float* __restrict__ offset,
                    const float* __restrict__ coeff_p,
                    float* __restrict__ out, int S, int A, int K, int R,
                    float rcut, float arg_scale, float dcut_scale) {
  extern __shared__ float4 ffma_smem4[];
  fwd_items<false>(
      ffma_smem4, pos, x, w0, b0, w1, offset, coeff_p, out, S, A, R, rcut,
      arg_scale, dcut_scale, [=](int, int) { return make_int2(0, K); },
      [=](int s, const float* ps, int i, int k, int& j) {
        const size_t slot = ((size_t)s * A + i) * K + k;
        if (!mask[slot]) return false;
        j = idx[slot];
        float d, cut, dcut, rel[3];
        return pair_geom(ps + i * 3, ps + j * 3, true, rcut, arg_scale,
                         dcut_scale, d, cut, dcut, rel);
      });
}

// Backward, first pass at fp32, on the CUDA cores: gd of every slot of a
// work item's rows (zero where masked or dead) and, with GX, W of every
// live slot into wbuf [S, A, K, F] for the gx pass.
//
// Replaces _bwd_kernel (flashmd_tpu/ops/pallas/cfconv.py:163) at fp32,
// with gpos_kernel and gx_kernel, as nbr_bwd_mma_kernel does at bf16.
// Bound: operations, per live slot 4 (R F + F F) FLOP of the four products
// (+ 12 F + 6 R elementwise) at the 67 TFLOP/s float32 peak, 1.2091 ms at
// the pallas slice's start (871,318 live slots, R = 50, F = 128); W of the
// live slots is 446 MB, 0.13 ms at 3.35 TB/s.
//
// Design: dense_bwd_ffma_kernel over the rows' K slots instead of their A
// partners, as nbr_bwd_mma_kernel is dense_bwd_mma_kernel's. A persistent
// grid stages w0 and w1 as float32 once per block (101 KB); each of its
// DF_WARPS = 4 warps owns work items of DM_RW rows and votes each row's
// slots 32 at a time, all K of them (between Verlet rebuilds a live slot
// may follow a dead one), a slot live where its mask is set and d < rc (a
// masked slot holds the row's own index, at d = 1e-6, so the mask decides;
// idx is read for the masked-in slots only), writing gd = 0 for the
// others; the live slots' entries (row - r0) << 16 | k run in 16-slot
// tiles through bwd_ffma_tile's four float32 products (NBR: the partner is
// idx[row][k]), gd landing at the flat slot (s A + i) K + k. With GX the
// tile also stores W of each live slot (not W cut) at that slot of wbuf:
// gx_kernel reads W back for exactly the slots whose pair_geom (p_a - p_i,
// bitwise the first pass's d and cut) says live, which is this vote's live
// set, so it never reads a slot that was not written. Storing W is cheaper
// than computing it again over the source CSR (nbr_gx_mma_kernel's route
// at bf16): the forward's two products again, 0.59 ms at the float32 peak,
// against 2 x 446 MB of W written and read back (tools/bwd_variants.py
// cfconv_bwd_fp32, pallas slice, H100 80GB HBM3, 700 W: stored 5.223 ms
// with gx and 1,535 MB of workspace, recomputed 6.459 ms and none). No
// atomics; every sum in a fixed order.
template <bool GX>
__global__ void __launch_bounds__(DF_WARPS * 32, 1)
nbr_bwd_ffma_kernel(const float* __restrict__ pos,
                    const int* __restrict__ idx,
                    const unsigned char* __restrict__ mask,
                    const float* __restrict__ x, const float* __restrict__ g,
                    const float* __restrict__ w0,
                    const float* __restrict__ b0,
                    const float* __restrict__ w1,
                    const float* __restrict__ offset,
                    const float* __restrict__ coeff_p,
                    float* __restrict__ gd, float* __restrict__ wbuf, int S,
                    int A, int K, int R, float rcut, float arg_scale,
                    float dcut_scale) {
  extern __shared__ float4 ffma_smem4[];
  const float *w0_s, *w1_s, *b0_s, *off_s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* act_s = stage_ffma_smem(ffma_smem4, w0, b0, w1, offset, R, w0_s,
                                 w1_s, b0_s, off_s) +
                 warp * DF_WARP_FLOATS;                    // [DF_TILE][F]
  float* buf_s = act_s + DF_TILE * F;                      // [DF_TILE][F]
  // the dense backward's per-warp area; its gx rows stay unused here
  float* pd_s = buf_s + DF_TILE * F;                       // [DF_TILE][4]
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
    const int* is = idx + (size_t)s * A * K;
    const unsigned char* ms = mask + (size_t)s * A * K;
    float* gds = gd + (size_t)s * A * K;
    float* wbs = GX ? wbuf + (size_t)s * A * K * F : nullptr;

    int head = 0, tail = 0;
    for (int rr = 0; rr < DM_RW && r0 + rr < A; ++rr) {
      const int i = r0 + rr;
      const float* pi = ps + i * 3;
      for (int kb = 0; kb < K; kb += 32) {
        int k = kb + lane;
        bool live = false;
        if (k < K) {
          int slot = i * K + k;
          if (ms[slot]) {
            float d, cut, dcut, rel[3];
            live = pair_geom(pi, ps + is[slot] * 3, true, rcut, arg_scale,
                             dcut_scale, d, cut, dcut, rel);
          }
          if (!live) gds[slot] = 0.0f;
        }
        tail = ring_push(ring, tail, live, (rr << 16) | k, lane);
        for (; tail - head >= DF_TILE; head += DF_TILE)
          bwd_ffma_tile<GX, true>(ring, head, DF_TILE, r0, ps, is, K, xs, gs,
                                  act_s, buf_s, pd_s, nullptr, gds, wbs,
                                  w0_s, w1_s, b0_s, off_s, R, coeff, rcut,
                                  arg_scale, dcut_scale, lane);
      }
    }
    if (tail > head)
      bwd_ffma_tile<GX, true>(ring, head, tail - head, r0, ps, is, K, xs, gs,
                              act_s, buf_s, pd_s, nullptr, gds, wbs, w0_s,
                              w1_s, b0_s, off_s, R, coeff, rcut, arg_scale,
                              dcut_scale, lane);
  }
}

// Backward, second pass: gpos[a] = -sum_k gd[a, k] u_ak (row side) + the
// sum of gd u over a's incoming slots in CSR order (column side). Grid: (row
// tiles of GPOS_ROWS, molecules); warp w owns atom a = GPOS_ROWS tile + w,
// its lanes stride over the entries and the shuffle tree sums them in a
// fixed order.
__global__ void __launch_bounds__(THREADS)
gpos_kernel(const float* __restrict__ pos, const int* __restrict__ idx,
            const unsigned char* __restrict__ mask,
            const int* __restrict__ offsets, const int* __restrict__ slots,
            const float* __restrict__ gd, float* __restrict__ gpos, int A,
            int K) {
  const int s = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int a = blockIdx.x * GPOS_ROWS + (threadIdx.x >> 5);
  if (a >= A) return;  // whole warps: the shuffles below stay full
  const int row = s * A + a;
  const float pa0 = pos[row * 3], pa1 = pos[row * 3 + 1],
              pa2 = pos[row * 3 + 2];
  float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
  for (int k = lane; k < K; k += 32) {
    int slot = row * K + k;
    if (!mask[slot]) continue;
    const float* q = pos + (size_t)(s * A + idx[slot]) * 3;
    float r0 = q[0] - pa0, r1 = q[1] - pa1, r2 = q[2] - pa2;
    float d = sqrtf(fmaxf(r0 * r0 + r1 * r1 + r2 * r2, 1e-12f));
    float v = gd[slot];
    g0 -= v * (r0 / d);
    g1 -= v * (r1 / d);
    g2 -= v * (r2 / d);
  }
  const int end = offsets[row + 1];
  for (int e = offsets[row] + lane; e < end; e += 32) {
    int slot = slots[e];
    const float* q = pos + (size_t)(slot / K) * 3;
    float r0 = pa0 - q[0], r1 = pa1 - q[1], r2 = pa2 - q[2];
    float d = sqrtf(fmaxf(r0 * r0 + r1 * r1 + r2 * r2, 1e-12f));
    float v = gd[slot];
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
    float* out = gpos + (size_t)row * 3;
    out[0] = g0;
    out[1] = g1;
    out[2] = g2;
  }
}

// Backward, gx pass: gx[a] = sum over a's incoming slots, in CSR order,
// of W * cut * g[i], with W read from wbuf. One block of F threads per
// atom a (grid: atoms, molecules); thread f owns feature f. rel is p_a -
// p_i, as in the first pass, so cut carries the same bits and the live
// slots are exactly those whose W the first pass stored.
__global__ void __launch_bounds__(F)
gx_kernel(const float* __restrict__ pos, const float* __restrict__ g,
          const int* __restrict__ offsets, const int* __restrict__ slots,
          const float* __restrict__ wbuf, float* __restrict__ gx, int A,
          int K, float rcut, float arg_scale, float dcut_scale) {
  const int row = blockIdx.y * A + blockIdx.x;
  const int f = threadIdx.x;
  const float* pa = pos + (size_t)row * 3;
  float acc = 0.0f;
  const int end = offsets[row + 1];
  for (int e = offsets[row]; e < end; ++e) {
    int slot = slots[e];
    int i = slot / K;  // flat row of the slot's owner
    float d, cut, dcut, rel[3];
    if (!pair_geom(pos + (size_t)i * 3, pa, true, rcut, arg_scale,
                   dcut_scale, d, cut, dcut, rel))
      continue;
    acc += (wbuf[(size_t)slot * F + f] * cut) * g[(size_t)i * F + f];
  }
  gx[(size_t)row * F + f] = acc;
}

// Backward, first pass at bf16, on the tensor cores: gd of every slot of a
// work item's rows (zero where masked or dead). The dense backward's ring
// (cfconv_tile.cuh) over the rows' K slots instead of their A partners: a
// warp votes each row's slots 32 at a time, all K of them (between Verlet
// rebuilds a live slot may follow a dead one), a slot live where its mask
// is set and d < rc (a masked slot holds the row's own index, at d = 1e-6,
// so the mask decides), writing gd = 0 for the others; the live slots'
// entries (row - r0) << 16 | k run in 16-slot tiles through bwd_mma_tile's
// four products (NBR: the partner is idx[row][k]), gd landing at the flat
// slot (s A + i) K + k. The gx half is the CSR pass below.
// per warp, in floats: g rows [DM_RW][F], the ring, the float32 a0
// [16 n-tiles][32 lanes][4]
constexpr int NB_WARP_FLOATS = DM_RW * F + DM_RING + 16 * F;
constexpr int NB_SMEM = WB_BYTES + 4 * DM_WARPS * NB_WARP_FLOATS;  // bytes

__global__ void __launch_bounds__(DM_WARPS * 32, 1)
nbr_bwd_mma_kernel(const float* __restrict__ pos, const int* __restrict__ idx,
                   const unsigned char* __restrict__ mask,
                   const float* __restrict__ x, const float* __restrict__ g,
                   const float* __restrict__ w0, const float* __restrict__ b0,
                   const float* __restrict__ w1,
                   const float* __restrict__ offset,
                   const float* __restrict__ coeff_p, float* __restrict__ gd,
                   int S, int A, int K, int R, float rcut, float arg_scale,
                   float dcut_scale) {
  extern __shared__ float4 mma_smem4[];
  const __nv_bfloat16 *w0_b, *w1_b;
  const float *b0_s, *off_s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* gi_s = stage_mma_smem(mma_smem4, w0, b0, w1, offset, R, w0_b, w1_b,
                               b0_s, off_s) +
                warp * NB_WARP_FLOATS;                  // [DM_RW][F]
  int* ring = reinterpret_cast<int*>(gi_s + DM_RW * F);  // [DM_RING]
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
    const int* is = idx + (size_t)s * A * K;
    const unsigned char* ms = mask + (size_t)s * A * K;
    float* gds = gd + (size_t)s * A * K;
    for (int e = lane; e < DM_RW * F; e += 32) {
      int i = r0 + e / F;
      gi_s[e] = i < A ? gs[(size_t)i * F + e % F] : 0.0f;
    }
    __syncwarp();

    int head = 0, tail = 0;
    for (int rr = 0; rr < DM_RW && r0 + rr < A; ++rr) {
      const int i = r0 + rr;
      const float* pi = ps + i * 3;
      for (int kb = 0; kb < K; kb += 32) {
        int k = kb + lane;
        bool live = false;
        if (k < K) {
          int slot = i * K + k;
          if (ms[slot]) {
            float d, cut, dcut, rel[3];
            live = pair_geom(pi, ps + is[slot] * 3, true, rcut, arg_scale,
                             dcut_scale, d, cut, dcut, rel);
          }
          if (!live) gds[slot] = 0.0f;
        }
        tail = ring_push(ring, tail, live, (rr << 16) | k, lane);
        for (; tail - head >= 16; head += 16)
          bwd_mma_tile<false, true>(ring, head, 16, r0, ps, is, K, xs, gs,
                                    gi_s, nullptr, nullptr, a0_s, gds, w0_b,
                                    w1_b, b0_s, off_s, R, coeff, rcut,
                                    arg_scale, dcut_scale, lane);
      }
    }
    if (tail > head)
      bwd_mma_tile<false, true>(ring, head, tail - head, r0, ps, is, K, xs,
                                gs, gi_s, nullptr, nullptr, a0_s, gds, w0_b,
                                w1_b, b0_s, off_s, R, coeff, rcut, arg_scale,
                                dcut_scale, lane);
    __syncwarp();  // gi_s is read before the next item writes
  }
}

// Backward, gx pass at bf16, on the tensor cores: gx[a] = sum over a's
// incoming slots (i, k), in CSR order, of W_ik cut_ik g[i], with W computed
// again on the tensor cores instead of stored (the fp32 path's [S, A, K, F]
// workspace is 1.5 GB at S = 128, A = 266, K = 88). A warp owns work items
// of DM_RW atoms; it walks each atom's CSR entries 32 at a time, votes the
// live ones (d < rc; the CSR holds only mask slots) into the ring as
// (atom - r0) << 16 | i, and runs them in 16-slot tiles through
// fwd_items<true> with g in place of x: the forward's two products, and gx_a
// += (W cut) g_i as a running sum in CSR order. d is that of p_i - p_a,
// bitwise the first pass's (p_a - p_i negated), so cut carries the same
// bits and the live slots are the same.
__global__ void __launch_bounds__(FW_WARPS * 32, 1)
nbr_gx_mma_kernel(const float* __restrict__ pos,
                  const int* __restrict__ offsets,
                  const int* __restrict__ slots, const float* __restrict__ g,
                  const float* __restrict__ w0, const float* __restrict__ b0,
                  const float* __restrict__ w1,
                  const float* __restrict__ offset,
                  const float* __restrict__ coeff_p, float* __restrict__ gx,
                  int S, int A, int K, int R, float rcut, float arg_scale,
                  float dcut_scale) {
  extern __shared__ float4 mma_smem4[];
  fwd_items<true>(
      mma_smem4, pos, g, w0, b0, w1, offset, coeff_p, gx, S, A, R, rcut,
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

// Forward at bf16, on the tensor cores: out of a work item's rows. A warp
// votes each row's slots 32 at a time, all K of them (between Verlet
// rebuilds a live slot may follow a dead one), a slot live where its mask
// is set and d < rc (a masked slot holds the row's own index, at d = 1e-6,
// so the mask decides; idx is read for the masked-in slots only), and
// pushes the live ones as (row - r0) << 16 | idx[row][k]: the partner atom,
// not the slot, as the forward stores nothing per slot. So the dense
// forward's items and tile run unchanged (fwd_items<true> over [0, K) with
// src = x): 16-slot tiles of the two products, out_i += (W cut) x_j in ring
// order into the item's out rows, which its warp owns; rows with no live
// slot stay zero.
__global__ void __launch_bounds__(FW_WARPS * 32, 1)
nbr_fwd_mma_kernel(const float* __restrict__ pos, const float* __restrict__ x,
                   const int* __restrict__ idx,
                   const unsigned char* __restrict__ mask,
                   const float* __restrict__ w0, const float* __restrict__ b0,
                   const float* __restrict__ w1,
                   const float* __restrict__ offset,
                   const float* __restrict__ coeff_p, float* __restrict__ out,
                   int S, int A, int K, int R, float rcut, float arg_scale,
                   float dcut_scale) {
  extern __shared__ float4 mma_smem4[];
  fwd_items<true>(
      mma_smem4, pos, x, w0, b0, w1, offset, coeff_p, out, S, A, R, rcut,
      arg_scale, dcut_scale, [=](int, int) { return make_int2(0, K); },
      [=](int s, const float* ps, int i, int k, int& j) {
        const size_t slot = ((size_t)s * A + i) * K + k;
        if (!mask[slot]) return false;
        j = idx[slot];
        float d, cut, dcut, rel[3];
        return pair_geom(ps + i * 3, ps + j * 3, true, rcut, arg_scale,
                         dcut_scale, d, cut, dcut, rel);
      });
}

bool sizes_ok(int S, int A, int K, int Fdim, int R) {
  return Fdim == F && R >= 1 && R <= RMAX && S >= 1 && A >= 1 && K >= 1 &&
         A <= RING_MAX && K <= RING_MAX && (long long)S * A * K < (1LL << 31);
}

}  // namespace

extern "C" {

// Sizes the kernels take: F == 128, 1 <= R <= 64, S >= 1, 1 <= A, K <=
// RING_MAX and S * A * K < 2^31. idx int32, mask one byte per slot (bool).
int cfconv_fwd(const float* pos, const int* idx, const unsigned char* mask,
               const float* x, const float* w0, const float* b0,
               const float* w1, const float* offset, const float* coeff,
               float* out, int S, int A, int K, int Fdim, int R, float rcut,
               int bf16, void* stream) {
  if (!sizes_ok(S, A, K, Fdim, R)) return (int)cudaErrorInvalidValue;
  float arg_scale = (float)(PI / (double)rcut);
  float dcut_scale = (float)(-0.5 * (PI / (double)rcut));
  void* args[] = {&pos, &x, &idx, &mask, &w0, &b0, &w1, &offset, &coeff,
                  &out, &S, &A, &K, &R, &rcut, &arg_scale, &dcut_scale};
  const int n_items = S * ((A + DM_RW - 1) / DM_RW);
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return (int)launch_persistent(nbr_fwd_mma_kernel, FW_WARPS, FW_SMEM,
                                  n_items, st, args);
  return (int)launch_persistent(nbr_fwd_ffma_kernel, FF_WARPS, FF_SMEM,
                                n_items, st, args);
}

// gx may be null: then it is not computed (the block's input is
// position-independent and its cotangent dead). gd is a workspace of
// S * A * K floats; the first pass writes every slot of it before the gpos
// pass reads it. wbuf, used at fp32 only and null exactly when gx is, is a
// workspace of S * A * K * F floats for W of every live slot; at bf16 the
// gx pass computes W again and wbuf is not read. csr_offsets [S * A + 1]
// and csr_slots [S * A * K] (the first csr_offsets[S * A] entries used)
// are the source CSR of the list.
int cfconv_bwd(const float* pos, const int* idx, const unsigned char* mask,
               const int* csr_offsets, const int* csr_slots, const float* x,
               const float* g, const float* w0, const float* b0,
               const float* w1, const float* offset, const float* coeff,
               float* gd, float* wbuf, float* gpos, float* gx, int S, int A,
               int K, int Fdim, int R, float rcut, int bf16, void* stream) {
  if (!sizes_ok(S, A, K, Fdim, R) ||
      (!bf16 && (gx == nullptr) != (wbuf == nullptr)))
    return (int)cudaErrorInvalidValue;
  float arg_scale = (float)(PI / (double)rcut);
  float dcut_scale = (float)(-0.5 * (PI / (double)rcut));
  cudaStream_t st = (cudaStream_t)stream;
  const int n_items = S * ((A + DM_RW - 1) / DM_RW);
  cudaError_t err;
  if (bf16) {
    void* args[] = {&pos, &idx, &mask, &x, &g, &w0,   &b0,        &w1,
                    &offset, &coeff, &gd, &S, &A, &K, &R, &rcut,
                    &arg_scale, &dcut_scale};
    err = launch_persistent(nbr_bwd_mma_kernel, DM_WARPS, NB_SMEM, n_items,
                            st, args);
  } else {
    void* args[] = {&pos, &idx, &mask, &x, &g, &w0, &b0, &w1, &offset,
                    &coeff, &gd, &wbuf, &S, &A, &K, &R, &rcut, &arg_scale,
                    &dcut_scale};
    err = launch_persistent(gx ? nbr_bwd_ffma_kernel<true>
                               : nbr_bwd_ffma_kernel<false>,
                            DF_WARPS, DF_SMEM, n_items, st, args);
  }
  if (err != cudaSuccess) return (int)err;
  dim3 grid((A + GPOS_ROWS - 1) / GPOS_ROWS, S);
  gpos_kernel<<<grid, THREADS, 0, st>>>(pos, idx, mask, csr_offsets,
                                        csr_slots, gd, gpos, A, K);
  err = cudaGetLastError();
  if (err != cudaSuccess || gx == nullptr) return (int)err;
  if (bf16) {
    void* args[] = {&pos, &csr_offsets, &csr_slots, &g, &w0, &b0, &w1,
                    &offset, &coeff, &gx, &S, &A, &K, &R, &rcut, &arg_scale,
                    &dcut_scale};
    return (int)launch_persistent(nbr_gx_mma_kernel, FW_WARPS, FW_SMEM,
                                  n_items, st, args);
  }
  gx_kernel<<<dim3(A, S), F, 0, st>>>(pos, g, csr_offsets, csr_slots, wbuf,
                                      gx, A, K, rcut, arg_scale, dcut_scale);
  return (int)cudaGetLastError();
}

// The gpos pass alone, on a gd [S, A, K] that a backward's first pass
// wrote: the general-width kernels' (cfconv_general_kernels.cu) second
// launch.
int cfconv_gpos(const float* pos, const int* idx, const unsigned char* mask,
                const int* csr_offsets, const int* csr_slots, const float* gd,
                float* gpos, int S, int A, int K, void* stream) {
  if (S < 1 || A < 1 || K < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((A + GPOS_ROWS - 1) / GPOS_ROWS, S);
  gpos_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      pos, idx, mask, csr_offsets, csr_slots, gd, gpos, A, K);
  return (int)cudaGetLastError();
}

// Dynamic shared memory per block, in bytes: of the forward at fp32 (kind
// 0, CUDA cores), of the backward's first pass at fp32 (1, CUDA cores) or
// at bf16 (2, tensor cores), of the forward and of the backward's gx pass
// at bf16 (3, tensor cores: both run fwd_mma_tile, with the same per-warp
// areas).
int cfconv_smem_bytes(int kind) {
  switch (kind) {
    case 0: return FF_SMEM;
    case 1: return DF_SMEM;
    case 2: return NB_SMEM;
    case 3: return FW_SMEM;
    default: return -1;
  }
}

}  // extern "C"
