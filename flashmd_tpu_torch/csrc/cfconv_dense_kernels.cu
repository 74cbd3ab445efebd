// Dense all-pairs exact-filter CFConv kernels for Hopper (sm_90a), plain C
// interface for ctypes. Built by flashmd_tpu_torch/ops/_build.py. The tile
// code shared with the neighbour-matrix kernels is in cfconv_tile.cuh.
//
// Two entry points replace the TPU kernels of
// flashmd_tpu/ops/pallas/cfconv_dense.py, batched over S molecules:
//
//   dense_cfconv_fwd  <- _fwd_kernel (:126), one launch:
//     dense_fwd_ffma_kernel (fp32), dense_fwd_mma_kernel (bf16):
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
// ones that add something, and all four kernels with a filter MLP run
// those only: a warp compacts its rows' live pairs into a ring and runs
// them in 16-pair tiles (cfconv_tile.cuh; the kernels' notes below). At
// bf16 a tile's products are mma.m16n8k16 on the tensor cores; at fp32
// register-tiled float32 FMAs on the CUDA cores (8 pairs x 8 columns a
// lane), with w0 and w1 staged as float32 once per block (101 KB), so the
// [pairs, F] activations never reach device memory.
//
// Determinism: every warp owns its work item's output rows. W and
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

constexpr int GPOS_ROWS = THREADS / 32;  // one warp per row of gpos

// Forward at fp32, on the CUDA cores: out of a work item's rows.
//
// Replaces _fwd_kernel (flashmd_tpu/ops/pallas/cfconv_dense.py:126) at
// fp32, as dense_fwd_mma_kernel does at bf16. Bound: operations, per live
// pair 2 (R F + F F) FLOP of the two products (+ 3 F elementwise) at the
// 67 TFLOP/s float32 peak: 0.5976 ms at the dense slice's start (871,318
// live pairs, R = 50, F = 128).
//
// Design: the backward's ring and tile with two of its four products
// (fwd_items<false> over each row's A partners): a persistent grid stages
// w0 and w1 as float32 once per block (101 KB); each of its FF_WARPS warps
// owns work items of DM_RW rows, scans their partners 32 at a time and
// pushes the live ones (d < rc, i != j, in range), in row-major order,
// into its ring. Every DF_TILE = 16 entries are one tile (fwd_ffma_tile):
// a0 and W as register-tiled float32 FMAs (8 pairs x 8 columns a lane),
// tanhf and expf at the twin's places, then out_i += (W cut) x_j in ring
// order into the item's out rows, which its warp owns. Without the float32
// a0 and the two transposed products of the backward, one activation tile
// a warp serves rbf, a0 and W cut in turn, so more warps share an SM.
__global__ void __launch_bounds__(FF_WARPS * 32, 1)
dense_fwd_ffma_kernel(const float* __restrict__ pos,
                      const float* __restrict__ x,
                      const float* __restrict__ w0,
                      const float* __restrict__ b0,
                      const float* __restrict__ w1,
                      const float* __restrict__ offset,
                      const float* __restrict__ coeff_p,
                      float* __restrict__ out, int S, int A, int R,
                      float rcut, float arg_scale, float dcut_scale) {
  extern __shared__ float4 ffma_smem4[];
  fwd_items<false>(
      ffma_smem4, pos, x, w0, b0, w1, offset, coeff_p, out, S, A, R, rcut,
      arg_scale, dcut_scale, [=](int, int) { return make_int2(0, A); },
      [=](int, const float* ps, int i, int e, int& j) {
        j = e;
        float d, cut, dcut, rel[3];
        return pair_geom(ps + i * 3, ps + j * 3, j != i, rcut, arg_scale,
                         dcut_scale, d, cut, dcut, rel);
      });
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
  const float *w0_s, *w1_s, *b0_s, *off_s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* act_s = stage_ffma_smem(ffma_smem4, w0, b0, w1, offset, R, w0_s,
                                 w1_s, b0_s, off_s) +
                 warp * DF_WARP_FLOATS;                 // [DF_TILE][F]
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
          bwd_ffma_tile<GX, false>(ring, head, DF_TILE, r0, ps, nullptr, A,
                                   xs, gs, act_s, buf_s, pd_s, gx_s, gds,
                                   nullptr, w0_s, w1_s, b0_s, off_s, R,
                                   coeff, rcut, arg_scale, dcut_scale, lane);
      }
    }
    if (tail > head)
      bwd_ffma_tile<GX, false>(ring, head, tail - head, r0, ps, nullptr, A,
                               xs, gs, act_s, buf_s, pd_s, gx_s, gds, nullptr,
                               w0_s, w1_s, b0_s, off_s, R, coeff, rcut,
                               arg_scale, dcut_scale, lane);
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
// ring of the backward with two of its four products (fwd_items<true> over
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
  fwd_items<true>(
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
  void* args[] = {&pos, &x, &w0, &b0,   &w1,        &offset,    &coeff,
                  &out, &S, &A,  &R,    &rcut,      &arg_scale, &dcut_scale};
  const int n_items = S * ((A + DM_RW - 1) / DM_RW);
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return (int)launch_persistent(dense_fwd_mma_kernel, FW_WARPS, FW_SMEM,
                                  n_items, st, args);
  return (int)launch_persistent(dense_fwd_ffma_kernel, FF_WARPS, FF_SMEM,
                                n_items, st, args);
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

// The gpos pass alone, on a gd [S, A, A] that a backward's first pass
// wrote: the general-width kernels' (cfconv_general_kernels.cu) second
// launch.
int dense_cfconv_gpos(const float* pos, const float* gd, float* gpos, int S,
                      int A, void* stream) {
  if (S < 1 || A < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((A + GPOS_ROWS - 1) / GPOS_ROWS, S);
  dense_gpos_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(pos, gd,
                                                                gpos, A);
  return (int)cudaGetLastError();
}

// Dynamic shared memory per block, in bytes: of the forward at fp32 (kind
// 0, CUDA cores) or at bf16 (3, tensor cores), of the backward's first pass
// at fp32 (1, CUDA cores) or at bf16 (2, tensor cores). Kind 4: the fp32
// backward's warps per block; 5: its bytes per warp (the rest of kind 1 is
// the staged float32 weights); 6 and 7: the same of the fp32 forward.
int dense_cfconv_smem_bytes(int kind) {
  switch (kind) {
    case 0: return FF_SMEM;
    case 1: return DF_SMEM;
    case 2: return DM_SMEM;
    case 3: return FW_SMEM;
    case 4: return DF_WARPS;
    case 5: return (int)sizeof(float) * DF_WARP_FLOATS;
    case 6: return FF_WARPS;
    case 7: return (int)sizeof(float) * FF_WARP_FLOATS;
    default: return -1;
  }
}

}  // extern "C"
