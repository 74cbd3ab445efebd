// Device code shared by the exact-filter CFConv kernels of
// cfconv_dense_kernels.cu (all pairs) and cfconv_kernels.cu (neighbour
// matrix): the pair geometry; the tensor-core kernels' live-pair rings with
// their filter-MLP tiles, the backward's four products (bwd_mma_tile) and
// the forward's two (fwd_mma_tile); the fp32 live-pair tiles on the CUDA
// cores, on the same rings (bwd_ffma_tile, fwd_ffma_tile); and the
// forward-tile kernels' item loop of both tiers (fwd_items), which the dense
// and the neighbour-matrix forwards run at bf16 and at fp32.
//
// Precision tiers: the CUDA-core tiles compute float32 only; the bf16 tier
// runs on the tensor-core tiles below, with the operands of the products
// rounded to bf16 (round to nearest even) and everything else float32.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;     // threads per block of the gpos kernels
constexpr int F = 128;           // filters: the kernels take exactly 128
constexpr int RMAX = 64;         // radial basis functions, at most

const double PI = 3.14159265358979323846;

// Sum over the 16 lanes of a half warp; every lane gets the same bits.
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Pair geometry of rel = pj - pi; returns whether the pair contributes
// (valid and d < rc).
__device__ __forceinline__ bool pair_geom(const float* pi, const float* pj,
                                          bool valid, float rcut,
                                          float arg_scale, float dcut_scale,
                                          float& d, float& cut, float& dcut,
                                          float* rel) {
  rel[0] = pj[0] - pi[0];
  rel[1] = pj[1] - pi[1];
  rel[2] = pj[2] - pi[2];
  float d2 = rel[0] * rel[0] + rel[1] * rel[1] + rel[2] * rel[2];
  d = sqrtf(fmaxf(d2, 1e-12f));
  float arg = d * arg_scale;
  bool inside = valid && d < rcut;
  cut = inside ? 0.5f * (cosf(arg) + 1.0f) : 0.0f;
  dcut = inside ? dcut_scale * sinf(arg) : 0.0f;
  return inside;
}

// ---------------------------------------------------------------------------
// Tensor-core tiles of the filter MLP: mma.m16n8k16 with bf16 operands and
// float32 accumulators, M = 16 pairs. A lane (gq = lane / 4, tq = lane % 4)
// holds accumulator element e of n-tile nt at (pair gq + 8 (e >> 1),
// column 8 nt + 2 tq + (e & 1)), and A-fragment register i of a k-step at
// (pair gq + 8 (i & 1), k 2 tq + 8 (i >> 1) + {0, 1}). So the accumulators
// of n-tiles 2 ks and 2 ks + 1 are, packed, the A fragment of k-step ks of
// the next product (mlp_afrag): activations pass from one product to the
// next in registers. B comes from bf16 copies of the weights in shared
// memory (stage_weights_bf16) through ldmatrix, plain for a product with
// the transposed weight, .trans for one with the weight as stored.

constexpr int LDB = F + 8;  // bf16 row stride: 16-byte rows, no conflicts

// Two floats as one bf16x2 operand, round to nearest even; `lo_k` is the
// lower k index (the lower 16 bits).
__device__ __forceinline__ unsigned pack_bf16x2(float lo_k, float hi_k) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_k, hi_k);
  return *reinterpret_cast<unsigned*>(&v);
}

// d += a b for one m16n8k16 bf16 tile, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of k-step ks from accumulators v (n-tiles 2 ks, 2 ks + 1).
template <int NT>
__device__ __forceinline__ void mlp_afrag(unsigned (&a)[4],
                                          const float (&v)[NT][4], int ks) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* t = v[2 * ks + (i >> 1)];
    a[i] = pack_bf16x2(t[2 * (i & 1)], t[2 * (i & 1) + 1]);
  }
}

// acc[n-tiles 0 .. 2 np_end - 1] += a (k-step k0) times the weight w, a bf16
// [rows][LDB] matrix in shared memory: TRANS, B[k][n] = w[k][n] (the
// product with w); otherwise B[k][n] = w[n][k] (with w^T). One ldmatrix.x4
// gives the B fragments of two n-tiles.
template <bool TRANS, int NT>
__device__ __forceinline__ void mma_kstep(float (&acc)[NT][4],
                                          const unsigned (&a)[4],
                                          const __nv_bfloat16* w, int k0,
                                          int np_end, int lane) {
  const int mat = lane >> 3, r = lane & 7;
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    if (np >= np_end) break;
    int n0 = 16 * np;
    const __nv_bfloat16* p =
        TRANS ? w + (k0 + 8 * (mat & 1) + r) * LDB + n0 + 8 * (mat >> 1)
              : w + (n0 + 8 * (mat >> 1) + r) * LDB + k0 + 8 * (mat & 1);
    unsigned addr = (unsigned)__cvta_generic_to_shared(p);
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

// w0 [R, F] -> w0_b [RMAX][LDB] (rows >= R zero) and w1 [F, F] -> w1_b
// [F][LDB], rounded to bf16; b0 and the offsets (zero past R) as they are.
__device__ __forceinline__ void stage_weights_bf16(const float* __restrict__ w0,
                                   const float* __restrict__ b0,
                                   const float* __restrict__ w1,
                                   const float* __restrict__ offset, int R,
                                   __nv_bfloat16* w0_b, __nv_bfloat16* w1_b,
                                   float* b0_s, float* off_s) {
  for (int e = threadIdx.x; e < RMAX * F; e += blockDim.x) {
    int r = e / F, f = e % F;
    w0_b[r * LDB + f] = __float2bfloat16_rn(r < R ? w0[r * F + f] : 0.0f);
  }
  for (int e = threadIdx.x; e < F * F; e += blockDim.x)
    w1_b[(e / F) * LDB + e % F] = __float2bfloat16_rn(w1[e]);
  for (int e = threadIdx.x; e < F; e += blockDim.x) b0_s[e] = b0[e];
  for (int e = threadIdx.x; e < RMAX; e += blockDim.x)
    off_s[e] = e < R ? offset[e] : 0.0f;
}

// ---------------------------------------------------------------------------
// The tensor-core kernels' live-pair rings. A persistent grid stages w0 and
// w1 once per block as bf16 in shared memory (stage_mma_smem); each warp
// then owns work items of DM_RW rows of one molecule and walks them alone:
// it votes the rows' pairs (or list slots) 32 at a time and appends the
// live ones, in order, to a ring in shared memory (ring_push); every 16
// entries of the ring are one M tile of the filter MLP (bwd_mma_tile,
// fwd_mma_tile), so only the last tile of an item carries padding. An
// item's output rows are owned by its warp: no atomics, and every sum runs
// in ring order, so results are bitwise reproducible.

constexpr int DM_WARPS = 8;    // warps per block of the backward tiles
constexpr int FW_WARPS = 16;   // warps per block of the forward tiles
constexpr int DM_RW = 4;       // rows per work item
constexpr int DM_RING = 64;    // live-pair ring per warp (a power of two)
constexpr int DM_VLD = F + 4;  // row stride of the per-pair W cut staging
constexpr int RING_MAX = 0xffff;  // largest partner or slot of an entry
// bytes of the staged weights: w0_b [RMAX][LDB], w1_b [F][LDB], b0, off
constexpr int WB_BYTES = 2 * (RMAX + F) * LDB + 4 * (F + RMAX);
// per warp of a forward-tile kernel, in floats: W cut staging [16][DM_VLD],
// the output rows [DM_RW][F], the ring
constexpr int FW_WARP_FLOATS = 16 * DM_VLD + DM_RW * F + DM_RING;
constexpr int FW_SMEM = WB_BYTES + 4 * FW_WARPS * FW_WARP_FLOATS;  // bytes

// Stages the weights into the dynamic shared memory `smem` (stage_weights_
// bf16) and returns the start of the per-warp areas behind them.
__device__ __forceinline__ float* stage_mma_smem(
    float4* smem, const float* __restrict__ w0, const float* __restrict__ b0,
    const float* __restrict__ w1, const float* __restrict__ offset, int R,
    const __nv_bfloat16*& w0_b, const __nv_bfloat16*& w1_b,
    const float*& b0_s, const float*& off_s) {
  __nv_bfloat16* w0_w = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* w1_w = w0_w + RMAX * LDB;
  float* b0_w = reinterpret_cast<float*>(w1_w + F * LDB);
  float* off_w = b0_w + F;
  stage_weights_bf16(w0, b0, w1, offset, R, w0_w, w1_w, b0_w, off_w);
  __syncthreads();
  w0_b = w0_w;
  w1_b = w1_w;
  b0_s = b0_w;
  off_s = off_w;
  return off_w + RMAX;
}

// Appends `entry` of every lane with `live` to the ring, in lane order;
// returns the ring's new tail.
__device__ __forceinline__ int ring_push(int* ring, int tail, bool live,
                                         int entry, int lane) {
  unsigned vote = __ballot_sync(0xffffffffu, live);
  if (live)
    ring[(tail + __popc(vote & ((1u << lane) - 1u))) & (DM_RING - 1)] = entry;
  __syncwarp();
  return tail + __popc(vote);
}

// One M tile of the filter MLP backward: the ring's entries head .. head +
// nv - 1 (nv <= 16) of the item at row r0 (pointers at its molecule). Each
// entry is (row - r0) << 16 | e, where e is the partner j (dense) or, with
// NBR, the slot k of the row, whose partner is idx[row][k]; gd lands at
// gd[row * stride + e] (stride A dense, K with NBR). Four products (see
// dense_bwd_mma_kernel); with GX (dense only), gx_s rows += (W cut) g_j.
template <bool GX, bool NBR>
__device__ __forceinline__ void bwd_mma_tile(
    const int* ring, int head, int nv, int r0, const float* pos,
    const int* idx, int stride, const float* x, const float* g,
    const float* gi_s, float* v_s, float* gx_s, float4* a0_s, float* gd,
    const __nv_bfloat16* w0_b, const __nv_bfloat16* w1_b, const float* b0_s,
    const float* off_s, int R, float coeff, float rcut, float arg_scale,
    float dcut_scale, int lane) {
  static_assert(!(GX && NBR), "the neighbour-matrix gx runs over the CSR");
  const int gq = lane >> 2, tq = lane & 3;
  const int nks = (R + 15) >> 4;  // k-steps over R, n-tile pairs over R
  // this lane's pairs: tile rows gq (h = 0) and gq + 8 (h = 1)
  int rr[2], ee[2], jj[2];
  float d[2], cut[2], dcut[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int t = gq + 8 * h;
    bool ok = t < nv;
    int ent = ok ? ring[(head + t) & (DM_RING - 1)] : 0;
    rr[h] = ent >> 16;
    ee[h] = ent & 0xffff;
    jj[h] = NBR ? idx[(r0 + rr[h]) * stride + ee[h]] : ee[h];
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
        gd[(size_t)(r0 + rr[h]) * stride + ee[h]] =
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


// One M tile of the filter MLP forward: the ring's entries head .. head +
// nv - 1 (nv <= 16) of the item at row r0 (pointers at its molecule), each
// (row - r0) << 16 | p for the pair (row, p). Two products: a0 =
// tanh(bf16(rbf) bf16(w0) + b0) (K = R padded to 16) and W = bf16(a0)
// bf16(w1), a0's accumulators packed by mlp_afrag as W's A fragments, never
// leaving registers. Each product runs in quarters of its columns (16
// accumulators at a time), so that a thread fits in 128 registers and 16
// warps share an SM. W cut is staged per pair in v_s, then out_s rows +=
// (W cut) src[p] in ring order: a running sum per row segment, lane l on
// features 4 l .. 4 l + 3 (src[p] read coalesced). The roundings of the
// twins: bf16(rbf cut), bf16(w0), bf16(a0), bf16(w1); tanh, the geometry
// and the sums float32.
__device__ __forceinline__ void fwd_mma_tile(
    const int* ring, int head, int nv, int r0, const float* pos,
    const float* src, float* v_s, float* out_s, const __nv_bfloat16* w0_b,
    const __nv_bfloat16* w1_b, const float* b0_s, const float* off_s, int R,
    float coeff, float rcut, float arg_scale, float dcut_scale, int lane) {
  const int gq = lane >> 2, tq = lane & 3;
  const int nks = (R + 15) >> 4;  // k-steps over R
  // this lane's pairs: tile rows gq (h = 0) and gq + 8 (h = 1)
  float d[2], cut[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int t = gq + 8 * h;
    bool ok = t < nv;
    int ent = ok ? ring[(head + t) & (DM_RING - 1)] : 0;
    float dcut, rel[3];
    pair_geom(pos + (r0 + (ent >> 16)) * 3, pos + (ent & 0xffff) * 3, ok,
              rcut, arg_scale, dcut_scale, d[h], cut[h], dcut, rel);
  }

  // bf16(rbf) as the A fragments of a0's product (K = R padded to 16)
  unsigned ar[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int h = i & 1, r = 16 * ks + 8 * (i >> 1) + 2 * tq;
      float v[2];
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        float dr = d[h] - off_s[r + b];
        v[b] = r + b < R ? expf(coeff * (dr * dr)) * cut[h] : 0.0f;
      }
      ar[ks][i] = pack_bf16x2(v[0], v[1]);
    }
  // a0 = tanh(bf16(rbf) @ bf16(w0) + b0) in quarters of its columns, each
  // packed as bf16 into the A fragments of W's two k-steps over it
  unsigned af[8][4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float a0[4][4] = {};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (ks >= nks) break;
      mma_kstep<true>(a0, ar[ks], w0_b + 32 * q, 16 * ks, 2, lane);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float2 b = *reinterpret_cast<const float2*>(
          b0_s + 32 * q + 8 * nt + 2 * tq);
      a0[nt][0] = tanhf(a0[nt][0] + b.x);
      a0[nt][1] = tanhf(a0[nt][1] + b.y);
      a0[nt][2] = tanhf(a0[nt][2] + b.x);
      a0[nt][3] = tanhf(a0[nt][3] + b.y);
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) mlp_afrag(af[2 * q + ks], a0, ks);
  }

  // W = bf16(a0) @ bf16(w1) in quarters of its columns, W cut staged
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float w[4][4] = {};
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      mma_kstep<true>(w, af[ks], w1_b + 32 * q, 16 * ks, 2, lane);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(v_s + (gq + 8 * h) * DM_VLD + 32 * q +
                                   8 * nt + 2 * tq) =
            make_float2(w[nt][2 * h] * cut[h], w[nt][2 * h + 1] * cut[h]);
  }

  // out rows += (W cut) src[p], pairs in ring order
  __syncwarp();
  float4 run = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int cur = ring[head & (DM_RING - 1)] >> 16;
#pragma unroll 1
  for (int t = 0; t < nv; ++t) {
    int ent = ring[(head + t) & (DM_RING - 1)], r = ent >> 16;
    if (r != cur) {
      float4* o = reinterpret_cast<float4*>(out_s + cur * F) + lane;
      float4 a = *o;
      *o = make_float4(a.x + run.x, a.y + run.y, a.z + run.z, a.w + run.w);
      run = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      cur = r;
    }
    const float4 v = reinterpret_cast<const float4*>(v_s + t * DM_VLD)[lane];
    const float4 sp =
        reinterpret_cast<const float4*>(src + (size_t)(ent & 0xffff) * F)[lane];
    run.x += __fmul_rn(v.x, sp.x);
    run.y += __fmul_rn(v.y, sp.y);
    run.z += __fmul_rn(v.z, sp.z);
    run.w += __fmul_rn(v.w, sp.w);
  }
  float4* o = reinterpret_cast<float4*>(out_s + cur * F) + lane;
  float4 a = *o;
  *o = make_float4(a.x + run.x, a.y + run.y, a.z + run.z, a.w + run.w);
  __syncwarp();  // the ring and v_s are read before they are written again
}

// A persistent grid for a kernel of `warps` warps a block and `smem` bytes
// of dynamic shared memory (one block per SM fits), one warp per work item
// at a time: a block per SM, or fewer when there are fewer items.
template <typename K>
cudaError_t launch_persistent(K kernel, int warps, int smem, int n_items,
                              cudaStream_t stream, void** args) {
  int dev, n_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int blocks = (n_items + warps - 1) / warps;
  err = cudaLaunchKernel((const void*)kernel, dim3(blocks < n_sm ? blocks
                                                                  : n_sm),
                         dim3(32 * warps), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The fp32 live-pair tiles on the CUDA cores: the tensor-core kernels' ring
// and work items, with the filter-MLP products as register-tiled float32
// FMAs. A warp takes DF_TILE = 16 ring entries at a time; its activation
// tiles are pair-major [DF_TILE][F] in its own shared memory, w0 and w1
// float32 in the block's, row stride DF_LDW. A product's lane holds DF_PP =
// 8 pairs x 8 output columns (64 accumulators) and reads, per 4 steps of the
// reduction, one float4 of each of its pairs' activations and 8 float4 of
// weights: 256 FMAs per 16 shared loads. The products with w (a0 = rbf w0,
// W = a0 w1) take the lane's columns 4 fg + {0..3} and 64 + 4 fg + {0..3}
// of a weight row (float4 reads along the row); those with w^T (ga0 =
// cot w1^T, grbf = gt0 w0^T) take weight rows, read as float4 along the
// reduction, rows 1 apart in the 8 lanes of a phase, which the stride
// DF_LDW = F + 4 puts in distinct banks.
//
// The forward (fwd_ffma_tile) is the backward's first two products
// (df_filter) and its gx epilogue (ring_sum) with x in g's place: no a0 kept
// for (1 - a0^2), no gd, one activation tile a warp. The backward
// (bwd_ffma_tile) adds the two transposed products and gd.

constexpr int DF_LDW = F + 4;  // float32 weight row stride
constexpr int DF_PP = 8;       // pairs per lane of a product
constexpr int DF_TILE = 16;    // pairs per tile
// floats of the block's staged weights: w0_s [RMAX][DF_LDW], w1_s
// [F][DF_LDW], b0, offsets
constexpr int DF_W_FLOATS = (RMAX + F) * DF_LDW + F + RMAX;
// floats per warp of the backward: a0 (then gt0) and the second tile (rbf,
// W cut, then the cotangent), the item's gx rows, per-pair d, cut, dcut and
// s_cut, the ring
constexpr int DF_WARP_FLOATS = 2 * DF_TILE * F + DM_RW * F + 4 * DF_TILE +
                               DM_RING;
// warps per block of the backward: one on each of the SM's four
// schedulers. The 227 KB a block may hold would take 6, but then two
// schedulers carry two warps each and set the pace (tools/bwd_variants.py,
// H100 80GB HBM3, 700 W: 6 and 5 warps ran 12 % and 5-8 % slower than 4, 3
// warps 27-31 %).
constexpr int DF_WARPS = 4;
static_assert(4 * (DF_W_FLOATS + DF_WARPS * DF_WARP_FLOATS) <= 232448,
              "the fp32 backward's shared memory");
constexpr int DF_SMEM = 4 * (DF_W_FLOATS + DF_WARPS * DF_WARP_FLOATS);
// floats per warp of the forward: one tile (rbf, then a0, then W cut), the
// per-pair d, cut and dcut, the item's out rows, the ring
constexpr int FF_WARP_FLOATS = DF_TILE * F + 4 * DF_TILE + DM_RW * F +
                               DM_RING;
// warps per block of the forward, dense and neighbour-matrix: two on each
// of the SM's four schedulers (237 and 255 registers a thread). Shared
// memory holds 12 beside the staged weights, but 12 warps cap a thread at
// 168 registers and spill (tools/bwd_variants.py, H100 80GB HBM3, 700 W:
// dense_cfconv_fwd_fp32 on the dense slice, 8 warps 1.884 ms, 4 2.146, 6
// 2.241, 12 2.067; cfconv_fwd_fp32 on the pallas slice's list, 8 warps
// 1.869, 4 2.159-2.169, 6 2.223-2.260, 12 1.971-1.988).
constexpr int FF_WARPS = 8;
static_assert(4 * (DF_W_FLOATS + FF_WARPS * FF_WARP_FLOATS) <= 232448,
              "the fp32 forward's shared memory");
constexpr int FF_SMEM = 4 * (DF_W_FLOATS + FF_WARPS * FF_WARP_FLOATS);

// w0 [R, F] -> w0_s [RMAX][DF_LDW] (rows >= R zero), w1 [F, F] -> w1_s
// [F][DF_LDW], float32; b0 and the offsets (zero past R) as they are.
__device__ __forceinline__ void stage_weights_f32(
    const float* __restrict__ w0, const float* __restrict__ b0,
    const float* __restrict__ w1, const float* __restrict__ offset, int R,
    float* w0_s, float* w1_s, float* b0_s, float* off_s) {
  for (int e = threadIdx.x; e < RMAX * F; e += blockDim.x) {
    int r = e / F, f = e % F;
    w0_s[r * DF_LDW + f] = r < R ? w0[r * F + f] : 0.0f;
  }
  for (int e = threadIdx.x; e < F * F; e += blockDim.x)
    w1_s[(e / F) * DF_LDW + e % F] = w1[e];
  for (int e = threadIdx.x; e < F; e += blockDim.x) b0_s[e] = b0[e];
  for (int e = threadIdx.x; e < RMAX; e += blockDim.x)
    off_s[e] = e < R ? offset[e] : 0.0f;
}

// Stages the weights as float32 into the dynamic shared memory `smem`
// (stage_weights_f32) and returns the start of the per-warp areas behind
// them.
__device__ __forceinline__ float* stage_ffma_smem(
    float4* smem, const float* __restrict__ w0, const float* __restrict__ b0,
    const float* __restrict__ w1, const float* __restrict__ offset, int R,
    const float*& w0_s, const float*& w1_s, const float*& b0_s,
    const float*& off_s) {
  float* w0_w = reinterpret_cast<float*>(smem);  // [RMAX][DF_LDW]
  float* w1_w = w0_w + RMAX * DF_LDW;            // [F][DF_LDW]
  float* b0_w = w1_w + F * DF_LDW;               // [F]
  float* off_w = b0_w + F;                       // [RMAX]
  stage_weights_f32(w0, b0, w1, offset, R, w0_w, w1_w, b0_w, off_w);
  __syncthreads();
  w0_s = w0_w;
  w1_s = w1_w;
  b0_s = b0_w;
  off_s = off_w;
  return off_w + RMAX;
}

// acc[q][c] = sum_{k < K} a[(p0 + q) lda + k] w[k DF_LDW + n_c] (the
// product with w), n_c = 4 fg + c (c < 4), 64 + 4 fg + c - 4 (c >= 4); a
// pair-major, K a multiple of 4; the sum over k in order.
__device__ __forceinline__ void df_rowprod(float (&acc)[DF_PP][8],
                                           const float* a, int lda,
                                           const float* w, int K, int p0,
                                           int fg) {
#pragma unroll
  for (int q = 0; q < DF_PP; ++q)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[q][c] = 0.0f;
#pragma unroll 1
  for (int k = 0; k < K; k += 4) {
    float4 av[DF_PP];
#pragma unroll
    for (int q = 0; q < DF_PP; ++q)
      av[q] = *reinterpret_cast<const float4*>(a + (p0 + q) * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* wr = w + (k + kk) * DF_LDW + 4 * fg;
      const float4 lo = *reinterpret_cast<const float4*>(wr);
      const float4 hi = *reinterpret_cast<const float4*>(wr + F / 2);
      const float b[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int q = 0; q < DF_PP; ++q) {
        const float aq = kk == 0 ? av[q].x : kk == 1 ? av[q].y
                       : kk == 2 ? av[q].z : av[q].w;
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[q][c] = fmaf(aq, b[c], acc[q][c]);
      }
    }
  }
}

// acc[q][c] = sum_{k0 <= k < k1} a[(p0 + q) lda + k] w[(row0 + c step)
// DF_LDW + k] (the product with w^T, rows of w as its columns); a
// pair-major, k0 and k1 multiples of 4; the sum over k in order.
__device__ __forceinline__ void df_colprod(float (&acc)[DF_PP][8],
                                           const float* a, int lda,
                                           const float* w, int k0, int k1,
                                           int p0, int row0, int step) {
#pragma unroll
  for (int q = 0; q < DF_PP; ++q)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[q][c] = 0.0f;
#pragma unroll 1
  for (int k = k0; k < k1; k += 4) {
    float4 av[DF_PP];
#pragma unroll
    for (int q = 0; q < DF_PP; ++q)
      av[q] = *reinterpret_cast<const float4*>(a + (p0 + q) * lda + k);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float4 b = *reinterpret_cast<const float4*>(
          w + (row0 + c * step) * DF_LDW + k);
#pragma unroll
      for (int q = 0; q < DF_PP; ++q) {
        acc[q][c] = fmaf(av[q].x, b.x, acc[q][c]);
        acc[q][c] = fmaf(av[q].y, b.y, acc[q][c]);
        acc[q][c] = fmaf(av[q].z, b.z, acc[q][c]);
        acc[q][c] = fmaf(av[q].w, b.w, acc[q][c]);
      }
    }
  }
}

// The partner atom of ring entry `ent` of the item at row r0: its low 16
// bits (dense, and every forward ring), or with NBR the atom in slot
// ent & 0xffff of row r0 + (ent >> 16) of the list idx (row stride
// `stride` = K).
template <bool NBR>
__device__ __forceinline__ int df_partner(const int* idx, int stride, int r0,
                                          int ent) {
  return NBR ? idx[(r0 + (ent >> 16)) * stride + (ent & 0xffff)]
             : ent & 0xffff;
}

// The first two products of a tile: the ring's entries head .. head + nv -
// 1 (nv <= DF_TILE) of the item at row r0 (pointers at its molecule), each
// (row - r0) << 16 | e (df_partner). Per pair d, cut, dcut into pd_s; rbf =
// exp(coeff (d - offset)^2) cut into rbf_s [DF_TILE][R rounded up to 4];
// a0 = tanh(rbf w0 + b0) (tanhf) into act_s [DF_TILE][F], which may be
// rbf_s; W = a0 w1 in acc, the lane's pairs p0 + q x columns 4 fg + c (c <
// 4), 64 + 4 fg + c - 4 (df_rowprod). Padding entries (nv <= t) carry cut =
// 0: their products are zero and never stored.
template <bool NBR>
__device__ __forceinline__ void df_filter(
    float (&acc)[DF_PP][8], const int* ring, int head, int nv, int r0,
    const float* pos, const int* idx, int stride, float* rbf_s, float* act_s,
    float* pd_s, const float* w0_s, const float* w1_s, const float* b0_s,
    const float* off_s, int R, float coeff, float rcut, float arg_scale,
    float dcut_scale, int lane) {
  const int fg = lane & 15, p0 = DF_PP * (lane >> 4);
  if (lane < DF_TILE) {
    float d = rcut, cut = 0.0f, dcut = 0.0f;
    if (lane < nv) {
      int ent = ring[(head + lane) & (DM_RING - 1)];
      float rel[3];
      pair_geom(pos + (r0 + (ent >> 16)) * 3,
                pos + df_partner<NBR>(idx, stride, r0, ent) * 3, true, rcut,
                arg_scale, dcut_scale, d, cut, dcut, rel);
    }
    pd_s[4 * lane] = d;
    pd_s[4 * lane + 1] = cut;
    pd_s[4 * lane + 2] = dcut;
  }
  __syncwarp();
  const int rp = (R + 3) & ~3;  // rbf columns, zero past R
  for (int e = lane; e < DF_TILE * rp; e += 32) {
    int p = e / rp, r = e - p * rp;
    float v = 0.0f;
    if (r < R && p < nv) {
      float dr = pd_s[4 * p] - off_s[r];
      v = expf(coeff * (dr * dr)) * pd_s[4 * p + 1];
    }
    rbf_s[p * rp + r] = v;
  }
  __syncwarp();

  // a0 = tanh(rbf @ w0 + b0) -> act_s
  df_rowprod(acc, rbf_s, rp, w0_s, rp, p0, fg);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float b = b0_s[(c < 4 ? 0 : F / 2) + 4 * fg + (c & 3)];
#pragma unroll
    for (int q = 0; q < DF_PP; ++q) acc[q][c] = tanhf(acc[q][c] + b);
  }
  // rbf_s is read before a0 may take its place (the forward); apart, the
  // backward's a0 stores need no barrier, and one there costs it 2 %
  // (tools/bwd_variants.py, H100 80GB HBM3, 700 W: 4.770 against 4.660 ms)
  if (rbf_s == act_s) __syncwarp();
#pragma unroll
  for (int q = 0; q < DF_PP; ++q) {
    float* o = act_s + (p0 + q) * F + 4 * fg;
    *reinterpret_cast<float4*>(o) =
        make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
    *reinterpret_cast<float4*>(o + F / 2) =
        make_float4(acc[q][4], acc[q][5], acc[q][6], acc[q][7]);
  }
  __syncwarp();

  // W = a0 @ w1
  df_rowprod(acc, act_s, F, w1_s, F, p0, fg);
}

// out_s rows += v_s[t] src[j_t] for t < nv, the ring's entries head .. in
// order ((row - r0) << 16 | j_t), v_s pair-major [DF_TILE][F]: a running
// sum per row segment, lane l on features 4 l .. 4 l + 3 (src rows read
// coalesced).
__device__ __forceinline__ void ring_sum(const int* ring, int head, int nv,
                                         const float* v_s, const float* src,
                                         float* out_s, int lane) {
  float4 run = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int cur = ring[head & (DM_RING - 1)] >> 16;
#pragma unroll 1
  for (int t = 0; t < nv; ++t) {
    int ent = ring[(head + t) & (DM_RING - 1)], r = ent >> 16;
    if (r != cur) {
      float4* o = reinterpret_cast<float4*>(out_s + cur * F) + lane;
      float4 a = *o;
      *o = make_float4(a.x + run.x, a.y + run.y, a.z + run.z, a.w + run.w);
      run = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      cur = r;
    }
    const float4 v = reinterpret_cast<const float4*>(v_s + t * F)[lane];
    const float4 sp =
        reinterpret_cast<const float4*>(src + (size_t)(ent & 0xffff) * F)[lane];
    run.x += __fmul_rn(v.x, sp.x);
    run.y += __fmul_rn(v.y, sp.y);
    run.z += __fmul_rn(v.z, sp.z);
    run.w += __fmul_rn(v.w, sp.w);
  }
  float4* o = reinterpret_cast<float4*>(out_s + cur * F) + lane;
  float4 a = *o;
  *o = make_float4(a.x + run.x, a.y + run.y, a.z + run.z, a.w + run.w);
}

// One tile of the fp32 filter-MLP forward: the ring's entries head .. head
// + nv - 1 (nv <= DF_TILE) of the item at row r0, each (row - r0) << 16 |
// j. a0 and W (df_filter, rbf and a0 in tile_s), W cut staged in tile_s in
// a0's place, then out_s rows += (W cut) src_j in ring order (ring_sum).
__device__ __forceinline__ void fwd_ffma_tile(
    const int* ring, int head, int nv, int r0, const float* pos,
    const float* src, float* tile_s, float* pd_s, float* out_s,
    const float* w0_s, const float* w1_s, const float* b0_s,
    const float* off_s, int R, float coeff, float rcut, float arg_scale,
    float dcut_scale, int lane) {
  const int fg = lane & 15, p0 = DF_PP * (lane >> 4);
  float acc[DF_PP][8];
  df_filter<false>(acc, ring, head, nv, r0, pos, nullptr, 0, tile_s, tile_s,
                   pd_s, w0_s, w1_s, b0_s, off_s, R, coeff, rcut, arg_scale,
                   dcut_scale, lane);
  __syncwarp();  // a0 is read before W cut takes its place
#pragma unroll
  for (int q = 0; q < DF_PP; ++q) {
    const float cutp = pd_s[4 * (p0 + q) + 1];
    float* o = tile_s + (p0 + q) * F + 4 * fg;
    *reinterpret_cast<float4*>(o) =
        make_float4(acc[q][0] * cutp, acc[q][1] * cutp, acc[q][2] * cutp,
                    acc[q][3] * cutp);
    *reinterpret_cast<float4*>(o + F / 2) =
        make_float4(acc[q][4] * cutp, acc[q][5] * cutp, acc[q][6] * cutp,
                    acc[q][7] * cutp);
  }
  __syncwarp();
  ring_sum(ring, head, nv, tile_s, src, out_s, lane);
  __syncwarp();  // the ring and tile_s are read before they are written again
}

// One tile of the fp32 filter-MLP backward: the ring's entries head ..
// head + nv - 1 (nv <= DF_TILE) of the item at row r0 (pointers at its
// molecule), each (row - r0) << 16 | e, e the partner j (dense) or, with
// NBR, the slot k of the row, whose partner is idx[row][k]; gd lands at
// gd[row * stride + e] (stride A dense, K with NBR). In order: d, cut,
// dcut, rbf, a0 (kept in act_s) and W (df_filter, rbf in buf_s); s_cut =
// sum_f (g_i W) x_j, the cotangent (g_i x_j) cut and, with GX, W cut staged
// for gx (dense) or W stored at wbuf[row * stride + e] (NBR: the workspace
// that the gx pass reads back); ga0 = cot w1^T and gt0 = ga0 (1 - a0^2) in
// place of a0; grbf = gt0 w0^T over the two halves of F (lanes 16 apart,
// added), then se = sum_r grbf e_r, sg = sum_r grbf e_r (d - offset_r)
// (expf) and gd = cut 2 coeff sg + (s_cut + se) dcut. With GX (dense),
// gx_s rows += (W cut) g_j, pairs in ring order (ring_sum).
template <bool GX, bool NBR>
__device__ __forceinline__ void bwd_ffma_tile(
    const int* ring, int head, int nv, int r0, const float* pos,
    const int* idx, int stride, const float* x, const float* g, float* act_s,
    float* buf_s, float* pd_s, float* gx_s, float* gd, float* wbuf,
    const float* w0_s, const float* w1_s, const float* b0_s,
    const float* off_s, int R, float coeff, float rcut, float arg_scale,
    float dcut_scale, int lane) {
  const int pg = lane >> 4, fg = lane & 15, p0 = DF_PP * pg;
  float acc[DF_PP][8];
  df_filter<NBR>(acc, ring, head, nv, r0, pos, idx, stride, buf_s, act_s,
                 pd_s, w0_s, w1_s, b0_s, off_s, R, coeff, rcut, arg_scale,
                 dcut_scale, lane);

  // s_cut, W cut for gx or W for the gx pass, and the cotangent in W's
  // registers
  float sc[DF_PP];
#pragma unroll
  for (int q = 0; q < DF_PP; ++q) {
    const int p = p0 + q;
    const int ent = p < nv ? ring[(head + p) & (DM_RING - 1)] : 0;
    const float cutp = pd_s[4 * p + 1];
    const float* gi = g + (size_t)(r0 + (ent >> 16)) * F + 4 * fg;
    const float* xj =
        x + (size_t)df_partner<NBR>(idx, stride, r0, ent) * F + 4 * fg;
    const float4 gl = *reinterpret_cast<const float4*>(gi);
    const float4 gh = *reinterpret_cast<const float4*>(gi + F / 2);
    const float4 xl = *reinterpret_cast<const float4*>(xj);
    const float4 xh = *reinterpret_cast<const float4*>(xj + F / 2);
    const float gv[8] = {gl.x, gl.y, gl.z, gl.w, gh.x, gh.y, gh.z, gh.w};
    const float xv[8] = {xl.x, xl.y, xl.z, xl.w, xh.x, xh.y, xh.z, xh.w};
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) s += (gv[c] * acc[q][c]) * xv[c];
    sc[q] = s;
    if (GX && !NBR) {
      float* o = buf_s + p * F + 4 * fg;
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[q][0] * cutp, acc[q][1] * cutp, acc[q][2] * cutp,
                      acc[q][3] * cutp);
      *reinterpret_cast<float4*>(o + F / 2) =
          make_float4(acc[q][4] * cutp, acc[q][5] * cutp, acc[q][6] * cutp,
                      acc[q][7] * cutp);
    }
    if (GX && NBR && p < nv) {
      float* o = wbuf + ((size_t)(r0 + (ent >> 16)) * stride + (ent & 0xffff))
                            * F + 4 * fg;
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
      *reinterpret_cast<float4*>(o + F / 2) =
          make_float4(acc[q][4], acc[q][5], acc[q][6], acc[q][7]);
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[q][c] = (gv[c] * xv[c]) * cutp;
  }
#pragma unroll
  for (int q = 0; q < DF_PP; ++q) sc[q] = sum16(sc[q]);
  if (fg == 0) {
#pragma unroll
    for (int q = 0; q < DF_PP; ++q) pd_s[4 * (p0 + q) + 3] = sc[q];
  }
  __syncwarp();
  if (GX && !NBR) {
    ring_sum(ring, head, nv, buf_s, g, gx_s, lane);
    __syncwarp();
  }
#pragma unroll
  for (int q = 0; q < DF_PP; ++q) {
    float* o = buf_s + (p0 + q) * F + 4 * fg;
    *reinterpret_cast<float4*>(o) =
        make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
    *reinterpret_cast<float4*>(o + F / 2) =
        make_float4(acc[q][4], acc[q][5], acc[q][6], acc[q][7]);
  }
  __syncwarp();

  // ga0 = cot @ w1^T (columns fg + 16 c); gt0 = ga0 (1 - a0^2) over a0
  df_colprod(acc, buf_s, F, w1_s, 0, F, p0, fg, 16);
#pragma unroll
  for (int q = 0; q < DF_PP; ++q)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float* a = act_s + (p0 + q) * F + fg + 16 * c;
      const float a0 = *a;
      *a = acc[q][c] * (1.0f - a0 * a0);
    }
  __syncwarp();

  // grbf = gt0 @ w0^T: lane (rg, ph, kh) on columns r = rg + 8 c, pairs
  // 8 ph .., k in [64 kh, 64 kh + 64); the halves added
  const int rg = lane & 7, ph = (lane >> 3) & 1, kh = lane >> 4;
  df_colprod(acc, act_s, F, w0_s, (F / 2) * kh, (F / 2) * (kh + 1),
             DF_PP * ph, rg, 8);
#pragma unroll
  for (int q = 0; q < DF_PP; ++q)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      acc[q][c] += __shfl_xor_sync(0xffffffffu, acc[q][c], 16);
  // se, sg: lane kh takes columns c = 4 kh .. 4 kh + 3
#pragma unroll
  for (int q = 0; q < DF_PP; ++q) {
    const int p = DF_PP * ph + q;
    const float dp = pd_s[4 * p];
    float se = 0.0f, sg = 0.0f;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int r = rg + 8 * (4 * kh + cc);
      const float v = kh ? acc[q][4 + cc] : acc[q][cc];
      if (r < R) {
        float dr = dp - off_s[r];
        float ge = v * expf(coeff * (dr * dr));
        se += ge;
        sg += ge * dr;
      }
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      se += __shfl_xor_sync(0xffffffffu, se, o);
      sg += __shfl_xor_sync(0xffffffffu, sg, o);
    }
    se += __shfl_xor_sync(0xffffffffu, se, 16);
    sg += __shfl_xor_sync(0xffffffffu, sg, 16);
    if (rg == 0 && kh == 0 && p < nv) {
      const int ent = ring[(head + p) & (DM_RING - 1)];
      gd[(size_t)(r0 + (ent >> 16)) * stride + (ent & 0xffff)] =
          pd_s[4 * p + 1] * (2.0f * coeff) * sg +
          (pd_s[4 * p + 3] + se) * pd_s[4 * p + 2];
    }
  }
  __syncwarp();  // the ring and the tiles are read before they are written
}

// The body of a forward-tile kernel, on the tensor cores (MMA: FW_WARPS
// warps a block, FW_SMEM bytes of dynamic shared memory at `smem`, w0 and
// w1 staged as bf16, fwd_mma_tile) or at fp32 on the CUDA cores (FF_WARPS,
// FF_SMEM, float32 weights, fwd_ffma_tile): the weights staged once per
// block; then each warp owns work items of DM_RW rows of one molecule s.
// For each row i it walks the entries e of span(s, i) = [begin, end), 32 at
// a time, and vote(s, ps, i, e, j) (ps: the molecule's positions) says
// whether entry e is live and sets its partner j; the live ones enter the
// ring as (i - r0) << 16 | j and run through the tile, 16 at a time, then
// the tail, summing (W cut) src[j] into the item's rows, which are stored
// to out (rows with no live entry as zeros).
template <bool MMA, typename Span, typename Vote>
__device__ __forceinline__ void fwd_items(
    float4* smem, const float* __restrict__ pos,
    const float* __restrict__ src, const float* __restrict__ w0,
    const float* __restrict__ b0, const float* __restrict__ w1,
    const float* __restrict__ offset, const float* __restrict__ coeff_p,
    float* __restrict__ out, int S, int A, int R, float rcut,
    float arg_scale, float dcut_scale, Span span, Vote vote) {
  constexpr int WARPS = MMA ? FW_WARPS : FF_WARPS;
  const __nv_bfloat16 *w0_b = nullptr, *w1_b = nullptr;
  const float *w0_s = nullptr, *w1_s = nullptr, *b0_s, *off_s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float *v_s, *pd_s = nullptr, *out_s;
  if constexpr (MMA) {
    v_s = stage_mma_smem(smem, w0, b0, w1, offset, R, w0_b, w1_b, b0_s,
                         off_s) +
          warp * FW_WARP_FLOATS;      // [16][DM_VLD]
    out_s = v_s + 16 * DM_VLD;        // [DM_RW][F]
  } else {
    v_s = stage_ffma_smem(smem, w0, b0, w1, offset, R, w0_s, w1_s, b0_s,
                          off_s) +
          warp * FF_WARP_FLOATS;      // [DF_TILE][F]
    pd_s = v_s + DF_TILE * F;         // [DF_TILE][4]
    out_s = pd_s + 4 * DF_TILE;       // [DM_RW][F]
  }
  int* ring = reinterpret_cast<int*>(out_s + DM_RW * F);  // [DM_RING]
  const float coeff = *coeff_p;

  const int n_groups = (A + DM_RW - 1) / DM_RW;
  const int n_items = S * n_groups;
  for (int item = blockIdx.x * WARPS + warp; item < n_items;
       item += gridDim.x * WARPS) {
    const int s = item / n_groups, r0 = (item % n_groups) * DM_RW;
    const float* ps = pos + (size_t)s * A * 3;
    const float* ss = src + (size_t)s * A * F;
    for (int e = lane; e < DM_RW * F; e += 32) out_s[e] = 0.0f;
    __syncwarp();

    int head = 0, tail = 0;
    for (int rr = 0; rr < DM_RW && r0 + rr < A; ++rr) {
      const int2 range = span(s, r0 + rr);
      for (int eb = range.x; eb < range.y; eb += 32) {
        int e = eb + lane, j = 0;
        bool live = e < range.y && vote(s, ps, r0 + rr, e, j);
        tail = ring_push(ring, tail, live, (rr << 16) | j, lane);
        for (; tail - head >= 16; head += 16) {
          if constexpr (MMA)
            fwd_mma_tile(ring, head, 16, r0, ps, ss, v_s, out_s, w0_b, w1_b,
                         b0_s, off_s, R, coeff, rcut, arg_scale, dcut_scale,
                         lane);
          else
            fwd_ffma_tile(ring, head, 16, r0, ps, ss, v_s, pd_s, out_s, w0_s,
                          w1_s, b0_s, off_s, R, coeff, rcut, arg_scale,
                          dcut_scale, lane);
        }
      }
    }
    if (tail > head) {
      if constexpr (MMA)
        fwd_mma_tile(ring, head, tail - head, r0, ps, ss, v_s, out_s, w0_b,
                     w1_b, b0_s, off_s, R, coeff, rcut, arg_scale, dcut_scale,
                     lane);
      else
        fwd_ffma_tile(ring, head, tail - head, r0, ps, ss, v_s, pd_s, out_s,
                      w0_s, w1_s, b0_s, off_s, R, coeff, rcut, arg_scale,
                      dcut_scale, lane);
    }
    float* os = out + (size_t)s * A * F;
    for (int e = 4 * lane; e < DM_RW * F; e += 128) {
      int i = r0 + e / F;
      if (i < A)
        *reinterpret_cast<float4*>(os + (size_t)i * F + e % F) =
            *reinterpret_cast<const float4*>(out_s + e);
    }
    __syncwarp();  // out_s is read before the next item writes
  }
}

}  // namespace
