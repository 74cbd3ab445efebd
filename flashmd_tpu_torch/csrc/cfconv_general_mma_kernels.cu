// The tensor-core tiers of the general-width exact-filter CFConv kernels
// for Hopper (sm_90a), plain C interface for ctypes: bf16 products on the
// tensor cores, with the weights staged whole in each block
// (gw_*_mma_kernel, tier 2) or streamed through it in panels (gp_*_kernel,
// tier 3). cfconv_general_kernels.cu's entry points, cfconv_general_fwd and
// cfconv_general_bwd (the TPU kernels they replace are named there), hand
// these tiers to cfconv_general_mma_fwd and cfconv_general_mma_bwd below;
// ops/cfconv_general.py routes bf16 to them by cfconv_general_mma_layout.
// A source of its own so that nvcc compiles it beside the CUDA-core tiers.

#include "cfconv_general.cuh"
#include "cfconv_tile.cuh"

extern "C" int dense_cfconv_gpos(const float* pos, const float* gd,
                                 float* gpos, int S, int A, void* stream);
extern "C" int cfconv_gpos(const float* pos, const int* idx,
                           const unsigned char* mask, const int* offsets,
                           const int* slots, const float* gd, float* gpos,
                           int S, int A, int K, void* stream);

namespace {

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
// 1 - a0^2) of a launch of `kind` whose block holds `w` bytes beside its
// warps' areas; false where one warp of the largest kind does not fit
// beside them (the same test for every kind, so that the route is a
// function of the widths: ops/cfconv_general.py mma_smem_bytes).
bool mma_shape(long w, int kind, int Fq, int Rq, int& warps, int& smem,
               bool& keep) {
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

// mma_shape of the tiles with the weights staged whole (gm_*).
bool gm_shape(int kind, int Fq, int Rq, int& warps, int& smem, bool& keep) {
  return mma_shape(gm_weight_bytes(Fq, Rq), kind, Fq, Rq, warps, smem, keep);
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

// acc = tanh(acc + b0) over columns c0 .. (np_end n-tile pairs).
__device__ __forceinline__ void gm_tanh_b0(float (&acc)[GM_NT][4],
                                           const float* b0_s, int c0,
                                           int np_end, int lane) {
  const int tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < GM_NT; ++nt) {
    if (nt >= 2 * np_end) break;
    const float2 b =
        *reinterpret_cast<const float2*>(b0_s + c0 + 8 * nt + 2 * tq);
    acc[nt][0] = tanhf(acc[nt][0] + b.x);
    acc[nt][1] = tanhf(acc[nt][1] + b.y);
    acc[nt][2] = tanhf(acc[nt][2] + b.x);
    acc[nt][3] = tanhf(acc[nt][3] + b.y);
  }
}

// The float32 a0 of columns c0 .. (np_end n-tile pairs) into a0_s [Fq /
// 8][32] (n-tile, lane).
__device__ __forceinline__ void gm_keep_a0(float4* a0_s,
                                           const float (&acc)[GM_NT][4],
                                           int c0, int np_end, int lane) {
#pragma unroll
  for (int nt = 0; nt < GM_NT; ++nt) {
    if (nt >= 2 * np_end) break;
    a0_s[32 * ((c0 >> 3) + nt) + lane] =
        make_float4(acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3]);
  }
}

// a0 = tanh(bf16(rbf) bf16(w0) + b0), float32, of columns c0 .. (np_end
// n-tile pairs) into acc.
__device__ __forceinline__ void gm_a0(float (&acc)[GM_NT][4],
                                      const uint4* rbf_f, int nkr,
                                      const GmSmem& w, int c0, int np_end,
                                      int lane) {
  gm_prod<true>(acc, rbf_f, nkr, w.w0 + c0, w.ldw, np_end, lane);
  gm_tanh_b0(acc, w.b0, c0, np_end, lane);
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
    if (a0_s != nullptr) gm_keep_a0(a0_s, acc, c0, np_end, lane);
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

// The body of a tensor-core forward-tile kernel: gw_items' walk, written
// out here (through gw_items these kernels ran up to 31 % slower,
// tools/general_variants.py and tools/tuned_ab.py, H100 80GB HBM3, 700
// W), with the weights staged once per block and gm_fwd_tile; out
// [S][A][Fq].
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

// ---------------------------------------------------------------------------
// The bf16 tier on the tensor cores with the weights streamed through
// shared memory (gp_*, tier GP_TIER of the entry points): the bf16 widths
// whose weights do not fit whole in a block beside one warp (gm_shape
// refuses them: F 256 R 200, 268,352 B; F 320 R 17; F 640 R 8). The
// gm_* tiles' fragments, roundings, ring sums and reductions, with w0 and
// w1 read from device memory in panels of GP_KP x GM_CW = 64 x 64 bf16
// that all warps of a block share. A panel is a sub-block of a weight as
// stored: w[k0 ..][c0 ..] for a product with the weight (B[k][n] =
// w[k][n], ldmatrix .trans) or w[c0 ..][k0 ..] for one with its transpose
// (B[k][n] = w[n][k], plain), so one copy path and one square buffer shape
// serve w and w^T. Each product runs per column chunk of GM_CW over its
// panels of GP_KP k, in gm_prod's k order, so at a width that both take the
// outputs are bitwise gm_*'s. Two panel buffers, filled with cp.async: while
// the block runs one panel it loads the next of the tile's fixed sequence
// (the next k panel, the next chunk's first, the next product's first, and
// after the tile's last product the next tile's first), one barrier pair a
// panel (gp_prod). The block's warps run their tiles together (gw_items
// with SYNC): a warp with no tile left runs padding tiles (nv = 0) through
// the barriers.
//
// What bounds the widths these tiles take: one warp's area of the dense
// backward with gx (rbf and activation fragments, 32 (Rq + Fq) bytes, the
// item's gx rows 16 Fq, the W cut staging, the ring) beside the two panel
// buffers (18,432 B), b0 and the offsets: F up to 4,048 at R 8 and 3,920
// at R 200 (ops/cfconv_general.py mma_layout). Wider bf16 widths stay on
// the CUDA-core kernels (the "wide" family). What bounds them on the card:
// the MMAs, at the bf16 peak, as gm_*'s; the panels add the weights' bytes
// from L2 once per block and tile (230 KB a forward tile at F 256 R 200,
// shared by up to 12 warps' 16 pairs each).

constexpr int GP_TIER = 3;              // the tier code of these kernels
constexpr int GP_KP = 64;               // k rows (or columns) of a panel
constexpr int GP_LD = GM_CW + 8;        // a panel's bf16 row stride
static_assert(GP_KP == GM_CW, "one square panel shape serves w and w^T");
constexpr int GP_PANEL = GP_KP * GP_LD;  // bf16 of one panel buffer

// A panel: nr rows x nc columns (nc a multiple of 8) of a weight at w.
struct GpPanel {
  const __nv_bfloat16* w;
  int nr, nc;
};

// The block's panel stream: the two buffers, the weights' row stride (Fq)
// and the count of panels run (its parity: the buffer of the next one).
struct GpStream {
  __nv_bfloat16* buf;
  int ld, q;
};

// The block's weights: w0 [Rq][Fq] and w1 [Fq][Fq] bf16 in device memory,
// b0 and the offsets in shared memory, and the start of the warps' areas.
struct GpW {
  const __nv_bfloat16* w0;
  const __nv_bfloat16* w1;
  const float* b0;
  const float* off;
  unsigned char* areas;
};

// The panel at column chunk c0 and k panel k0 of a product over K k and N
// columns: TRANS, w[k0 ..][c0 ..] (B = w); else w[c0 ..][k0 ..] (B = w^T).
template <bool TRANS>
__device__ __forceinline__ GpPanel gp_panel(const __nv_bfloat16* w, int ld,
                                            int K, int N, int c0, int k0) {
  const int kn = min(GP_KP, K - k0), cn = min(GM_CW, N - c0);
  GpPanel p;
  p.w = TRANS ? w + (size_t)k0 * ld + c0 : w + (size_t)c0 * ld + k0;
  p.nr = TRANS ? kn : cn;
  p.nc = TRANS ? cn : kn;
  return p;
}

// The first panel of a tile: a0's, w0[0 ..][0 ..].
__device__ __forceinline__ GpPanel gp_first(const GmArgs& a) {
  return gp_panel<true>(a.w0, a.Fq, a.Rq, a.Fq, 0, 0);
}

// Copies panel p into dst [p.nr][GP_LD] with every thread of the block;
// one cp.async group (empty where p.nr = 0).
__device__ __forceinline__ void gp_load(__nv_bfloat16* dst, const GpPanel& p,
                                        int ld) {
  const int c8 = p.nc >> 3, n = p.nr * c8;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int row = e / c8, c = e - row * c8;
    cp_async16(dst + row * GP_LD + 8 * c, p.w + (size_t)row * ld + 8 * c);
  }
  cp_async_commit();
}

// A product through the stream: for each column chunk c0 of [cb, ce) (a
// multiple of GM_CW from cb; N the product's columns), acc = A times B
// over k-steps 0 .. K / 16 - 1 in order, A = afrag(ks) (the lane's uint4),
// B from the panels of w as gp_panel<TRANS> cuts them and gm_kstep<TRANS>
// reads them; begin(c0) before a chunk's first panel, epi(acc, c0, np_end)
// after its last one. With !run (a padding tile) the warp only joins the
// barriers. On entry the product's first panel is loading into buffer
// st.q & 1; on return `next` is.
template <bool TRANS, typename AF, typename Begin, typename Epi>
__device__ __forceinline__ void gp_prod(const __nv_bfloat16* w, int K, int N,
                                        int cb, int ce, const GpPanel& next,
                                        GpStream& st, bool run, int lane,
                                        AF afrag, Begin begin, Epi epi) {
  const int nkp = (K + GP_KP - 1) / GP_KP;
#pragma unroll 1
  for (int c0 = cb; c0 < ce; c0 += GM_CW) {
    const int np_end = gm_np_end(N, c0);
    float acc[GM_NT][4];
    gm_zero(acc);
    if (run) begin(c0);
#pragma unroll 1
    for (int kp = 0; kp < nkp; ++kp) {
      const int k0 = kp * GP_KP;
      const GpPanel nx =
          kp + 1 < nkp ? gp_panel<TRANS>(w, st.ld, K, N, c0, k0 + GP_KP)
          : c0 + GM_CW < ce ? gp_panel<TRANS>(w, st.ld, K, N, c0 + GM_CW, 0)
                            : next;
      gp_load(st.buf + ((st.q + 1) & 1) * GP_PANEL, nx, st.ld);
      cp_async_wait<1>();
      __syncthreads();  // this panel is in every thread's view
      if (run) {
        const __nv_bfloat16* b = st.buf + (st.q & 1) * GP_PANEL;
        const int nks = min(GP_KP, K - k0) >> 4;
#pragma unroll 1
        for (int ks = 0; ks < nks; ++ks) {
          const uint4 v = afrag((k0 >> 4) + ks);
          const unsigned a[4] = {v.x, v.y, v.z, v.w};
          gm_kstep<TRANS>(acc, a, b, GP_LD, 16 * ks, np_end, lane);
        }
      }
      __syncthreads();  // the buffer is read before it is loaded again
      ++st.q;
    }
    if (run) epi(acc, c0, np_end);
  }
}

// Stages b0 and the offsets behind the two panel buffers, starts loading
// the first tile's first panel, and returns where everything lies.
__device__ __forceinline__ GpW gp_stage(float4* smem, const GmArgs& a,
                                        GpStream& st) {
  __nv_bfloat16* buf = reinterpret_cast<__nv_bfloat16*>(smem);
  float* b0_s = reinterpret_cast<float*>(buf + 2 * GP_PANEL);
  float* off_s = b0_s + a.Fq;
  for (int e = threadIdx.x; e < a.Fq; e += blockDim.x) b0_s[e] = a.b0[e];
  for (int e = threadIdx.x; e < a.Rq; e += blockDim.x) off_s[e] = a.off[e];
  __syncthreads();
  st.buf = buf;
  st.ld = a.Fq;
  st.q = 0;
  gp_load(buf, gp_first(a), a.Fq);
  GpW w;
  w.w0 = a.w0;
  w.w1 = a.w1;
  w.b0 = b0_s;
  w.off = off_s;
  w.areas = reinterpret_cast<unsigned char*>(off_s + a.Rq);
  return w;
}

// One forward tile with the weights streamed: gm_fwd_tile's steps (nv may
// be 0: a padding tile). rbf_f, then a0 = tanh(rbf w0 + b0) per column
// chunk into act_f, then per chunk W = a0 w1 and rows_s rows += (W cut)
// src_j in ring order (gm_wcut_sum; v_s over rbf_f).
__device__ __forceinline__ void gp_fwd_tile(
    const int* ring, int head, int nv, int r0, const float* pos,
    const float* src, uint4* rbf_f, uint4* act_f, float* v_s, float* rows_s,
    float coeff, const GmArgs& a, const GpW& w, GpStream& st, int lane) {
  const bool run = nv > 0;
  const int gq = lane >> 2, Fq = a.Fq;
  float d[2] = {0.0f, 0.0f}, cut[2] = {0.0f, 0.0f};
  unsigned rows = 0;
  if (run) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = gq + 8 * h;
      const bool ok = t < nv;
      const int ent = ok ? ring[(head + t) & (DM_RING - 1)] : 0;
      float dcut, rel[3];
      pair_geom(pos + (r0 + (ent >> 16)) * 3, pos + (ent & 0xffff) * 3, ok,
                a.rcut, a.arg_scale, a.dcut_scale, d[h], cut[h], dcut, rel);
    }
    rows = gm_ring_rows(ring, head, nv);
    gm_rbf(rbf_f, d, cut, w.off, coeff, a.R, a.Rq >> 4, lane);
  }
  auto noop = [](int) {};
  gp_prod<true>(
      w.w0, a.Rq, Fq, 0, Fq, gp_panel<true>(w.w1, Fq, Fq, Fq, 0, 0), st,
      run, lane, [&](int ks) { return rbf_f[32 * ks + lane]; }, noop,
      [&](auto& acc, int c0, int np_end) {
        gm_tanh_b0(acc, w.b0, c0, np_end, lane);
        gm_store_afrag(act_f, acc, c0, np_end, lane);
      });
  if (run) __syncwarp();  // rbf_f is read before v_s takes its place
  float sp[2][GW_TILE];
  gp_prod<true>(
      w.w1, Fq, Fq, 0, Fq, gp_first(a), st, run, lane,
      [&](int ks) { return act_f[32 * ks + lane]; },
      [&](int c0) { gm_load_src(sp, ring, head, nv, src, c0, Fq, lane); },
      [&](auto& acc, int c0, int np_end) {
        gm_wcut_sum(acc, cut, sp, v_s, rows, nv, c0, np_end, rows_s, Fq,
                    lane);
      });
}

// One backward tile with the weights streamed: gm_bwd_tile's steps and
// sums (nv may be 0: a padding tile). a0 (with a.keep_a0 also its float32
// copy in a0_s); W = a0 w1 per chunk: s_cut and, GX, the gx rows; per
// column chunk a0 again (or from a0_s), ga0 = bf16((g_i x_j) cut) w1^T and
// gt0 = bf16(ga0 (1 - a0^2)) into act_f; grbf = gt0 w0^T per chunk of R:
// se, sg; gd.
template <bool GX, bool NBR>
__device__ __forceinline__ void gp_bwd_tile(
    const int* ring, int head, int nv, int r0, const float* pos,
    const int* idx, int stride, const float* x, const float* g,
    uint4* rbf_f, uint4* act_f, float4* a0_s, float* v_s, float* rows_s,
    float* gd, float coeff, const GmArgs& a, const GpW& w, GpStream& st,
    int lane) {
  static_assert(!(GX && NBR), "the neighbour-matrix gx runs over the CSR");
  const bool run = nv > 0, keep = a.keep_a0 != 0;
  const int gq = lane >> 2, tq = lane & 3, Fq = a.Fq, Rq = a.Rq;
  const int nkf = Fq >> 4;
  // this lane's pairs: tile rows gq (h = 0) and gq + 8 (h = 1)
  int gi_row[2] = {0, 0}, xj_row[2] = {0, 0}, ee[2] = {0, 0};
  float d[2] = {0.0f, 0.0f}, cut[2] = {0.0f, 0.0f}, dcut[2] = {0.0f, 0.0f};
  unsigned rows = 0;
  if (run) {
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
    gm_rbf(rbf_f, d, cut, w.off, coeff, a.R, Rq >> 4, lane);
    if (GX) rows = gm_ring_rows(ring, head, nv);
  }
  auto noop = [](int) {};
  auto rbf_a = [&](int ks) { return rbf_f[32 * ks + lane]; };
  auto act_a = [&](int ks) { return act_f[32 * ks + lane]; };
  // the first panel of column chunk c0's a0 again (or, keeping a0, of its
  // ga0), and that of grbf
  auto chunk_first = [&](int c0) {
    return keep ? gp_panel<false>(w.w1, Fq, Fq, Fq, c0, 0)
                : gp_panel<true>(w.w0, Fq, Rq, Fq, c0, 0);
  };
  const GpPanel grbf_first = gp_panel<false>(w.w0, Fq, Fq, Rq, 0, 0);

  // a0 = tanh(bf16(rbf) w0 + b0) into act_f (and a0_s)
  gp_prod<true>(w.w0, Rq, Fq, 0, Fq, gp_panel<true>(w.w1, Fq, Fq, Fq, 0, 0),
                st, run, lane, rbf_a, noop,
                [&](auto& acc, int c0, int np_end) {
                  gm_tanh_b0(acc, w.b0, c0, np_end, lane);
                  gm_store_afrag(act_f, acc, c0, np_end, lane);
                  if (keep) gm_keep_a0(a0_s, acc, c0, np_end, lane);
                });

  // W = bf16(a0) w1 per chunk: s_cut = sum_f (g_i W) x_j; with GX the gx rows
  float sc[2] = {0.0f, 0.0f};
  float sp[2][GW_TILE];
  gp_prod<true>(
      w.w1, Fq, Fq, 0, Fq, chunk_first(0), st, run, lane, act_a,
      [&](int c0) {
        if (GX) gm_load_src(sp, ring, head, nv, g, c0, Fq, lane);
      },
      [&](auto& acc, int c0, int np_end) {
#pragma unroll
        for (int nt = 0; nt < GM_NT; ++nt) {
          if (nt >= 2 * np_end) break;
          const int f = c0 + 8 * nt + 2 * tq;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 gv = *reinterpret_cast<const float2*>(
                g + (size_t)gi_row[h] * Fq + f);
            const float2 xv = *reinterpret_cast<const float2*>(
                x + (size_t)xj_row[h] * Fq + f);
            sc[h] += (gv.x * acc[nt][2 * h]) * xv.x;
            sc[h] += (gv.y * acc[nt][2 * h + 1]) * xv.y;
          }
        }
        if (GX)
          gm_wcut_sum(acc, cut, sp, v_s, rows, nv, c0, np_end, rows_s, Fq,
                      lane);
      });

  // per chunk: a0 (again or kept), ga0 = bf16((g_i x_j) cut) w1^T, gt0 =
  // bf16(ga0 (1 - a0^2)) into act_f in bf16(a0)'s place (W has read it).
  // The cotangent's x_j and g_i are loaded one k-step ahead, across chunks.
  float2 xv[4], gv[4];
  auto cot_load = [&](int ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = i & 1, k = 16 * ks + 8 * (i >> 1) + 2 * tq;
      xv[i] = *reinterpret_cast<const float2*>(x + (size_t)xj_row[h] * Fq + k);
      gv[i] = *reinterpret_cast<const float2*>(g + (size_t)gi_row[h] * Fq + k);
    }
  };
  if (run) cot_load(0);
  auto cot_a = [&](int ks) {
    unsigned af[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = cut[i & 1];
      af[i] = pack_bf16x2((gv[i].x * xv[i].x) * c, (gv[i].y * xv[i].y) * c);
    }
    cot_load(ks + 1 < nkf ? ks + 1 : 0);
    return make_uint4(af[0], af[1], af[2], af[3]);
  };
#pragma unroll 1
  for (int c0 = 0; c0 < Fq; c0 += GM_CW) {
    float a0[GM_NT][4];
    if (keep) {
      if (run) {
        const int np_end = gm_np_end(Fq, c0);
#pragma unroll
        for (int nt = 0; nt < GM_NT; ++nt) {
          if (nt >= 2 * np_end) break;
          const float4 v = a0_s[32 * ((c0 >> 3) + nt) + lane];
          a0[nt][0] = v.x;
          a0[nt][1] = v.y;
          a0[nt][2] = v.z;
          a0[nt][3] = v.w;
        }
      }
    } else {
      gp_prod<true>(w.w0, Rq, Fq, c0, c0 + 1,
                    gp_panel<false>(w.w1, Fq, Fq, Fq, c0, 0), st, run, lane,
                    rbf_a, noop, [&](auto& acc, int c, int np_end) {
                      gm_tanh_b0(acc, w.b0, c, np_end, lane);
#pragma unroll
                      for (int nt = 0; nt < GM_NT; ++nt)
#pragma unroll
                        for (int e = 0; e < 4; ++e) a0[nt][e] = acc[nt][e];
                    });
    }
    gp_prod<false>(w.w1, Fq, Fq, c0, c0 + 1,
                   c0 + GM_CW < Fq ? chunk_first(c0 + GM_CW) : grbf_first, st,
                   run, lane, cot_a, noop,
                   [&](auto& ga, int c, int np_end) {
#pragma unroll
                     for (int nt = 0; nt < GM_NT; ++nt) {
                       if (nt >= 2 * np_end) break;
#pragma unroll
                       for (int e = 0; e < 4; ++e)
                         ga[nt][e] *= 1.0f - a0[nt][e] * a0[nt][e];
                     }
                     gm_store_afrag(act_f, ga, c, np_end, lane);
                   });
  }

  // grbf = bf16(gt0) w0^T in chunks of 64 radial functions; se, sg
  float se[2] = {0.0f, 0.0f}, sg[2] = {0.0f, 0.0f};
  gp_prod<false>(
      w.w0, Fq, Rq, 0, Rq, gp_first(a), st, run, lane, act_a, noop,
      [&](auto& acc, int rc0, int np_end) {
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
      });
  if (!run) return;

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

// The body of a streamed forward-tile kernel: gw_items (SYNC) over
// gp_fwd_tile; out [S][A][Fq]. The warp's area as gm_fwd_items lays it out.
template <typename Span, typename Vote>
__device__ __forceinline__ void gp_fwd_items(float4* smem,
                                             const float* __restrict__ pos,
                                             const float* __restrict__ src,
                                             float* __restrict__ out, int S,
                                             int A, const GmArgs& a,
                                             Span span, Vote vote) {
  GpStream st;
  const GpW w = gp_stage(smem, a, st);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, Fq = a.Fq;
  unsigned char* area = w.areas + (size_t)warp * a.warp_bytes;
  const int lead = max(32 * a.Rq, 4 * GW_TILE * GM_LDV);
  uint4* rbf_f = reinterpret_cast<uint4*>(area);          // [Rq / 16][32]
  float* v_s = reinterpret_cast<float*>(area);            // [16][GM_LDV]
  uint4* act_f = reinterpret_cast<uint4*>(area + lead);   // [Fq / 16][32]
  float* rows_s = reinterpret_cast<float*>(area + lead + 32 * Fq);
  int* ring = reinterpret_cast<int*>(rows_s + DM_RW * Fq);  // [DM_RING]
  const float coeff = *a.coeff;
  gw_items<true, true>(
      S, A, Fq, rows_s, ring, out, pos, span, vote,
      [&](int head, int nv, int r0, int s, const float* ps) {
        gp_fwd_tile(ring, head, nv, r0, ps, src + (size_t)s * A * Fq, rbf_f,
                    act_f, v_s, rows_s, coeff, a, w, st, lane);
      });
  cp_async_wait<0>();  // the last tile's prefetch of a tile that never came
}

// Forward, all pairs, weights streamed (gw_dense_fwd_kernel's vote).
__global__ void __launch_bounds__(GM_FWD_MAX_WARPS * 32, 1)
gp_dense_fwd_kernel(const float* __restrict__ pos,
                    const float* __restrict__ x, float* __restrict__ out,
                    int S, int A, GmArgs a) {
  extern __shared__ float4 gw_smem4[];
  gp_fwd_items(gw_smem4, pos, x, out, S, A, a, dense_span(A),
               dense_vote(a.rcut, a.arg_scale, a.dcut_scale));
}

// Forward, neighbour matrix, weights streamed (gw_nbr_fwd_kernel's vote).
__global__ void __launch_bounds__(GM_FWD_MAX_WARPS * 32, 1)
gp_nbr_fwd_kernel(const float* __restrict__ pos, const float* __restrict__ x,
                  const int* __restrict__ idx,
                  const unsigned char* __restrict__ mask,
                  float* __restrict__ out, int S, int A, int K, GmArgs a) {
  extern __shared__ float4 gw_smem4[];
  gp_fwd_items(gw_smem4, pos, x, out, S, A, a, nbr_span(K),
               nbr_vote(idx, mask, A, K, a.rcut, a.arg_scale, a.dcut_scale));
}

// Backward, gx pass of the neighbour matrix over the source CSR, W computed
// again, weights streamed (gw_nbr_gx_kernel's walk).
__global__ void __launch_bounds__(GM_FWD_MAX_WARPS * 32, 1)
gp_nbr_gx_kernel(const float* __restrict__ pos,
                 const int* __restrict__ offsets,
                 const int* __restrict__ slots, const float* __restrict__ g,
                 float* __restrict__ gx, int S, int A, int K, GmArgs a) {
  extern __shared__ float4 gw_smem4[];
  gp_fwd_items(gw_smem4, pos, g, gx, S, A, a, csr_span(offsets, A),
               csr_vote(slots, A, K, a.rcut, a.arg_scale, a.dcut_scale));
}

// Backward, first pass, weights streamed: gw_bwd_kernel's vote and gd = 0
// writes, gw_bwd_mma_kernel's warp area, through gp_bwd_tile.
template <bool GX, bool NBR>
__global__ void __launch_bounds__(
    (GX ? GM_BWD_GX_MAX_WARPS : GM_BWD_MAX_WARPS) * 32, 1)
gp_bwd_kernel(const float* __restrict__ pos, const int* __restrict__ idx,
              const unsigned char* __restrict__ mask,
              const float* __restrict__ x, const float* __restrict__ g,
              float* __restrict__ gd, float* __restrict__ gx, int S, int A,
              int K, GmArgs a) {
  extern __shared__ float4 gw_smem4[];
  GpStream st;
  const GpW w = gp_stage(gw_smem4, a, st);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, Fq = a.Fq;
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
  gw_items<true, GX>(
      S, A, Fq, rows_s, ring, gx, pos, [=](int, int) {
        return make_int2(0, stride);
      },
      bwd_vote<NBR>(idx, mask, gd, A, K, a.rcut, a.arg_scale, a.dcut_scale),
      [&](int head, int nv, int r0, int s, const float* ps) {
        gp_bwd_tile<GX, NBR>(
            ring, head, nv, r0, ps, NBR ? idx + (size_t)s * A * K : nullptr,
            stride, x + (size_t)s * A * Fq, g + (size_t)s * A * Fq, rbf_f,
            act_f, a0_s, v_s, rows_s, gd + (size_t)s * A * stride, coeff, a,
            w, st, lane);
      });
  cp_async_wait<0>();
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

// Bytes of the streamed tiles' block beside its warps' areas: the two
// panel buffers, b0 and the offsets.
long gp_weight_bytes(int Fq, int Rq) {
  return 2L * 2 * GP_PANEL + 4L * (Fq + Rq);
}

// mma_shape of the tiles with the weights streamed in panels (gp_*).
bool gp_shape(int kind, int Fq, int Rq, int& warps, int& smem, bool& keep) {
  return mma_shape(gp_weight_bytes(Fq, Rq), kind, Fq, Rq, warps, smem, keep);
}

// The tensor-core tiles' layout of a width: GF_STAGED where the whole
// weights and one warp of the dense backward with gx fit in a block
// (gm_*), GF_PANELS where the two panel buffers and one such warp do
// (gp_*), else GF_NONE (the CUDA-core kernels). ops/cfconv_general.py
// mma_layout.
int gm_layout(int Fq, int Rq) {
  int warps, smem;
  bool keep;
  if (gm_shape(GM_BWD_GX, Fq, Rq, warps, smem, keep)) return GF_STAGED;
  if (gp_shape(GM_BWD_GX, Fq, Rq, warps, smem, keep)) return GF_PANELS;
  return GF_NONE;
}

// Launches `kernel` with the warps and shared memory of gm_shape (layout
// GF_STAGED) or gp_shape (GF_PANELS) for `kind`; `args` points at `a`,
// whose warp_bytes and keep_a0 are set here for the launch.
template <typename K>
cudaError_t gm_launch(K kernel, int kind, int layout, GmArgs& a, int n_items,
                      cudaStream_t stream, void** args) {
  int warps, smem;
  bool keep;
  const bool ok = layout == GF_PANELS
                      ? gp_shape(kind, a.Fq, a.Rq, warps, smem, keep)
                      : gm_shape(kind, a.Fq, a.Rq, warps, smem, keep);
  if (!ok) return cudaErrorInvalidValue;
  a.keep_a0 = keep ? 1 : 0;
  a.warp_bytes = (int)gm_warp_bytes(kind, a.Fq, a.Rq, keep);
  return launch_persistent(kernel, warps, smem, n_items, stream, args);
}

}  // namespace

extern "C" {

// Forward on the tensor cores (cfconv_general_fwd's tiers 2 and 3): nbr 0
// all pairs, 1 the neighbour matrix idx / mask [S, A, K]; x and out [S, A,
// Fq], w0 [Rq][Fq] and w1 [Fq][Fq] bf16, b0 [Fq] and off [Rq] float32 (Fq,
// Rq: F, R rounded up to 16). Tier 2 is refused where the weights do not
// fit in shared memory (gm_shape), tier 3 where the panels find no room
// (gp_shape).
int cfconv_general_mma_fwd(int nbr, const float* pos, const int* idx,
                           const unsigned char* mask, const float* x,
                           const float* w0, const float* b0,
                           const float* w1, const float* off,
                           const float* coeff, float* out, int S, int A,
                           int K, int Fq, int R, int Rq, float rcut, int tier,
                           void* stream) {
  if (tier != GM_TIER && tier != GP_TIER) return (int)cudaErrorInvalidValue;
  const int n_items = S * ((A + DM_RW - 1) / DM_RW);
  cudaStream_t st = (cudaStream_t)stream;
  if (!gm_sizes_ok(nbr, S, A, K, Fq, R, Rq))
    return (int)cudaErrorInvalidValue;
  GmArgs m = gm_args(w0, w1, b0, off, coeff, Fq, R, Rq, rcut);
  const bool pn = tier == GP_TIER;
  const int layout = pn ? GF_PANELS : GF_STAGED;
  if (nbr) {
    void* args[] = {&pos, &x, &idx, &mask, &out, &S, &A, &K, &m};
    return (int)gm_launch(pn ? gp_nbr_fwd_kernel : gw_nbr_fwd_mma_kernel,
                          GM_FWD, layout, m, n_items, st, args);
  }
  void* args[] = {&pos, &x, &out, &S, &A, &m};
  return (int)gm_launch(pn ? gp_dense_fwd_kernel : gw_dense_fwd_mma_kernel,
                        GM_FWD, layout, m, n_items, st, args);
}

// Backward on the tensor cores (cfconv_general_bwd's tiers 2 and 3): gd,
// gpos, gx and the source CSR as cfconv_general_bwd takes them, the
// weights as cfconv_general_mma_fwd.
int cfconv_general_mma_bwd(int nbr, const float* pos, const int* idx,
                           const unsigned char* mask, const int* csr_offsets,
                           const int* csr_slots, const float* x,
                           const float* g, const float* w0, const float* b0,
                           const float* w1, const float* off,
                           const float* coeff, float* gd, float* gpos,
                           float* gx, int S, int A, int K, int Fq, int R,
                           int Rq, float rcut, int tier, void* stream) {
  if (tier != GM_TIER && tier != GP_TIER) return (int)cudaErrorInvalidValue;
  const int n_items = S * ((A + DM_RW - 1) / DM_RW);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (!gm_sizes_ok(nbr, S, A, K, Fq, R, Rq))
    return (int)cudaErrorInvalidValue;
  GmArgs m = gm_args(w0, w1, b0, off, coeff, Fq, R, Rq, rcut);
  const bool pn = tier == GP_TIER;
  const int layout = pn ? GF_PANELS : GF_STAGED;
  void* args[] = {&pos, &idx, &mask, &x, &g, &gd, &gx, &S, &A, &K, &m};
  if (nbr)
    err = gm_launch(pn ? gp_bwd_kernel<false, true>
                       : gw_bwd_mma_kernel<false, true>,
                    GM_BWD, layout, m, n_items, st, args);
  else if (gx)
    err = gm_launch(pn ? gp_bwd_kernel<true, false>
                       : gw_bwd_mma_kernel<true, false>,
                    GM_BWD_GX, layout, m, n_items, st, args);
  else
    err = gm_launch(pn ? gp_bwd_kernel<false, false>
                       : gw_bwd_mma_kernel<false, false>,
                    GM_BWD, layout, m, n_items, st, args);
  if (err != cudaSuccess) return (int)err;
  if (!nbr) return dense_cfconv_gpos(pos, gd, gpos, S, A, stream);
  int rc = cfconv_gpos(pos, idx, mask, csr_offsets, csr_slots, gd, gpos, S,
                       A, K, stream);
  if (rc != 0 || gx == nullptr) return rc;
  void* gargs[] = {&pos, &csr_offsets, &csr_slots, &g, &gx, &S, &A, &K, &m};
  return (int)gm_launch(pn ? gp_nbr_gx_kernel : gw_nbr_gx_mma_kernel,
                        GM_FWD, layout, m, n_items, st, gargs);
}

// The tensor-core tiles' layout at Fq, Rq (F, R rounded up to 16): 0 the
// weights staged whole in each block (tier 2, gw_*_mma_kernel), 1 streamed
// in panels (tier 3, gp_*_kernel), -1 neither (the CUDA-core kernels).
int cfconv_general_mma_layout(int Fq, int Rq) { return gm_layout(Fq, Rq); }

// Warps a block of the tensor-core kernel of `kind` (0 the forward and the
// gx pass, 1 a backward, 2 the dense backward with gx) in that layout, or
// -1 where there is none.
int cfconv_general_mma_warps(int kind, int Fq, int Rq) {
  int warps, smem;
  bool keep;
  const int layout = gm_layout(Fq, Rq);
  if (layout == GF_NONE) return -1;
  if (layout == GF_PANELS) gp_shape(kind, Fq, Rq, warps, smem, keep);
  else gm_shape(kind, Fq, Rq, warps, smem, keep);
  return warps;
}

}  // extern "C"
