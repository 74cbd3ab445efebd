// Device code shared by the exact-filter CFConv kernels of
// cfconv_dense_kernels.cu (all pairs) and cfconv_kernels.cu (neighbour
// matrix): the 64-pair tile layout, the weight staging, the pair geometry
// and the float32-FMA tile product of the filter MLP.
//
// Tile layout: a block of THREADS threads owns ROWS destination rows and
// walks their partners in chunks of COLS, so one chunk is NP = ROWS * COLS
// pairs (p = row * COLS + col). Thread (pg = tid / 16, fg = tid % 16) holds
// pairs p0 = 4 pg .. p0 + 3 (all of row pg / 4) and features fg + 16 c.
//
// Precision tiers: BF16 rounds the operands of the products to bf16 (round
// to nearest even) through op<BF16>; everything else stays float32.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;
constexpr int F = 128;           // filters: the kernels take exactly 128
constexpr int FPT = F / 16;      // features per thread: f = fg + 16 c
constexpr int RMAX = 64;         // radial basis functions, at most
constexpr int ROWS = 4;          // destination rows per block
constexpr int COLS = 16;         // partners per row and chunk
constexpr int NP = ROWS * COLS;  // pairs per chunk: p = row * COLS + col
constexpr int LDW = F + 1;       // padded weight row stride
constexpr int LDA = NP + 4;      // padded pair stride of [k][pair] tiles

// w0_s [RMAX][LDW] and w1_s [F][LDW], in floats.
constexpr int W_FLOATS = RMAX * LDW + F * LDW;

const double PI = 3.14159265358979323846;

__device__ __forceinline__ float rnd_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool BF16>
__device__ __forceinline__ float op(float v) {
  return BF16 ? rnd_bf16(v) : v;
}

// Sum over the 16 lanes of a half warp; every lane gets the same bits.
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// w0 [R, F] -> w0_s [RMAX][LDW] (rows >= R zero), w1 [F, F] -> w1_s
// [F][LDW], both rounded in the bf16 tier; b0 and offsets as they are.
template <bool BF16>
__device__ void load_weights(const float* __restrict__ w0,
                             const float* __restrict__ b0,
                             const float* __restrict__ w1,
                             const float* __restrict__ offset, int R,
                             float* w0_s, float* w1_s, float* b0_s,
                             float* off_s) {
  for (int e = threadIdx.x; e < RMAX * F; e += THREADS) {
    int r = e / F, f = e % F;
    w0_s[r * LDW + f] = r < R ? op<BF16>(w0[r * F + f]) : 0.0f;
  }
  for (int e = threadIdx.x; e < F * F; e += THREADS)
    w1_s[(e / F) * LDW + e % F] = op<BF16>(w1[e]);
  for (int e = threadIdx.x; e < F; e += THREADS) b0_s[e] = b0[e];
  for (int e = threadIdx.x; e < RMAX; e += THREADS)
    off_s[e] = e < R ? offset[e] : 0.0f;
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

}  // namespace
