// Device code shared by the general-width exact-filter kernels of
// cfconv_general_kernels.cu (the CUDA-core tiers and the entry points) and
// cfconv_general_mma_kernels.cu (the tensor-core tiers): the item loop with
// its spans and votes, cp.async, the weights' layout codes. Two sources so
// that ops/_build.py's nvcc processes (one a source, started together)
// compile the two tiers at once.
#pragma once

#include "cfconv_tile.cuh"

namespace {

constexpr int GW_TILE = 16;          // ring entries per tile
constexpr int GW_SMEM_MAX = 232448;  // shared memory a block may hold
// The weights' layouts: staged whole in each block, streamed through it in
// panels, neither (weights from L1/L2, or no tensor-core tile).
enum { GF_STAGED = 0, GF_PANELS = 1, GF_NONE = -1 };

// The item loop of every general-width kernel. Each warp owns work items
// of DM_RW rows of one molecule s. For each row i it walks the entries e
// of span(s, i) = [begin, end), 32 at a time, and vote(s, ps, i, e, j) (ps:
// the molecule's positions) says whether entry e is live and sets its
// low bits j; the live ones enter the warp's ring as (i - r0) << 16 | j,
// and every 16 of them, then an item's tail, run through tile(head, nv,
// r0, s, ps). With ROWS the item's rows rows_s [DM_RW][fw] start at zero
// and are stored to out [S][A][fw] when its last tile has run (rows with
// no live entry as zeros). With SYNC the block's warps run their tiles
// together, one __syncthreads_or a tile: a warp with no tile left runs
// padding tiles (nv = 0) until every warp is done, so that the tiles may
// share the block's barriers.
template <bool SYNC, bool ROWS, typename Span, typename Vote, typename Tile>
__device__ __forceinline__ void gw_items(int S, int A, int fw, float* rows_s,
                                         int* ring, float* __restrict__ out,
                                         const float* __restrict__ pos,
                                         Span span, Vote vote, Tile tile) {
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_groups = (A + DM_RW - 1) / DM_RW;
  const int n_items = S * n_groups;
  int item = blockIdx.x * warps + warp;
  int s = 0, r0 = 0, rr = 0, eb = 0, ee = 0, head = 0, tail = 0;
  const float* ps = pos;
  auto open = [&]() {
    s = item / n_groups;
    r0 = (item - s * n_groups) * DM_RW;
    ps = pos + (size_t)s * A * 3;
    rr = head = tail = 0;
    const int2 range = span(s, r0);
    eb = range.x;
    ee = range.y;
    if (ROWS) {
      for (int e = lane; e < DM_RW * fw; e += 32) rows_s[e] = 0.0f;
      __syncwarp();
    }
  };
  if (item < n_items) open();
  while (true) {
    int nv = 0;  // the next tile's entries; 0: this warp is done
    while (item < n_items) {
      if (tail - head >= GW_TILE) {
        nv = GW_TILE;
        break;
      }
      if (rr < DM_RW && r0 + rr < A) {
        if (eb < ee) {
          const int e = eb + lane;
          int j = 0;
          const bool live = e < ee && vote(s, ps, r0 + rr, e, j);
          tail = ring_push(ring, tail, live, (rr << 16) | j, lane);
          eb += 32;
        } else if (++rr < DM_RW && r0 + rr < A) {
          const int2 range = span(s, r0 + rr);
          eb = range.x;
          ee = range.y;
        }
        continue;
      }
      if (tail > head) {
        nv = tail - head;
        break;
      }
      if (ROWS) {
        float* os = out + (size_t)s * A * fw;
        for (int e = 4 * lane; e < DM_RW * fw; e += 128) {
          const int i = r0 + e / fw;
          if (i < A)
            *reinterpret_cast<float4*>(os + (size_t)i * fw + e % fw) =
                *reinterpret_cast<const float4*>(rows_s + e);
        }
        __syncwarp();  // rows_s is read before the next item writes
      }
      item += gridDim.x * warps;
      if (item < n_items) open();
    }
    if (SYNC) {
      if (!__syncthreads_or(nv > 0)) break;
    } else if (nv == 0) {
      break;
    }
    tile(head, nv, r0, s, ps);
    head += nv;
  }
}

// The spans and votes of the three forward-tile kernels and the first
// passes. Dense: every partner j of row i, live at j != i, d < rc.
__device__ __forceinline__ auto dense_span(int A) {
  return [=](int, int) { return make_int2(0, A); };
}
__device__ __forceinline__ auto dense_vote(float rcut, float arg_scale,
                                           float dcut_scale) {
  return [=](int, const float* ps, int i, int e, int& j) {
    j = e;
    float d, cut, dcut, rel[3];
    return pair_geom(ps + i * 3, ps + j * 3, j != i, rcut, arg_scale,
                     dcut_scale, d, cut, dcut, rel);
  };
}
// Neighbour matrix: every slot k of row i, live where its mask is set
// (read before idx) and d < rc; j = idx[i, k].
__device__ __forceinline__ auto nbr_span(int K) {
  return [=](int, int) { return make_int2(0, K); };
}
__device__ __forceinline__ auto nbr_vote(const int* __restrict__ idx,
                                         const unsigned char* __restrict__ mask,
                                         int A, int K, float rcut,
                                         float arg_scale, float dcut_scale) {
  return [=](int s, const float* ps, int i, int k, int& j) {
    const size_t slot = ((size_t)s * A + i) * K + k;
    if (!mask[slot]) return false;
    j = idx[slot];
    float d, cut, dcut, rel[3];
    return pair_geom(ps + i * 3, ps + j * 3, true, rcut, arg_scale,
                     dcut_scale, d, cut, dcut, rel);
  };
}
// The gx pass's source CSR: a's incoming slots (i, k) in order, j = i; d
// is that of p_i - p_a, bitwise the first pass's, so the live slots are
// the same.
__device__ __forceinline__ auto csr_span(const int* __restrict__ offsets,
                                         int A) {
  return [=](int s, int i) {
    return make_int2(offsets[s * A + i], offsets[s * A + i + 1]);
  };
}
__device__ __forceinline__ auto csr_vote(const int* __restrict__ slots, int A,
                                         int K, float rcut, float arg_scale,
                                         float dcut_scale) {
  return [=](int s, const float* ps, int i, int e, int& j) {
    j = slots[e] / K - s * A;
    float d, cut, dcut, rel[3];
    return pair_geom(ps + i * 3, ps + j * 3, true, rcut, arg_scale,
                     dcut_scale, d, cut, dcut, rel);
  };
}
// The first passes: every pair (dense, stride A) or slot (NBR, stride K)
// of row i, e itself as the entry's low bits; gd = 0 written for the dead
// ones (dense: j == i or d >= rc; NBR: masked or d >= rc).
template <bool NBR>
__device__ __forceinline__ auto bwd_vote(const int* __restrict__ idx,
                                         const unsigned char* __restrict__ mask,
                                         float* __restrict__ gd, int A, int K,
                                         float rcut, float arg_scale,
                                         float dcut_scale) {
  return [=](int s, const float* ps, int i, int e, int& j) {
    const int stride = NBR ? K : A;
    const float* pi = ps + i * 3;
    float d, cut, dcut, rel[3];
    bool live = false;
    j = e;
    if (NBR) {
      const size_t slot = ((size_t)s * A + i) * K + e;
      if (mask[slot])
        live = pair_geom(pi, ps + idx[slot] * 3, true, rcut, arg_scale,
                         dcut_scale, d, cut, dcut, rel);
    } else {
      live = pair_geom(pi, ps + e * 3, e != i, rcut, arg_scale, dcut_scale,
                       d, cut, dcut, rel);
    }
    if (!live) gd[((size_t)s * A + i) * stride + e] = 0.0f;
    return live;
  };
}

// cp.async of 16 bytes into shared memory (L2 only), its group commit and
// its wait for all but the newest N groups.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
