// The k-nearest-neighbour selection of knn.cu (#4), shared with the kNN +
// gather kernel knn_group.cu (#9): k nearest by squared distance, ascending,
// ties to the lowest index, for any 1 <= k <= N.
//
// G lanes a query (G = 1, 2, 4 or 8), kSelectThreads threads a block, every
// query of a block in one batch row, whose points are staged in shared
// memory as x / y / z arrays in tiles of kSelectTile.  Lane l of a query
// takes points l, l + G, l + 2G, ... in ascending index and keeps its own
// sorted best L (distance, index) pairs in registers (L = 1, 2, 4, 8, 16 or
// 32); a point enters only on a strict <, so an equal distance never
// displaces a lower index.  The group then takes k rounds of a
// lexicographic (distance, index) minimum over the lanes' heads, the
// winning lane popping its head: exactly the ascending stable sort of the
// plain version.  k > 32 runs ceil(k / 32) such passes of L = 32 over the
// points, each keeping only the pairs after the last one emitted,
// (d, i) > (d_last, i_last) lexicographically.
#pragma once

#include <climits>
#include <type_traits>

#include "common.cuh"

namespace pdr_select {

constexpr int kSelectThreads = 256;
constexpr int kSelectTile = 2048;  // points staged a tile (24 KB)

// (d, i) < (od, oi) lexicographically
__device__ __forceinline__ bool pair_less(float d, int i, float od, int oi) {
  return d < od || (d == od && i < oi);
}

// Lane `lane` of a group takes points lane, lane + G, ... of the staged tile
// [0, n) into its sorted best L; kAbove keeps only pairs after (lo_d, lo_i).
template <int L, int G, bool kAbove>
__device__ __forceinline__ void scan_tile(const float* sx, const float* sy, const float* sz,
                                          int n, int base, int lane, float qx, float qy,
                                          float qz, float lo_d, int lo_i, float (&bd)[L],
                                          int (&bi)[L]) {
  for (int i = lane; i < n; i += G) {
    const float d = pdr_sqdist3(qx, qy, qz, sx[i], sy[i], sz[i]);
    const int gi = base + i;
    if (d < bd[L - 1] && (!kAbove || d > lo_d || (d == lo_d && gi > lo_i))) {
      bd[L - 1] = d;
      bi[L - 1] = gi;
#pragma unroll
      for (int s = L - 1; s > 0; --s) {
        if (bd[s] < bd[s - 1]) {
          const float tv = bd[s];
          bd[s] = bd[s - 1];
          bd[s - 1] = tv;
          const int ti = bi[s];
          bi[s] = bi[s - 1];
          bi[s - 1] = ti;
        }
      }
    }
  }
}

// The k nearest of the N points `pts` (one batch row, (N, 3) float32) to
// (qx, qy, qz), in ascending order: emit(j, d, i) for j = 0 .. k-1, called
// by every lane of the group with the same values.  Every thread of the
// block calls it (a query past the end computes on a valid row and emits
// nothing of its own); sx / sy / sz are kSelectTile floats each of shared
// memory.
template <int L, int G, typename Emit>
__device__ __forceinline__ void select(const float* __restrict__ pts, int N, int k, int lane,
                                       float qx, float qy, float qz, float* sx, float* sy,
                                       float* sz, Emit&& emit) {
  const int ntiles = (N + kSelectTile - 1) / kSelectTile;
  float lo_d = -1.f;  // the last pair emitted; every distance is >= 0
  int lo_i = -1;
  for (int done = 0; done < k; done += L) {
    float bd[L];
    int bi[L];
#pragma unroll
    for (int s = 0; s < L; ++s) {
      bd[s] = INFINITY;
      bi[s] = INT_MAX;
    }
    for (int t = 0; t < ntiles; ++t) {
      const int base = t * kSelectTile;
      const int n = min(kSelectTile, N - base);
      if (ntiles > 1 || done == 0) {  // block-uniform
        __syncthreads();
        for (int f = threadIdx.x; f < 3 * n; f += kSelectThreads) {
          const float v = pts[static_cast<size_t>(base) * 3 + f];
          const int i = f / 3;
          const int c = f - 3 * i;
          (c == 0 ? sx : c == 1 ? sy : sz)[i] = v;
        }
        __syncthreads();
      }
      if (done == 0) {
        scan_tile<L, G, false>(sx, sy, sz, n, base, lane, qx, qy, qz, lo_d, lo_i, bd, bi);
      } else {
        scan_tile<L, G, true>(sx, sy, sz, n, base, lane, qx, qy, qz, lo_d, lo_i, bd, bi);
      }
    }
    const int take = min(L, k - done);
    for (int j = 0; j < take; ++j) {
      float md = bd[0];
      int mi = bi[0];
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) {
        const float pd = __shfl_xor_sync(PDR_FULL_MASK, md, off);
        const int pi = __shfl_xor_sync(PDR_FULL_MASK, mi, off);
        if (pair_less(pd, pi, md, mi)) {
          md = pd;
          mi = pi;
        }
      }
      if (bi[0] == mi) {  // the winner (indices are unique) pops its head
#pragma unroll
        for (int s = 0; s < L - 1; ++s) {
          bd[s] = bd[s + 1];
          bi[s] = bi[s + 1];
        }
        bd[L - 1] = INFINITY;
        bi[L - 1] = INT_MAX;
      }
      emit(done + j, md, mi);
      lo_d = md;
      lo_i = mi;
    }
  }
}

// f(integral_constant<L>, integral_constant<G>) for the list length L that
// k needs and the lane count `lanes` (1, 2, 4 or 8); false for another
// lane count.
template <typename F>
bool dispatch(int lanes, int k, F&& f) {
  auto with_l = [&](auto g) {
    if (k <= 1) {
      f(std::integral_constant<int, 1>{}, g);
    } else if (k <= 2) {
      f(std::integral_constant<int, 2>{}, g);
    } else if (k <= 4) {
      f(std::integral_constant<int, 4>{}, g);
    } else if (k <= 8) {
      f(std::integral_constant<int, 8>{}, g);
    } else if (k <= 16) {
      f(std::integral_constant<int, 16>{}, g);
    } else {
      f(std::integral_constant<int, 32>{}, g);
    }
  };
  switch (lanes) {
    case 1:
      with_l(std::integral_constant<int, 1>{});
      return true;
    case 2:
      with_l(std::integral_constant<int, 2>{});
      return true;
    case 4:
      with_l(std::integral_constant<int, 4>{});
      return true;
    case 8:
      with_l(std::integral_constant<int, 8>{});
      return true;
    default:
      return false;
  }
}

}  // namespace pdr_select
