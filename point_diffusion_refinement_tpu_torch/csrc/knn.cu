// k nearest neighbours by squared distance, ascending, ties to the lowest
// index, for any 1 <= k <= N.
//
// Replaces the TPU kernel ops/pallas_neighbors.py::_knn_kernel (called by
// knn_pallas, pallas_neighbors.py:192).
//
// What bounds it on this card: operations, ~9 float ops per (query, point)
// pair for the distance plus the compare with the current k-th best.  With
// one thread a query (the first port) the level-0 feature propagation of a
// B=4 denoise step ran 64 blocks of 4 warps on 132 SMs, each thread walking
// all N points through a k-deep insertion chain: latency-bound with most
// of the card idle.
//
// Design: G lanes a query (G = 1, 2, 4 or 8, the caller's choice: more
// lanes where there are few queries to fill the card, one where there are
// many, since every lane pays its own insertions), 256 threads a block,
// every query of a block in one batch row, whose points are staged in
// shared memory as x / y / z arrays in tiles of kTile.  Lane l of a query
// takes points l, l + G, l + 2G, ... in ascending index and keeps its own
// sorted best L (distance, index) pairs in registers (L a template
// argument: 1, 2, 4, 8, 16 or 32); a point enters only on a strict <, so an
// equal distance never displaces a lower index.  The group then takes k
// rounds of a lexicographic (distance, index) minimum over the lanes'
// heads, the winning lane popping its head: exactly the ascending stable
// sort of the plain version.  k > 32 runs ceil(k / 32) such passes of
// L = 32 over the points, each keeping only the pairs after the last one
// written, (d, i) > (d_last, i_last) lexicographically.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;  // points staged a tile (24 KB)

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

template <int L, int G>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ query, const float* __restrict__ points, int M, int N,
           int k, float* __restrict__ dist, int* __restrict__ idx) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float sz[kTile];
  constexpr int kGroups = kThreads / G;
  const int lane = threadIdx.x % G;
  const int b = blockIdx.y;
  const int m = blockIdx.x * kGroups + threadIdx.x / G;
  // a query past M computes on the last row and writes nothing, so that
  // every lane of a warp takes part in the shuffles
  const size_t qrow = static_cast<size_t>(b) * M + min(m, M - 1);
  const float qx = query[qrow * 3];
  const float qy = query[qrow * 3 + 1];
  const float qz = query[qrow * 3 + 2];
  const float* pts = points + static_cast<size_t>(b) * N * 3;
  float* od = dist + qrow * k;
  int* oi = idx + qrow * k;
  const bool writes = m < M && lane == 0;
  const int ntiles = (N + kTile - 1) / kTile;

  float lo_d = -1.f;  // the last pair written; every distance is >= 0
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
      const int base = t * kTile;
      const int n = min(kTile, N - base);
      if (ntiles > 1 || done == 0) {  // block-uniform
        __syncthreads();
        for (int f = threadIdx.x; f < 3 * n; f += kThreads) {
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
      if (writes) {
        od[done + j] = md;
        oi[done + j] = mi;
      }
      lo_d = md;
      lo_i = mi;
    }
  }
}

template <int L, int G>
void launch(const float* q, const float* p, int B, int M, int N, int k, float* d, int* i,
            cudaStream_t stream) {
  constexpr int kGroups = kThreads / G;
  const dim3 grid((M + kGroups - 1) / kGroups, B);
  knn_kernel<L, G><<<grid, kThreads, 0, stream>>>(q, p, M, N, k, d, i);
}

template <int G>
void launch_lanes(const float* q, const float* p, int B, int M, int N, int k, float* d,
                  int* i, cudaStream_t s) {
  if (k <= 1) {
    launch<1, G>(q, p, B, M, N, k, d, i, s);
  } else if (k <= 2) {
    launch<2, G>(q, p, B, M, N, k, d, i, s);
  } else if (k <= 4) {
    launch<4, G>(q, p, B, M, N, k, d, i, s);
  } else if (k <= 8) {
    launch<8, G>(q, p, B, M, N, k, d, i, s);
  } else if (k <= 16) {
    launch<16, G>(q, p, B, M, N, k, d, i, s);
  } else {
    launch<32, G>(q, p, B, M, N, k, d, i, s);
  }
}

}  // namespace

// query (B, M, 3), points (B, N, 3) f32 -> dist (B, M, k) f32, idx (B, M, k)
// i32.  1 <= k <= N (checked by the caller); lanes a query: 1, 2, 4 or 8.
extern "C" int pdr_knn(const void* query, const void* points, int B, int M, int N, int k,
                       int lanes, void* dist, void* idx, void* stream) {
  const float* q = static_cast<const float*>(query);
  const float* p = static_cast<const float*>(points);
  float* d = static_cast<float*>(dist);
  int* i = static_cast<int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > N || M < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (lanes) {
    case 1:
      launch_lanes<1>(q, p, B, M, N, k, d, i, s);
      break;
    case 2:
      launch_lanes<2>(q, p, B, M, N, k, d, i, s);
      break;
    case 4:
      launch_lanes<4>(q, p, B, M, N, k, d, i, s);
      break;
    case 8:
      launch_lanes<8>(q, p, B, M, N, k, d, i, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  PDR_RETURN_LAUNCH_ERROR();
}
