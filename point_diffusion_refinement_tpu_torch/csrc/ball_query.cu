// Ball query: the first <= K support points with d^2 < r^2, in index order.
//
// Replaces the TPU kernel ops/pallas_neighbors.py::_ball_query_kernel
// (called by ball_query_pallas, pallas_neighbors.py:145).
//
// Semantics: strict d^2 < r^2; slots past the count repeat the first
// neighbour; an empty ball gives all zeros; counts are capped at K; K may
// exceed N (the count then stays <= N and the rest repeat the first).
//
// What bounds it on this card: operations, ~9 float ops per scanned
// (centre, point) pair; a centre stops scanning at its K-th neighbour, so
// the count depends on the data.  Bytes are small (a block's support row,
// 36 KB at 3072 points, is read from L2 once and then from L1).  In practice
// the bound is the length of each centre's scan, a chain of dependent
// 32-point steps: the work has to be spread over enough warps to fill the
// card.
//
// Design: one warp per centre, 8 centres of one batch row per block, a grid
// of (ceil(M / 8), B) blocks (512 at 1024 centres and B = 4).  The warp
// scans the support with pdr_warp_ball_scan (common.cuh, the scan of the
// fused ball group and of the fused ball query + gather, so all three give
// the same idx bit for bit): 32 points a step, a ballot and a popcount
// prefix place each hit straight into the centre's global idx row, and the
// scan stops at the first 32-point step in which the count reaches K.  The
// warp then fills the slots past the count with the first hit.  The support
// is read through the read-only path: the 8 centres of a block share one
// batch row, which L1 holds.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
ball_query_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
                  int N, int M, int K, float r2, int* __restrict__ idx,
                  int* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (m >= M) return;  // warp-uniform
  const size_t row = static_cast<size_t>(b) * M + m;
  const float qx = centers[row * 3];
  const float qy = centers[row * 3 + 1];
  const float qz = centers[row * 3 + 2];
  int* out = idx + row * K;
  int first;
  const int cnt = pdr_warp_ball_scan(xyz + static_cast<size_t>(b) * N * 3, N, qx, qy, qz,
                                     r2, K, out, lane, &first);
  for (int k = cnt + lane; k < K; k += 32) out[k] = first;
  if (lane == 0) counts[row] = cnt;
}

}  // namespace

// xyz (B, N, 3) f32, centers (B, M, 3) f32 -> idx (B, M, K) i32, counts (B, M) i32.
extern "C" int pdr_ball_query(const void* xyz, const void* centers, int B, int N,
                              int M, int K, float r2, void* idx, void* counts,
                              void* stream) {
  const dim3 grid((M + kWarps - 1) / kWarps, B);
  ball_query_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(centers), N, M, K,
      r2, static_cast<int*>(idx), static_cast<int*>(counts));
  PDR_RETURN_LAUNCH_ERROR();
}
