// The staged ball scan of the fused grouping kernels: the fused ball group
// (ball_group.cu, #2) and the fused ball query + gather (ball_query_group.cu,
// #8).  The ball query (ball_query.cu, #3) keeps common.cuh's scan; all three
// give the same idx and counts.
//
// A block stages its batch row of the support in shared memory as x / y / z
// arrays padded with +inf to a multiple of kScanStep (up to kScanMaxStaged
// points; a larger support is read from global memory).  A warp scans for
// one query: a lane tests kScanPer points a step (lane, lane + 32, ...), so a
// step covers kScanStep points in index order, and one __any_sync skips the
// hit bookkeeping (a ballot, a popcount prefix and a slot store for each of
// the kScanPer sub-steps) on the common step without a hit.
//
// Any number of slots: a warp owns a buffer of a few dozen slots and scans
// in passes.  A pass stores the hits of rank [lo, hi) and stops at the end
// of the step in which the count reaches hi; the next pass resumes at that
// step with the count before it, so a step is tested at most twice.
#pragma once

#include "common.cuh"

constexpr int kScanPer = 8;  // points a lane tests a scan step
constexpr int kScanStep = 32 * kScanPer;
constexpr int kScanMaxStaged = 8192;  // support points staged in shared memory

__host__ __device__ constexpr int pdr_round_up(int x, int m) { return (x + m - 1) / m * m; }

// shared-memory bytes of a staged support of N points (0: read from global)
__host__ __device__ inline int pdr_staged_bytes(int N) {
  return N <= kScanMaxStaged ? 3 * pdr_round_up(N, kScanStep) * 4 : 0;
}

// The whole block copies its (N, 3) support row into sx / sy / sz, each
// padded with +inf to a multiple of kScanStep (never in a ball).
__device__ __forceinline__ void pdr_stage_support(const float* __restrict__ pts, int N,
                                                  float* sx, float* sy, float* sz) {
  const int npad = pdr_round_up(N, kScanStep);
  for (int f = threadIdx.x; f < 3 * npad; f += blockDim.x) {
    const int i = f / 3;
    const int c = f - 3 * i;
    (c == 0 ? sx : c == 1 ? sy : sz)[i] = f < 3 * N ? pts[f] : INFINITY;
  }
  __syncthreads();
}

// Where the next pass of one query's scan starts: the step that reached the
// last pass's hi, and the hits before it.
struct PdrScanState {
  int base = 0;
  int cnt = 0;
};

// One pass of the scan of one query (all 32 lanes call it): stores the hits
// of rank [lo, hi) in index order to slots[rank - lo] and returns the hits
// counted so far, which is the ball's whole count when it is below hi.
// ``slots`` is visible to the whole warp on return.
template <bool kStaged>
__device__ __forceinline__ int pdr_ball_scan_pass(const float* sx, const float* sy,
                                                  const float* sz,
                                                  const float* __restrict__ pts, int N,
                                                  float qx, float qy, float qz, float r2,
                                                  int lo, int hi, int* slots, int lane,
                                                  PdrScanState& st) {
  const unsigned below = (1u << lane) - 1u;
  const int end = kStaged ? pdr_round_up(N, kScanStep) : N;
  int cnt = st.cnt;
  for (int base = st.base; base < end && cnt < hi; base += kScanStep) {
    unsigned hits = 0u;
#pragma unroll
    for (int j = 0; j < kScanPer; ++j) {
      const int n = base + 32 * j + lane;
      float x, y, z;
      if (kStaged) {  // padded with +inf
        x = sx[n];
        y = sy[n];
        z = sz[n];
      } else if (n < N) {
        x = __ldg(pts + 3 * n);
        y = __ldg(pts + 3 * n + 1);
        z = __ldg(pts + 3 * n + 2);
      } else {
        x = y = z = INFINITY;
      }
      hits |= static_cast<unsigned>(pdr_sqdist3(x, y, z, qx, qy, qz) < r2) << j;
    }
    if (__any_sync(PDR_FULL_MASK, hits != 0u)) {
      st.base = base;  // the count only moves here: resume at this step
      st.cnt = cnt;
#pragma unroll
      for (int j = 0; j < kScanPer; ++j) {
        const bool hit = (hits >> j) & 1u;
        const unsigned bal = __ballot_sync(PDR_FULL_MASK, hit);
        const int rank = cnt + __popc(bal & below);
        if (hit && rank >= lo && rank < hi) slots[rank - lo] = base + 32 * j + lane;
        cnt += __popc(bal);
      }
    }
  }
  __syncwarp();
  return cnt;
}
