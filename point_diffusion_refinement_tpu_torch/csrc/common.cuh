// Shared helpers of the port's CUDA kernels (built with -fmad=false).
#pragma once

#include <cuda_runtime.h>

#include <cmath>

#define PDR_FULL_MASK 0xffffffffu

// Squared distance with every product and sum rounded on its own, in the
// order the JAX reference uses: (dx*dx + dy*dy) + dz*dz.  An FMA-contracted
// form differs in the last bit, which can move a point across a radius
// boundary or change an FPS argmax.
__device__ __forceinline__ float pdr_sqdist3(float ax, float ay, float az,
                                             float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Every C entry returns the launch's error state (0 = cudaSuccess).
#define PDR_RETURN_LAUNCH_ERROR() return static_cast<int>(cudaGetLastError())

// Warp scan of a ball query: the first <= K support points with d^2 < r^2
// around the query (qx, qy, qz), in index order.  The warp tests 32 points
// at a time: each lane one point, a ballot marks the in-radius lanes and a
// popcount prefix gives each hit its slot, so hits land in ``slots`` (K ints
// owned by this warp) in index order and the scan stops once K are found.
// Returns the count capped at K; ``slots`` is visible to the whole warp on
// return.  All 32 lanes must call it.
__device__ __forceinline__ int pdr_warp_ball_scan(const float* __restrict__ pts, int N,
                                                  float qx, float qy, float qz,
                                                  float r2, int K, int* slots,
                                                  int lane) {
  int cnt = 0;
  for (int base = 0; base < N && cnt < K; base += 32) {
    const int n = base + lane;
    bool hit = false;
    if (n < N) {
      const float d = pdr_sqdist3(pts[3 * n], pts[3 * n + 1], pts[3 * n + 2], qx, qy, qz);
      hit = d < r2;
    }
    const unsigned bal = __ballot_sync(PDR_FULL_MASK, hit);
    const int rank = cnt + __popc(bal & ((1u << lane) - 1u));
    if (hit && rank < K) slots[rank] = n;
    cnt += __popc(bal);
  }
  __syncwarp();
  return min(cnt, K);
}
