// Ball query + gather of float32 table rows in one kernel.
//
// Replaces the TPU kernel ops/pallas_neighbors.py::_ball_query_group_kernel
// (called by ball_query_group_pallas, pallas_neighbors.py:380).  It ports
// the function, not the block: the TPU kernel gathers with one-hot MXU
// products against a hi/lo bf16 split of the table (about 16 mantissa bits)
// and rebuilds the index from an appended lane column; here a gather is an
// indexed load, so the gathered values are the exact float32 table rows.
//
// Semantics, per centre: the first <= K support points with d^2 < r^2 in
// index order (pdr_sqdist3, so idx and counts equal csrc/ball_query.cu's
// bit for bit); slot k < count holds the k-th of them, slots past the count
// repeat the first, an empty ball takes row 0 in every slot; counts (B, M)
// are capped at K.  gathered[b, m, k, :] = table[b, idx[b, m, k], :].
//
// What bounds it on this card: bytes.  The gathered output (B*M*K*C float32,
// 37 MB at the level-0 feature-transfer shape with C = 35) dwarfs the
// inputs; the scan costs ~9 float ops per (centre, point) pair and stops at
// the K-th neighbour.
//
// Design: one warp per centre, 8 centres per block.  The warp scans the
// support with pdr_warp_ball_scan (common.cuh, shared with ball_group.cu),
// resolves the K slot indices in shared memory, and then copies the K table
// rows with consecutive lanes on consecutive elements of the K * C output
// row (coalesced writes; table rows are read through L2).  Any C >= 1 and
// any M are taken; K <= 128 (checked by the caller).
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMaxK = 128;

__global__ void __launch_bounds__(kWarps * 32)
ball_query_group_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
                        const float* __restrict__ table, int N, int M, int K, int C,
                        float r2, float* __restrict__ gathered, int* __restrict__ idx,
                        int* __restrict__ counts) {
  __shared__ int slots_all[kWarps][kMaxK];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int m = blockIdx.x * kWarps + warp;
  if (m >= M) return;  // warp-uniform
  int* slots = slots_all[warp];
  const float* pts = xyz + static_cast<size_t>(b) * N * 3;
  const size_t qrow = static_cast<size_t>(b) * M + m;
  const float qx = centers[qrow * 3];
  const float qy = centers[qrow * 3 + 1];
  const float qz = centers[qrow * 3 + 2];

  const int cnt = pdr_warp_ball_scan(pts, N, qx, qy, qz, r2, K, slots, lane);
  if (lane == 0) counts[qrow] = cnt;
  // repeat-first padding; row 0 for an empty ball
  const int first = cnt > 0 ? slots[0] : 0;
  __syncwarp();
  for (int k = lane; k < K; k += 32) {
    const int s = k < cnt ? slots[k] : first;
    slots[k] = s;
    idx[qrow * K + k] = s;
  }
  __syncwarp();

  const float* tab = table + static_cast<size_t>(b) * N * C;
  float* out = gathered + qrow * K * C;
  const int total = K * C;
  for (int e = lane; e < total; e += 32) {
    const int k = e / C;
    const int c = e - k * C;
    out[e] = tab[static_cast<size_t>(slots[k]) * C + c];
  }
}

}  // namespace

// xyz (B, N, 3) f32, centers (B, M, 3) f32, table (B, N, C) f32 ->
// gathered (B, M, K, C) f32, idx (B, M, K) i32, counts (B, M) i32.
extern "C" int pdr_ball_query_group(const void* xyz, const void* centers,
                                    const void* table, int B, int N, int M, int K,
                                    int C, float r2, void* gathered, void* idx,
                                    void* counts, void* stream) {
  const dim3 grid((M + kWarps - 1) / kWarps, B);
  ball_query_group_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(centers),
      static_cast<const float*>(table), N, M, K, C, r2,
      static_cast<float*>(gathered), static_cast<int*>(idx),
      static_cast<int*>(counts));
  PDR_RETURN_LAUNCH_ERROR();
}
