// Fused ball query + gather of one or two feature tables with position
// channels, written straight into the grouped (B, M, K, C) layout.
//
// Replaces the TPU kernel ops/pallas_window.py::_window_kernel_t (called by
// windowed_ball_group_t, pallas_window.py:1022; its lane-major twin
// _window_kernel / windowed_ball_group, pallas_window.py:596, computes the
// same function and is served by this kernel too).  It ports the function,
// not the TPU windowing: no support sort, no query sort, no hi/lo bf16
// split, and the output is in original query order.
//
// Semantics, per query: the first <= K support points with d^2 < r^2 in
// original index order; slot k < count holds the k-th of them, slots past
// the count repeat the first.  For each table the slot's channels are
// [features (Ci), rel = abs - query (3), abs (3), query (3, optional)], all
// bfloat16, abs being the neighbour's exact float32 position.  An empty
// ball follows empty_mode: 0 = "center_zero" (zero features, abs = query,
// rel = 0; QueryAndGroup subset=False) or 1 = "row0" (every slot is
// support row 0; the reference ball query's zeroed idx).  counts (B, M)
// are capped at K.  The training route also asks for idx (B, M, K): the
// backward (csrc/group_scatter.cu) scatters the grouped cotangent by it.
//
// What bounds it on this card: bytes.  The grouped output (B*M*K*(Ci+6|9)
// bf16 per table, ~28 MB at the level-0 feature-transfer shapes) dwarfs the
// inputs; the scan costs ~9 float ops per (query, point) pair and stops at
// the K-th neighbour.
//
// Design: one warp per query, 8 queries per block.  The warp scans the
// support with pdr_warp_ball_scan (common.cuh): 32 points at a time, the
// first K hits in index order in a per-warp slot list in shared memory,
// stopping once K are found.  The warp then writes the query's K * C output
// row for each table with consecutive lanes on consecutive channels
// (coalesced), reading table rows (bf16) through L2.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMaxK = 64;

__device__ __forceinline__ void write_group(
    const __nv_bfloat16* __restrict__ tab, int C, __nv_bfloat16* __restrict__ out,
    const float* __restrict__ pts, const int* slots, int cnt, int K,
    bool center_zero, bool include_center, const float q[3], int lane) {
  const int cout = C + (include_center ? 9 : 6);
  const int total = K * cout;
  for (int e = lane; e < total; e += 32) {
    const int k = e / cout;
    const int c = e - k * cout;
    // source row of this slot; -1 = empty ball under center_zero
    int src;
    if (cnt > 0) {
      src = slots[k < cnt ? k : 0];
    } else {
      src = center_zero ? -1 : 0;
    }
    __nv_bfloat16 v;
    if (c < C) {
      v = src >= 0 ? tab[static_cast<size_t>(src) * C + c] : __float2bfloat16_rn(0.f);
    } else {
      const int p = c - C;
      const int comp = p % 3;
      const int group = p / 3;  // 0 rel, 1 abs, 2 query
      const float a = src >= 0 ? pts[static_cast<size_t>(src) * 3 + comp] : q[comp];
      float val;
      if (group == 0) {
        val = __fsub_rn(a, q[comp]);
      } else if (group == 1) {
        val = a;
      } else {
        val = q[comp];
      }
      v = __float2bfloat16_rn(val);
    }
    out[e] = v;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
ball_group_kernel(const float* __restrict__ support, const float* __restrict__ queries,
                  int N, int M, int K, float r2, int include_center, int empty_mode,
                  const __nv_bfloat16* __restrict__ tab0, int C0,
                  __nv_bfloat16* __restrict__ out0,
                  const __nv_bfloat16* __restrict__ tab1, int C1,
                  __nv_bfloat16* __restrict__ out1, int* __restrict__ counts,
                  int* __restrict__ idx) {
  __shared__ int slots_all[kWarps][kMaxK];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int m = blockIdx.x * kWarps + warp;
  if (m >= M) return;  // warp-uniform
  int* slots = slots_all[warp];
  const float* pts = support + static_cast<size_t>(b) * N * 3;
  const size_t qrow = static_cast<size_t>(b) * M + m;
  const float q[3] = {queries[qrow * 3], queries[qrow * 3 + 1], queries[qrow * 3 + 2]};

  const int cnt = pdr_warp_ball_scan(pts, N, q[0], q[1], q[2], r2, K, slots, lane);
  if (lane == 0) counts[qrow] = cnt;
  if (idx != nullptr) {
    // original support indices, as the ball-query kernel pads them: slots
    // past the count repeat the first neighbour, an empty ball is all zeros
    const int first = cnt > 0 ? slots[0] : 0;
    for (int k = lane; k < K; k += 32) idx[qrow * K + k] = k < cnt ? slots[k] : first;
  }

  const bool center_zero = empty_mode == 0;
  const bool with_center = include_center != 0;
  const size_t nb = static_cast<size_t>(b) * N;
  write_group(tab0 + nb * C0, C0,
              out0 + qrow * K * (C0 + (with_center ? 9 : 6)), pts, slots, cnt, K,
              center_zero, with_center, q, lane);
  if (tab1 != nullptr) {
    write_group(tab1 + nb * C1, C1,
                out1 + qrow * K * (C1 + (with_center ? 9 : 6)), pts, slots, cnt, K,
                center_zero, with_center, q, lane);
  }
}

}  // namespace

// support (B, N, 3) f32, queries (B, M, 3) f32, tab0 (B, N, C0) bf16 and an
// optional tab1 (B, N, C1) bf16 (null when absent) -> out_i (B, M, K, Ci+6|9)
// bf16, counts (B, M) i32 and, when idx is not null, idx (B, M, K) i32 (the
// neighbours' original support indices, which the backward scatters by).
// K <= 64 (checked by the caller).
extern "C" int pdr_ball_group(const void* support, const void* queries, int B, int N,
                              int M, int K, float r2, int include_center,
                              int empty_mode, const void* tab0, int C0, void* out0,
                              const void* tab1, int C1, void* out1, void* counts,
                              void* idx, void* stream) {
  const dim3 grid((M + kWarps - 1) / kWarps, B);
  ball_group_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(support), static_cast<const float*>(queries), N, M,
      K, r2, include_center, empty_mode, static_cast<const __nv_bfloat16*>(tab0), C0,
      static_cast<__nv_bfloat16*>(out0), static_cast<const __nv_bfloat16*>(tab1), C1,
      static_cast<__nv_bfloat16*>(out1), static_cast<int*>(counts),
      static_cast<int*>(idx));
  PDR_RETURN_LAUNCH_ERROR();
}
