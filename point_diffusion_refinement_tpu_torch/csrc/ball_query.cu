// Ball query: the first <= K support points with d^2 < r^2, in index order.
//
// Replaces the TPU kernel ops/pallas_neighbors.py::_ball_query_kernel
// (called by ball_query_pallas, pallas_neighbors.py:115).
//
// Semantics: strict d^2 < r^2; slots past the count repeat the first
// neighbour; an empty ball gives all zeros; counts are capped at K; K may
// exceed N (the count then stays <= N and the rest repeat the first).
//
// What bounds it on this card: operations, ~9 float ops per scanned
// (centre, point) pair; a centre stops scanning at its K-th neighbour, so
// the count depends on the data.  Bytes are small (the support is read
// once per block from L2).
//
// Design: one thread per centre, 128 centres of one batch row per block.
// The block stages the support in shared-memory tiles of 512 points and
// every thread scans a tile in index order, recording hits until it has K;
// the block moves on to the next tile only while some centre still needs
// more.  A TPU-style closed form over a cumulative sum is not needed: a
// sequential scan with early exit does less work here.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 512;

__global__ void __launch_bounds__(kThreads)
ball_query_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
                  int N, int M, int K, float r2, int* __restrict__ idx,
                  int* __restrict__ counts) {
  __shared__ float sp[kTile * 3];
  const int b = blockIdx.y;
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = m < M;
  const float* pts = xyz + static_cast<size_t>(b) * N * 3;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  int* out = nullptr;
  if (active) {
    const float* c = centers + (static_cast<size_t>(b) * M + m) * 3;
    qx = c[0];
    qy = c[1];
    qz = c[2];
    out = idx + (static_cast<size_t>(b) * M + m) * K;
  }
  int cnt = 0;
  int first = 0;
  for (int base = 0; base < N; base += kTile) {
    if (!__syncthreads_or(active && cnt < K)) break;
    const int n = min(kTile, N - base);
    for (int i = threadIdx.x; i < n * 3; i += blockDim.x) {
      sp[i] = pts[static_cast<size_t>(base) * 3 + i];
    }
    __syncthreads();
    if (active && cnt < K) {
      for (int i = 0; i < n; ++i) {
        const float d = pdr_sqdist3(qx, qy, qz, sp[3 * i], sp[3 * i + 1], sp[3 * i + 2]);
        if (d < r2) {
          if (cnt == 0) first = base + i;
          out[cnt] = base + i;
          if (++cnt >= K) break;
        }
      }
    }
  }
  if (active) {
    for (int k = cnt; k < K; ++k) out[k] = first;
    counts[static_cast<size_t>(b) * M + m] = cnt;
  }
}

}  // namespace

// xyz (B, N, 3) f32, centers (B, M, 3) f32 -> idx (B, M, K) i32, counts (B, M) i32.
extern "C" int pdr_ball_query(const void* xyz, const void* centers, int B, int N,
                              int M, int K, float r2, void* idx, void* counts,
                              void* stream) {
  const dim3 grid((M + kThreads - 1) / kThreads, B);
  ball_query_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(centers), N, M, K,
      r2, static_cast<int*>(idx), static_cast<int*>(counts));
  PDR_RETURN_LAUNCH_ERROR();
}
