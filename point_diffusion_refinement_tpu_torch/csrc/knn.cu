// k nearest neighbours by squared distance, ascending, ties to the lowest
// index.
//
// Replaces the TPU kernel ops/pallas_neighbors.py::_knn_kernel (called by
// knn_pallas, pallas_neighbors.py:192).
//
// What bounds it on this card: operations, ~9 float ops per (query, point)
// pair for the distance plus the compare with the current k-th best.
//
// Design: one thread per query, 128 queries of one batch row per block, the
// points staged in shared-memory tiles of 512.  Each thread keeps its k best
// (distance, index) pairs sorted in registers (k is a template argument so
// the arrays stay in registers).  Points arrive in ascending index and
// insert only on a strict <, bubbling down past strictly larger entries, so
// an equal distance never displaces an earlier (lower) index.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 512;

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ query, const float* __restrict__ points,
           int M, int N, float* __restrict__ dist, int* __restrict__ idx) {
  __shared__ float sp[kTile * 3];
  const int b = blockIdx.y;
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = m < M;
  const float* pts = points + static_cast<size_t>(b) * N * 3;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* q = query + (static_cast<size_t>(b) * M + m) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = INFINITY;
    bi[s] = 0;
  }
  for (int base = 0; base < N; base += kTile) {
    const int n = min(kTile, N - base);
    __syncthreads();
    for (int i = threadIdx.x; i < n * 3; i += blockDim.x) {
      sp[i] = pts[static_cast<size_t>(base) * 3 + i];
    }
    __syncthreads();
    if (active) {
      for (int i = 0; i < n; ++i) {
        const float d = pdr_sqdist3(qx, qy, qz, sp[3 * i], sp[3 * i + 1], sp[3 * i + 2]);
        if (d < bd[K - 1]) {
          bd[K - 1] = d;
          bi[K - 1] = base + i;
#pragma unroll
          for (int s = K - 1; s > 0; --s) {
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
  }
  if (active) {
    float* od = dist + (static_cast<size_t>(b) * M + m) * K;
    int* oi = idx + (static_cast<size_t>(b) * M + m) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      od[s] = bd[s];
      oi[s] = bi[s];
    }
  }
}

template <int K>
void launch(const float* q, const float* p, int B, int M, int N, float* d, int* i,
            cudaStream_t stream) {
  const dim3 grid((M + kThreads - 1) / kThreads, B);
  knn_kernel<K><<<grid, kThreads, 0, stream>>>(q, p, M, N, d, i);
}

}  // namespace

// query (B, M, 3), points (B, N, 3) f32 -> dist (B, M, K) f32, idx (B, M, K) i32.
// 1 <= K <= 16 and K <= N (checked by the caller).
extern "C" int pdr_knn(const void* query, const void* points, int B, int M, int N,
                       int K, void* dist, void* idx, void* stream) {
  const float* q = static_cast<const float*>(query);
  const float* p = static_cast<const float*>(points);
  float* d = static_cast<float*>(dist);
  int* i = static_cast<int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
#define PDR_KNN_CASE(k) \
  case k:               \
    launch<k>(q, p, B, M, N, d, i, s); \
    break;
    PDR_KNN_CASE(1) PDR_KNN_CASE(2) PDR_KNN_CASE(3) PDR_KNN_CASE(4)
    PDR_KNN_CASE(5) PDR_KNN_CASE(6) PDR_KNN_CASE(7) PDR_KNN_CASE(8)
    PDR_KNN_CASE(9) PDR_KNN_CASE(10) PDR_KNN_CASE(11) PDR_KNN_CASE(12)
    PDR_KNN_CASE(13) PDR_KNN_CASE(14) PDR_KNN_CASE(15) PDR_KNN_CASE(16)
#undef PDR_KNN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  PDR_RETURN_LAUNCH_ERROR();
}
