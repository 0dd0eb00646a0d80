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
// many, since every lane pays its own insertions), each lane's sorted best
// list in registers, k rounds of a lexicographic (distance, index) minimum
// over the lanes' heads: the selection of knn_select.cuh, which the kNN +
// gather kernel (knn_group.cu) shares.  Lane 0 of a query writes each pair
// as the group emits it.
#include "knn_select.cuh"

namespace {

template <int L, int G>
__global__ void __launch_bounds__(pdr_select::kSelectThreads)
knn_kernel(const float* __restrict__ query, const float* __restrict__ points, int M, int N,
           int k, float* __restrict__ dist, int* __restrict__ idx) {
  __shared__ float sx[pdr_select::kSelectTile];
  __shared__ float sy[pdr_select::kSelectTile];
  __shared__ float sz[pdr_select::kSelectTile];
  constexpr int kGroups = pdr_select::kSelectThreads / G;
  const int lane = threadIdx.x % G;
  const int b = blockIdx.y;
  const int m = blockIdx.x * kGroups + threadIdx.x / G;
  // a query past M computes on the last row and writes nothing, so that
  // every lane of a warp takes part in the shuffles
  const size_t qrow = static_cast<size_t>(b) * M + min(m, M - 1);
  const float qx = query[qrow * 3];
  const float qy = query[qrow * 3 + 1];
  const float qz = query[qrow * 3 + 2];
  float* od = dist + qrow * k;
  int* oi = idx + qrow * k;
  const bool writes = m < M && lane == 0;
  pdr_select::select<L, G>(points + static_cast<size_t>(b) * N * 3, N, k, lane, qx, qy, qz, sx,
                        sy, sz, [&](int j, float d, int i) {
                          if (writes) {
                            od[j] = d;
                            oi[j] = i;
                          }
                        });
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
  const bool ok = pdr_select::dispatch(lanes, k, [&](auto l, auto g) {
    constexpr int L = decltype(l)::value, G = decltype(g)::value;
    constexpr int kGroups = pdr_select::kSelectThreads / G;
    const dim3 grid((M + kGroups - 1) / kGroups, B);
    knn_kernel<L, G><<<grid, pdr_select::kSelectThreads, 0, s>>>(q, p, M, N, k, d, i);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  PDR_RETURN_LAUNCH_ERROR();
}
