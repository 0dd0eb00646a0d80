// k nearest neighbours + gather of the k table rows + the 11 distance and
// position channels of a kNN feature propagation, in one kernel.
//
// Replaces the TPU kernels ops/pallas_window.py::_knn_window_kernel and its
// layout twin _knn_window_kernel_t (called by windowed_knn_group,
// pallas_window.py:1224, and windowed_knn_group_t, :1447).  Those sort the
// support, select inside a window of it and rerun whole tiles over the full
// support when the window proves too narrow, because a TPU gather is a
// one-hot matrix product as wide as what it gathers from.  Here a gather is
// an indexed load: no sort, no window, and the output is in the queries' own
// order.
//
// What bounds it on this card: operations in the selection (~10 per
// (query, point) pair, as in knn.cu), bytes in the gather (k rows of C + 11
// bf16 values written per query).
//
// Design: a block owns 128 queries of one batch row.  Phase one is knn.cu's
// selection, one thread per query with its k best (distance, index) pairs
// sorted in registers, the support staged in shared-memory tiles; points
// arrive in ascending index and insert only on a strict <, so ties keep the
// lowest index.  The winners go to shared memory; in phase two each warp
// takes (query, slot) pairs in turn and writes the output row with its lanes
// across the channels, so table reads and output writes are contiguous.
// Positions come from the float32 support, each channel rounded to bf16 once.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;
constexpr int kTile = 512;

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_group_kernel(const float* __restrict__ query, const float* __restrict__ points,
                 const bf16* __restrict__ table, int M, int N, int C,
                 bf16* __restrict__ out) {
  __shared__ float sp[kTile * 3];
  __shared__ float sd[kThreads * K];  // squared distances, ascending
  __shared__ float sw[kThreads * K];  // normalised inverse-distance weights
  __shared__ int si[kThreads * K];
  __shared__ float sq[kThreads * 3];
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
  // w_j = (1 / (d_j + 1e-8)) / sum_i 1 / (d_i + 1e-8), summed in slot order
  float wsum = 0.f;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const float r = 1.0f / (bd[s] + 1e-8f);
    wsum = s == 0 ? r : wsum + r;
  }
#pragma unroll
  for (int s = 0; s < K; ++s) {
    sd[threadIdx.x * K + s] = bd[s];
    sw[threadIdx.x * K + s] = (1.0f / (bd[s] + 1e-8f)) / wsum;
    si[threadIdx.x * K + s] = bi[s];
  }
  sq[threadIdx.x * 3 + 0] = qx;
  sq[threadIdx.x * 3 + 1] = qy;
  sq[threadIdx.x * 3 + 2] = qz;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nq = min(kThreads, M - static_cast<int>(blockIdx.x * blockDim.x));
  const int width = C + 11;
  const bf16* tab = table + static_cast<size_t>(b) * N * C;
  for (int p = warp; p < nq * K; p += kThreads / 32) {
    const int ql = p / K;
    const int n = si[p];
    const bf16* row = tab + static_cast<size_t>(n) * C;
    bf16* o = out + ((static_cast<size_t>(b) * M + blockIdx.x * blockDim.x + ql) * K + (p - ql * K)) * width;
    for (int c = lane; c < C; c += 32) o[c] = row[c];
    if (lane < 11) {
      float v;
      if (lane == 0) {
        v = sd[p];
      } else if (lane == 1) {
        v = sw[p];
      } else {
        const int ax = (lane - 2) % 3;
        const float pa = pts[static_cast<size_t>(n) * 3 + ax];
        const float qa = sq[ql * 3 + ax];
        v = lane < 5 ? pa : (lane < 8 ? __fsub_rn(pa, qa) : qa);
      }
      o[C + lane] = __float2bfloat16_rn(v);
    }
  }
}

template <int K>
void launch(const float* q, const float* p, const bf16* t, int B, int M, int N, int C,
            bf16* o, cudaStream_t stream) {
  const dim3 grid((M + kThreads - 1) / kThreads, B);
  knn_group_kernel<K><<<grid, kThreads, 0, stream>>>(q, p, t, M, N, C, o);
}

}  // namespace

// query (B, M, 3), points (B, N, 3) f32, table (B, N, C) bf16 ->
// out (B, M, K, C + 11) bf16: [table row, squared distance, inverse-distance
// weight, neighbour xyz, neighbour - query, query xyz].  1 <= K <= 16,
// K <= N, C >= 1 (checked by the caller).
extern "C" int pdr_knn_group(const void* query, const void* points, const void* table,
                             int B, int M, int N, int C, int K, void* out, void* stream) {
  const float* q = static_cast<const float*>(query);
  const float* p = static_cast<const float*>(points);
  const bf16* t = static_cast<const bf16*>(table);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
#define PDR_KNN_GROUP_CASE(k) \
  case k:                     \
    launch<k>(q, p, t, B, M, N, C, o, s); \
    break;
    PDR_KNN_GROUP_CASE(1) PDR_KNN_GROUP_CASE(2) PDR_KNN_GROUP_CASE(3) PDR_KNN_GROUP_CASE(4)
    PDR_KNN_GROUP_CASE(5) PDR_KNN_GROUP_CASE(6) PDR_KNN_GROUP_CASE(7) PDR_KNN_GROUP_CASE(8)
    PDR_KNN_GROUP_CASE(9) PDR_KNN_GROUP_CASE(10) PDR_KNN_GROUP_CASE(11) PDR_KNN_GROUP_CASE(12)
    PDR_KNN_GROUP_CASE(13) PDR_KNN_GROUP_CASE(14) PDR_KNN_GROUP_CASE(15) PDR_KNN_GROUP_CASE(16)
#undef PDR_KNN_GROUP_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  PDR_RETURN_LAUNCH_ERROR();
}
