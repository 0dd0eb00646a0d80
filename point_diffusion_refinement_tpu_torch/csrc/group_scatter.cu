// Scatter-add of grouped cotangents into table rows:
//   dtable[b, idx[b, m, k], c] += dg[b, m, k, c]   over all (m, k).
//
// The backward of the two grouping kernels: of csrc/ball_query_group.cu
// (float32 cotangents of the gathered table rows) and of csrc/ball_group.cu
// (bfloat16 cotangents of the feature channels, float32 d_rel + d_abs of the
// position channels).  The JAX package has no kernel here: its backwards
// (models/grouping.py::_fused_ball_gather_bwd, ops/windowed_grad.py::_bwd)
// contract the cotangent with a (B, M, K, N) bf16 one-hot on the MXU, a TPU
// stand-in for the atomic scatter-add of the original CUDA code; on this
// card the scatter-add is the direct form.  The cotangent is not rounded to
// bf16 as it is there.
//
// What bounds it on this card: bytes (dg is read once, B*M*K*C elements),
// then atomic throughput where many slots share a row.
//
// Design: one thread per (b, m, c) walks the K slots of its ball in order
// and sums runs of equal indices in a register, so a repeat-first padded
// ball adds once for its padding and an empty ball (every slot row 0) adds
// once in all; each run ends in one float32 atomicAdd.  Sums within a thread
// are in slot order; the order of atomics across threads changes from run
// to run, so results vary in the last float32 bits.  dg may be a channel
// slice of a wider row (``ld`` elements between consecutive slots).  With
// ``counts`` given, balls whose count is 0 are skipped (the "center_zero"
// mode of the fused group: an empty ball's features are zeros, not row 0).
// dtable must be zeroed on the same stream before the launch.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
group_scatter_add_kernel(const T* __restrict__ dg, int ld, const int* __restrict__ idx,
                         const int* __restrict__ counts, int N, int M, int K, int C,
                         float* __restrict__ dtable, size_t total) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const size_t row = i / C;  // b * M + m
    const int c = static_cast<int>(i - row * C);
    if (counts != nullptr && counts[row] == 0) continue;
    const size_t b = row / M;
    const int* id = idx + row * K;
    const T* g = dg + row * K * ld + c;
    float* dst = dtable + b * N * C + c;
    int cur = id[0];
    float acc = to_float(g[0]);
    for (int k = 1; k < K; ++k) {
      const int j = id[k];
      const float v = to_float(g[static_cast<size_t>(k) * ld]);
      if (j == cur) {
        acc = __fadd_rn(acc, v);
      } else {
        atomicAdd(dst + static_cast<size_t>(cur) * C, acc);
        cur = j;
        acc = v;
      }
    }
    atomicAdd(dst + static_cast<size_t>(cur) * C, acc);
  }
}

}  // namespace

// dg (B, M, K, C) f32 (dg_bf16 = 0) or bf16 (dg_bf16 = 1), ``ld`` elements
// between consecutive (m, k) rows; idx (B, M, K) i32; counts (B, M) i32 or
// null -> dtable (B, N, C) f32, accumulated in place.
extern "C" int pdr_group_scatter_add(const void* dg, int dg_bf16, int ld, const void* idx,
                                     const void* counts, int B, int N, int M, int K,
                                     int C, void* dtable, void* stream) {
  const size_t total = static_cast<size_t>(B) * M * C;
  if (total == 0) return 0;
  size_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 65535u * 16u) blocks = 65535u * 16u;
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dg_bf16) {
    group_scatter_add_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dg), ld, static_cast<const int*>(idx),
        static_cast<const int*>(counts), N, M, K, C, static_cast<float*>(dtable), total);
  } else {
    group_scatter_add_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(dg), ld, static_cast<const int*>(idx),
        static_cast<const int*>(counts), N, M, K, C, static_cast<float*>(dtable), total);
  }
  PDR_RETURN_LAUNCH_ERROR();
}
