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
// then atomic throughput where many slots share a row.  The first port ran
// one thread per (b, m, c) walking its K slots with a data-dependent branch
// and an atomic between loads, so a thread had about one load in flight.
//
// Design: one thread per (`bpt` consecutive balls, channel), consecutive
// threads on consecutive channels, so a warp's loads of a slot are
// contiguous; the caller picks bpt (ops/scatter.py).  A thread issues the
// loads of kUnroll slots (their idx and their values) before it reduces
// them, sums each run of equal indices in a register, in slot order, and
// ends the run with one atomic.  It carries its run from one of its balls
// to the next, so consecutive empty balls (every slot row 0, a row's
// worst conflict) end in one atomic, not one each.  Runs need no special
// case: the repeat-first padding makes slot 0 and slots count..K-1 one row,
// an empty ball is one run, a run never crosses a batch row (it is keyed by
// b * N + idx), and any idx is taken.  The order of atomics across threads
// changes from run to run, so results vary in the last float32 bits.  dg
// may be a channel slice of a wider row (``ld`` elements between
// consecutive slots).  With ``counts`` given, balls whose count is 0 are
// skipped (the "center_zero" mode of the fused group: an empty ball's
// features are zeros, not row 0).  dtable must be zeroed on the same stream
// before the launch.
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
                         int bpt, float* __restrict__ dtable, int balls) {
  constexpr int kUnroll = 8;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int t0 = static_cast<int>(i / C);  // the thread's first ball / bpt
  const int c = static_cast<int>(i - static_cast<long long>(t0) * C);
  const int first = t0 * bpt;  // b * M + m
  if (first >= balls) return;
  const int last = min(first + bpt, balls);
  float acc = 0.0f;
  int cur = -1;  // the run's row of dtable, b * N + idx
  for (int ball = first; ball < last; ++ball) {
    if (counts != nullptr && counts[ball] == 0) continue;
    const int row0 = (ball / M) * N;
    const int* id = idx + static_cast<size_t>(ball) * K;
    const T* g = dg + static_cast<size_t>(ball) * K * ld + c;
    for (int k0 = 0; k0 < K; k0 += kUnroll) {
      int t[kUnroll];
      T x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + u;
        if (k < K) {
          t[u] = row0 + __ldg(id + k);
          x[u] = g[static_cast<size_t>(k) * ld];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (k0 + u < K) {
          if (t[u] == cur) {
            acc = __fadd_rn(acc, to_float(x[u]));
          } else {
            if (cur >= 0) atomicAdd(dtable + static_cast<size_t>(cur) * C + c, acc);
            cur = t[u];
            acc = to_float(x[u]);
          }
        }
      }
    }
  }
  if (cur >= 0) atomicAdd(dtable + static_cast<size_t>(cur) * C + c, acc);
}

template <typename T>
void launch(const void* dg, int ld, const void* idx, const void* counts, int B, int N,
            int M, int K, int C, int bpt, void* dtable, cudaStream_t s) {
  const int balls = B * M;
  const long long threads = static_cast<long long>((balls + bpt - 1) / bpt) * C;
  group_scatter_add_kernel<T><<<static_cast<unsigned>((threads + kThreads - 1) / kThreads),
                                kThreads, 0, s>>>(
      static_cast<const T*>(dg), ld, static_cast<const int*>(idx),
      static_cast<const int*>(counts), N, M, K, C, bpt, static_cast<float*>(dtable), balls);
}

}  // namespace

// dg (B, M, K, C) f32 (dg_bf16 = 0) or bf16 (dg_bf16 = 1), ``ld`` elements
// between consecutive (m, k) rows; idx (B, M, K) i32; counts (B, M) i32 or
// null -> dtable (B, N, C) f32, accumulated in place.  bpt: consecutive
// balls a thread takes in turn.
extern "C" int pdr_group_scatter_add(const void* dg, int dg_bf16, int ld, const void* idx,
                                     const void* counts, int B, int N, int M, int K,
                                     int C, int bpt, void* dtable, void* stream) {
  if (K < 1 || C < 1 || bpt < 1 || static_cast<long long>(B) * N >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B * M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  (dg_bf16 ? &launch<__nv_bfloat16> : &launch<float>)(dg, ld, idx, counts, B, N, M, K, C,
                                                       bpt, dtable, s);
  PDR_RETURN_LAUNCH_ERROR();
}
