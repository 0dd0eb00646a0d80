// Furthest point sampling: indices only, or indices and the selected
// coordinates.
//
// Replaces two TPU kernels of ops/pallas_fps.py:
//   * _fps_kernel_coords (furthest_point_sample_pallas_coords, :338), the
//     SA level-0 sampler: entry pdr_fps_coords;
//   * _fps_kernel and its opt-in layout twins _fps_kernel_stacked and
//     _fps_kernel_folded (furthest_point_sample_pallas, :312; all three pick
//     the same indices bit for bit), the sampler of mirror preprocessing,
//     PVCNN and neighbour statistics: entry pdr_fps_idx.
//
// Semantics: idx[0] = 0; points with |p|^2 <= 1e-3 are padding and never
// picked (an all-padding row yields index 0 throughout); each pick maximises
// the running minimum squared distance to the picked set, ties going to the
// lowest index; coords are the exact float32 positions of the picks.
//
// What bounds it on this card: neither bytes (a few hundred KB to a few MB)
// nor operations (~10 per point per pick) but latency: the npoint picks form
// a chain in which every step needs the argmax of the one before.
//
// Design: one block of 1024 threads per batch row.  The row's points
// (x, y, z planes) and its running minimum distance are kept as four float
// planes (16 bytes a point); padding points start at -1 so a min with a
// distance >= 0 keeps them out for good.  Each pick is a strided
// update-and-argmax over the row, a warp-shuffle argmax with a lowest-index
// tie-break, then the same across warps.  Thread 0 writes idx (and the
// coordinates of the pick); every thread reads the pick's position back for
// the next step.
//
// Where the planes live: in shared memory while a row fits a block's 227 KB
// (N <= 12288 is the wrapper's limit, 192 KB); beyond that, up to
// N = 2^18, in a global-memory workspace of (B, 4, N) floats that the
// wrapper allocates.  A row of 2^18 points is 4 MB and stays in the 50 MB
// L2, so the large-N path pays L2 latency per pick instead of shared-memory
// latency.  A thread-block cluster sharing its distributed shared memory
// would keep a large row on chip; that is a later optimisation.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr float kPadNormSq = 1e-3f;

__device__ __forceinline__ void argmax_step(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// kCoords: also write the picked coordinates.  kGlobal: the four planes live
// in `work` (B, 4, N) instead of dynamic shared memory.
template <bool kCoords, bool kGlobal>
__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, int N, int npoint,
           int* __restrict__ idx, float* __restrict__ coords,
           float* __restrict__ work) {
  extern __shared__ float smem[];
  __shared__ float red_val[32];
  __shared__ int red_idx[32];
  __shared__ int s_pick;

  const int b = blockIdx.x;
  float* sx = kGlobal ? work + static_cast<size_t>(b) * 4 * N : smem;
  float* sy = sx + N;
  float* sz = sy + N;
  float* mind = sz + N;
  const float* p = xyz + static_cast<size_t>(b) * N * 3;
  int* out_idx = idx + static_cast<size_t>(b) * npoint;
  float* out_co = kCoords ? coords + static_cast<size_t>(b) * npoint * 3 : nullptr;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int i = tid; i < N; i += blockDim.x) {
    const float x = p[3 * i], y = p[3 * i + 1], z = p[3 * i + 2];
    sx[i] = x;
    sy[i] = y;
    sz[i] = z;
    const float n2 = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                               __fmul_rn(z, z));
    mind[i] = n2 > kPadNormSq ? 1e10f : -1.0f;
  }
  __syncthreads();  // orders the global-workspace writes for the block too
  if (tid == 0) {
    out_idx[0] = 0;
    if constexpr (kCoords) {
      out_co[0] = sx[0];
      out_co[1] = sy[0];
      out_co[2] = sz[0];
    }
  }
  int old = 0;
  for (int j = 1; j < npoint; ++j) {
    const float qx = sx[old], qy = sy[old], qz = sz[old];
    float best = -INFINITY;
    int besti = N;
    for (int i = tid; i < N; i += blockDim.x) {
      const float d = pdr_sqdist3(sx[i], sy[i], sz[i], qx, qy, qz);
      const float m = fminf(mind[i], d);
      mind[i] = m;
      if (m > best) {  // ascending i: strict > keeps the lowest index
        best = m;
        besti = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      argmax_step(best, besti, __shfl_down_sync(PDR_FULL_MASK, best, off),
                  __shfl_down_sync(PDR_FULL_MASK, besti, off));
    }
    if (lane == 0) {
      red_val[warp] = best;
      red_idx[warp] = besti;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < nwarps ? red_val[lane] : -INFINITY;
      besti = lane < nwarps ? red_idx[lane] : N;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        argmax_step(best, besti, __shfl_down_sync(PDR_FULL_MASK, best, off),
                    __shfl_down_sync(PDR_FULL_MASK, besti, off));
      }
      if (lane == 0) {
        s_pick = besti;
        out_idx[j] = besti;
        if constexpr (kCoords) {
          out_co[3 * j] = sx[besti];
          out_co[3 * j + 1] = sy[besti];
          out_co[3 * j + 2] = sz[besti];
        }
      }
    }
    __syncthreads();
    old = s_pick;
  }
}

// work == nullptr: the planes go to dynamic shared memory (N * 16 bytes).
template <bool kCoords>
int launch_fps(const void* xyz, int B, int N, int npoint, void* idx,
               void* coords, void* work, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(xyz);
  auto* i = static_cast<int*>(idx);
  auto* c = static_cast<float*>(coords);
  if (work != nullptr) {
    fps_kernel<kCoords, true><<<B, kThreads, 0, s>>>(
        x, N, npoint, i, c, static_cast<float*>(work));
  } else {
    void (*kern)(const float*, int, int, int*, float*, float*) =
        fps_kernel<kCoords, false>;
    const size_t smem = static_cast<size_t>(N) * 4 * sizeof(float);
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    kern<<<B, kThreads, smem, s>>>(x, N, npoint, i, c, nullptr);
  }
  PDR_RETURN_LAUNCH_ERROR();
}

}  // namespace

// xyz (B, N, 3) f32 -> idx (B, npoint) i32, coords (B, npoint, 3) f32;
// work is nullptr or a (B, 4, N) f32 scratch for rows beyond shared memory.
extern "C" int pdr_fps_coords(const void* xyz, int B, int N, int npoint,
                              void* idx, void* coords, void* work, void* stream) {
  return launch_fps<true>(xyz, B, N, npoint, idx, coords, work, stream);
}

// xyz (B, N, 3) f32 -> idx (B, npoint) i32; work as for pdr_fps_coords.
extern "C" int pdr_fps_idx(const void* xyz, int B, int N, int npoint,
                           void* idx, void* work, void* stream) {
  return launch_fps<false>(xyz, B, N, npoint, idx, nullptr, work, stream);
}
