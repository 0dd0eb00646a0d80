// Furthest point sampling that also emits the selected coordinates.
//
// Replaces the TPU kernel ops/pallas_fps.py::_fps_kernel_coords (called by
// furthest_point_sample_pallas_coords, pallas_fps.py:338).
//
// Semantics: idx[0] = 0; points with |p|^2 <= 1e-3 are padding and never
// picked; each pick maximises the running minimum squared distance to the
// picked set, ties going to the lowest index; coords are the exact float32
// positions of the picks.
//
// What bounds it on this card: neither bytes (a few hundred KB) nor
// operations (~10 per point per pick) but latency: the npoint picks form a
// chain in which every step needs the argmax of the one before.
//
// Design: one block of 1024 threads per batch row.  The row's points
// (x, y, z planes) and its running minimum distance live in shared memory
// (16 bytes a point: 48 KB at N = 3072); padding points start at -1 so a
// min with a distance >= 0 keeps them out for good.  Each pick is a strided
// update-and-argmax over the row, a warp-shuffle argmax with a lowest-index
// tie-break, then the same across warps.  Thread 0 writes idx and the
// coordinates of the pick, which every thread reads back from shared
// memory for the next step.
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

__global__ void __launch_bounds__(kThreads)
fps_coords_kernel(const float* __restrict__ xyz, int N, int npoint,
                  int* __restrict__ idx, float* __restrict__ coords) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + N;
  float* sz = sy + N;
  float* mind = sz + N;
  __shared__ float red_val[32];
  __shared__ int red_idx[32];
  __shared__ int s_pick;

  const int b = blockIdx.x;
  const float* p = xyz + static_cast<size_t>(b) * N * 3;
  int* out_idx = idx + static_cast<size_t>(b) * npoint;
  float* out_co = coords + static_cast<size_t>(b) * npoint * 3;
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
  __syncthreads();
  if (tid == 0) {
    out_idx[0] = 0;
    out_co[0] = sx[0];
    out_co[1] = sy[0];
    out_co[2] = sz[0];
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
        out_co[3 * j] = sx[besti];
        out_co[3 * j + 1] = sy[besti];
        out_co[3 * j + 2] = sz[besti];
      }
    }
    __syncthreads();
    old = s_pick;
  }
}

}  // namespace

// xyz (B, N, 3) f32 -> idx (B, npoint) i32, coords (B, npoint, 3) f32.
extern "C" int pdr_fps_coords(const void* xyz, int B, int N, int npoint,
                              void* idx, void* coords, void* stream) {
  const size_t smem = static_cast<size_t>(N) * 4 * sizeof(float);
  cudaFuncSetAttribute(fps_coords_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  fps_coords_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), N, npoint, static_cast<int*>(idx),
      static_cast<float*>(coords));
  PDR_RETURN_LAUNCH_ERROR();
}
