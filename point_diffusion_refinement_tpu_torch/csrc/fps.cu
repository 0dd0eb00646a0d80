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
// a chain in which every step needs the argmax of the one before, so what a
// pick costs is the per-thread scan plus the block's argmax: its barriers,
// reductions and shared-memory round trips.
//
// Design: one block per batch row.  While a row fits shared memory
// (N <= 12288, FPS_SMEM_MAX_POINTS in ops/sampling.py) each thread keeps its
// kPer points (i = tid + k * kThreads) and their running minimum distances
// in registers; shared memory holds only an (x, y, z, 0) copy of the row,
// from which every thread reads the last pick's position by broadcast.  The
// wrapper picks (kThreads, kPer) from N out of PDR_FPS_CONFIGS.  A pick:
//   1. each thread updates its minima and takes its argmax in up to four
//      independent chains over consecutive k, joined in order (strict >
//      keeps the lowest index);
//   2. the warp's argmax by redux.sync in hardware: the maximum of a 32-bit
//      key that is monotone in the distance (argmax_key), then the least
//      index among the lanes that hold it;
//   3. each warp writes its (key, index) to a slot of a buffer that is
//      double-buffered by pick parity, one __syncthreads, and every warp
//      reduces the candidates itself the same way: one barrier a pick, no
//      broadcast of the pick through shared memory.  The barrier of pick
//      j+1 lies between pick j's reads and pick j+2's writes of a buffer;
//   4. thread 0 writes idx[j], and the coordinates one pick later, from the
//      broadcast read every thread makes anyway.
// Padding starts at a minimum of -1 and slots past N at -inf, so a min with
// a distance >= 0 keeps both out for good; both map to key 0, below every
// real point (key >= 1), and an all-padding row ends on index 0, which
// holds key 0 and the lowest index.
//
// Rows beyond shared memory (up to N = 2^18): the row's x, y, z planes and
// its running minimum live in a global-memory workspace of (B, 4, N) floats
// that the wrapper allocates (a 2^18-point row is 4 MB and stays in the
// 50 MB L2); 1024 threads scan it strided and take the same block argmax.
// A thread-block cluster sharing its distributed shared memory would keep
// a large row on chip; that is a later optimisation.
#include "common.cuh"

// (threads, points a thread) of the register path; ops/sampling.py keeps the
// same list (FPS_CONFIGS) and chooses from it by N.  The first seven are its
// choices (FPS_BLOCKS), the rest the runners-up that chip_smoke.py times
// beside them.
#ifndef PDR_FPS_CONFIGS
#define PDR_FPS_CONFIGS(X) \
  X(256, 4) X(256, 8) X(512, 6) X(256, 16) X(256, 24) X(256, 32) X(256, 48) \
  X(128, 16) X(512, 4) X(256, 12) X(128, 32) X(512, 24)
#endif

namespace {

constexpr int kGlobalThreads = 1024;
constexpr float kPadNormSq = 1e-3f;
constexpr unsigned kNoIndex = 0xffffffffu;

// Argmax key of a running minimum: a float >= 0 read as unsigned is
// monotone, +1 lifts every real point (a duplicate at distance 0 included)
// above padding (-1) and empty slots (-inf), which take key 0.
__device__ __forceinline__ unsigned argmax_key(float m) {
  return m >= 0.f ? __float_as_uint(m) + 1u : 0u;
}

__device__ __forceinline__ float norm_sq(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// The block's argmax of one (key, index) a thread: the largest key, ties to
// the least index; red[parity] takes one candidate a warp.  Every thread
// returns the pick.
template <int kWarps>
__device__ __forceinline__ unsigned block_pick(unsigned key, unsigned idx,
                                               uint2 (*red)[32], int parity,
                                               int lane, int warp) {
  unsigned best = __reduce_max_sync(PDR_FULL_MASK, key);
  const unsigned at = __reduce_min_sync(PDR_FULL_MASK, key == best ? idx : kNoIndex);
  if (lane == 0) red[parity][warp] = make_uint2(best, at);
  __syncthreads();
  const uint2 c = lane < kWarps ? red[parity][lane] : make_uint2(0u, kNoIndex);
  best = __reduce_max_sync(PDR_FULL_MASK, c.x);
  return __reduce_min_sync(PDR_FULL_MASK, c.x == best ? c.y : kNoIndex);
}

// Register path: N <= kThreads * kPer, the row copy in dynamic shared memory.
template <bool kCoords, int kThreads, int kPer>
__global__ void __launch_bounds__(kThreads, 1)
fps_reg_kernel(const float* __restrict__ xyz, int N, int npoint,
               int* __restrict__ idx, float* __restrict__ coords) {
  extern __shared__ float4 s_xyz[];
  __shared__ uint2 red[2][32];
  constexpr int kWarps = kThreads / 32;
  // chains of the per-thread argmax: up to four, over consecutive k
  constexpr int kLen = (kPer + 3) / 4;
  constexpr int kChains = (kPer + kLen - 1) / kLen;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* p = xyz + static_cast<size_t>(b) * N * 3;
  int* out_idx = idx + static_cast<size_t>(b) * npoint;
  float* out_co = kCoords ? coords + static_cast<size_t>(b) * npoint * 3 : nullptr;
  if (npoint <= 0) return;

  float x[kPer], y[kPer], z[kPer], m[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = tid + k * kThreads;
    x[k] = y[k] = z[k] = 0.f;
    m[k] = -INFINITY;
    if (i < N) {
      x[k] = p[3 * i];
      y[k] = p[3 * i + 1];
      z[k] = p[3 * i + 2];
      m[k] = norm_sq(x[k], y[k], z[k]) > kPadNormSq ? 1e10f : -1.0f;
      s_xyz[i] = make_float4(x[k], y[k], z[k], 0.f);
    }
  }
  __syncthreads();
  const bool writer = tid == 0;
  if (writer) out_idx[0] = 0;
  unsigned old = 0;
  for (int j = 1; j < npoint; ++j) {
    const float4 q = s_xyz[old];
    if (kCoords && writer) {
      out_co[3 * (j - 1)] = q.x;
      out_co[3 * (j - 1) + 1] = q.y;
      out_co[3 * (j - 1) + 2] = q.z;
    }
    float bv[kChains];
    int bk[kChains];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      m[k] = fminf(m[k], pdr_sqdist3(x[k], y[k], z[k], q.x, q.y, q.z));
      const int c = k / kLen;
      if (k % kLen == 0 || m[k] > bv[c]) {  // ascending k: strict > keeps the lowest
        bv[c] = m[k];
        bk[c] = k;
      }
    }
#pragma unroll
    for (int s = 1; s < kChains; s <<= 1) {
#pragma unroll
      for (int c = 0; c + s < kChains; c += 2 * s) {
        if (bv[c + s] > bv[c]) {  // chain c holds the lower indices
          bv[c] = bv[c + s];
          bk[c] = bk[c + s];
        }
      }
    }
    old = block_pick<kWarps>(argmax_key(bv[0]), tid + bk[0] * kThreads, red, j & 1,
                             lane, warp);
    if (writer) out_idx[j] = static_cast<int>(old);
  }
  if (kCoords && writer) {
    const float4 q = s_xyz[old];
    out_co[3 * (npoint - 1)] = q.x;
    out_co[3 * (npoint - 1) + 1] = q.y;
    out_co[3 * (npoint - 1) + 2] = q.z;
  }
}

// Global-workspace path: the x, y, z planes and the running minimum of the
// row in `work` (B, 4, N), 1024 threads over it strided.
template <bool kCoords>
__global__ void __launch_bounds__(kGlobalThreads, 1)
fps_global_kernel(const float* __restrict__ xyz, int N, int npoint,
                  int* __restrict__ idx, float* __restrict__ coords,
                  float* __restrict__ work) {
  __shared__ uint2 red[2][32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* sx = work + static_cast<size_t>(b) * 4 * N;
  float* sy = sx + N;
  float* sz = sy + N;
  float* mind = sz + N;
  const float* p = xyz + static_cast<size_t>(b) * N * 3;
  int* out_idx = idx + static_cast<size_t>(b) * npoint;
  float* out_co = kCoords ? coords + static_cast<size_t>(b) * npoint * 3 : nullptr;
  if (npoint <= 0) return;

  for (int i = tid; i < N; i += kGlobalThreads) {
    const float x = p[3 * i], y = p[3 * i + 1], z = p[3 * i + 2];
    sx[i] = x;
    sy[i] = y;
    sz[i] = z;
    mind[i] = norm_sq(x, y, z) > kPadNormSq ? 1e10f : -1.0f;
  }
  __syncthreads();  // orders the workspace writes for the whole block
  const bool writer = tid == 0;
  if (writer) out_idx[0] = 0;
  unsigned old = 0;
  for (int j = 1; j < npoint; ++j) {
    const float qx = sx[old], qy = sy[old], qz = sz[old];
    if (kCoords && writer) {
      out_co[3 * (j - 1)] = qx;
      out_co[3 * (j - 1) + 1] = qy;
      out_co[3 * (j - 1) + 2] = qz;
    }
    float best = -INFINITY;
    unsigned besti = kNoIndex;
    for (int i = tid; i < N; i += kGlobalThreads) {
      const float m = fminf(mind[i], pdr_sqdist3(sx[i], sy[i], sz[i], qx, qy, qz));
      mind[i] = m;
      if (m > best) {  // ascending i: strict > keeps the lowest index
        best = m;
        besti = i;
      }
    }
    old = block_pick<kGlobalThreads / 32>(argmax_key(best), besti, red, j & 1, lane, warp);
    if (writer) out_idx[j] = static_cast<int>(old);
  }
  if (kCoords && writer) {
    out_co[3 * (npoint - 1)] = sx[old];
    out_co[3 * (npoint - 1) + 1] = sy[old];
    out_co[3 * (npoint - 1) + 2] = sz[old];
  }
}

template <bool kCoords, int kThreads, int kPer>
int launch_reg(const float* xyz, int B, int N, int npoint, int* idx, float* coords,
               cudaStream_t s) {
  const auto kern = fps_reg_kernel<kCoords, kThreads, kPer>;
  // once per instantiation: room for the largest row it takes
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kThreads * kPer * sizeof(float4)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kern<<<B, kThreads, static_cast<size_t>(N) * sizeof(float4), s>>>(xyz, N, npoint, idx,
                                                                     coords);
  PDR_RETURN_LAUNCH_ERROR();
}

// work == nullptr: the register path at (threads, per), which must be one
// of PDR_FPS_CONFIGS with N <= threads * per; otherwise the workspace path.
template <bool kCoords>
int launch_fps(const void* xyz, int B, int N, int npoint, void* idx, void* coords,
               void* work, int threads, int per, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const float*>(xyz);
  auto* i = static_cast<int*>(idx);
  auto* c = static_cast<float*>(coords);
  if (work != nullptr) {
    fps_global_kernel<kCoords><<<B, kGlobalThreads, 0, s>>>(x, N, npoint, i, c,
                                                           static_cast<float*>(work));
    PDR_RETURN_LAUNCH_ERROR();
  }
#define PDR_FPS_TRY(T, P) \
  if (threads == (T) && per == (P) && N <= (T) * (P)) \
    return launch_reg<kCoords, (T), (P)>(x, B, N, npoint, i, c, s);
  PDR_FPS_CONFIGS(PDR_FPS_TRY)
#undef PDR_FPS_TRY
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// xyz (B, N, 3) f32 -> idx (B, npoint) i32, coords (B, npoint, 3) f32;
// work is nullptr (register path at threads x per) or a (B, 4, N) f32
// scratch for rows beyond shared memory.
extern "C" int pdr_fps_coords(const void* xyz, int B, int N, int npoint, void* idx,
                              void* coords, void* work, int threads, int per,
                              void* stream) {
  return launch_fps<true>(xyz, B, N, npoint, idx, coords, work, threads, per, stream);
}

// xyz (B, N, 3) f32 -> idx (B, npoint) i32; work, threads and per as for
// pdr_fps_coords.
extern "C" int pdr_fps_idx(const void* xyz, int B, int N, int npoint, void* idx,
                           void* work, int threads, int per, void* stream) {
  return launch_fps<false>(xyz, B, N, npoint, idx, nullptr, work, threads, per, stream);
}
