// Ball query + gather of float32 table rows in one kernel.
//
// Replaces the TPU kernel ops/pallas_neighbors.py::_ball_query_group_kernel
// (called by ball_query_group_pallas, pallas_neighbors.py:380).  It ports
// the function, not the block: the TPU kernel gathers with one-hot MXU
// products against a hi/lo bf16 split of the table (about 16 mantissa bits)
// and rebuilds the index from an appended lane column; here a gather is an
// indexed load, so the gathered values are the exact float32 table rows.
//
// Semantics, per centre: the first <= K support points with d^2 < r^2 in
// index order (pdr_sqdist3, so idx and counts equal csrc/ball_query.cu's
// and csrc/ball_group.cu's bit for bit); slot k < count holds the k-th of
// them, slots past the count repeat the first, an empty ball takes row 0 in
// every slot; counts (B, M) are capped at K; any K >= 1, K > N included.
// gathered[b, m, k, :] = table[b, idx[b, m, k], :].
//
// What bounds it on this card: bytes.  The gathered output (B*M*K*C float32,
// 37 MB at the level-0 feature-transfer shape with C = 35 and B = 4, 294 MB
// at the training batch B = 32) dwarfs the inputs; the scan costs ~9 float
// ops per (centre, point) pair and stops at the K-th neighbour.  The first
// port scanned 32 points a step from global memory with the bookkeeping on
// every step, then copied the rows one 4-byte element a lane with a divide
// and a modulo each (6x its byte bound).
//
// Design: one warp a centre, kWarps warps a block, each warp taking `qpw`
// centres of one batch row in turn (the caller picks qpw from the query
// count: ops/neighbors.py::gather_queries_per_warp).
// - Scan: ball_scan.cuh's staged scan, shared with the fused ball group
//   (#2), in passes of kPass slots for any K.
// - Write: a centre's output row is K * C contiguous float32.  Each pass's
//   slots are resolved (repeat-first padding) into the warp's slot buffer
//   and the idx row, then a group of `group` slots is assembled in a
//   per-warp shared-memory buffer by 4-byte asynchronous copies (cp.async),
//   all in flight at once (a loop of reads and stores would wait out an L2
//   read's latency for every element), lanes on consecutive (slot, channel)
//   pairs stepped incrementally (no divide), and written with 16-byte
//   stores, consecutive lanes on consecutive 16 bytes, the unaligned head
//   and tail of the group one float at a time (every launch of a DDPM
//   training step has rows of C = 3 + 4k channels, never 16-byte aligned);
//   - a row too wide for the buffer (group = 0) goes one float a lane,
//     coalesced.
#include <cstdint>

#include "ball_scan.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kPass = 64;  // slots a warp holds: the scan's pass
constexpr int kMaxGroup = 8;  // slots assembled in the buffer at a time
constexpr int kBufFloats = 1024;  // the largest per-warp assembly buffer

// floats of the per-warp assembly buffer for groups of `group` slots of C
// floats (16-byte multiple; room for a 3-float head)
__host__ __device__ inline int buf_floats(int group, int C) {
  return group > 0 ? pdr_round_up(group * C + 4, 4) : 0;
}

// an asynchronous copy of one float from global to shared memory;
// cp_async_wait() waits for the calling lane's copies
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// slots [lo, hi) of one centre's output row (elements [start, start + K*C)
// of `gathered`), assembled `group` slots at a time in buf
__device__ __forceinline__ void copy_assembled(const float* __restrict__ tab, int C,
                                               int group, float* __restrict__ gathered,
                                               size_t start, const int* slots, int lo,
                                               int hi, float* buf, int lane) {
  const int cq = 32 / C, cr = 32 % C;  // a 32-float step in (slot, channel)
  for (int k0 = lo; k0 < hi; k0 += group) {
    const int ns = min(group, hi - k0);
    const size_t g0 = start + static_cast<size_t>(k0) * C;  // first element
    const size_t gbase = g0 & ~static_cast<size_t>(3);  // buf[0] <-> gathered[gbase]
    const int off = static_cast<int>(g0 - gbase);
    const size_t gend = g0 + static_cast<size_t>(ns) * C;
    int s = lane / C, c = lane - (lane / C) * C;
    while (s < ns) {
      cp_async(buf + off + s * C + c, tab + static_cast<size_t>(slots[k0 - lo + s]) * C + c);
      s += cq;
      c += cr;
      if (c >= C) {
        c -= C;
        ++s;
      }
    }
    cp_async_wait();
    __syncwarp();
    const int nchunks = static_cast<int>((gend - gbase + 3) / 4);
    for (int q = lane; q < nchunks; q += 32) {
      const size_t g = gbase + static_cast<size_t>(q) * 4;
      if (g >= g0 && g + 4 <= gend) {
        *reinterpret_cast<float4*>(gathered + g) =
            *reinterpret_cast<const float4*>(buf + 4 * q);
      } else {
        for (int j = 0; j < 4; ++j) {
          if (g + j >= g0 && g + j < gend) gathered[g + j] = buf[4 * q + j];
        }
      }
    }
    __syncwarp();
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kWarps * 32)
ball_query_group_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
                        const float* __restrict__ table, int N, int M, int K, int C,
                        float r2, int qpw, int group, float* __restrict__ gathered,
                        int* __restrict__ idx, int* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const float* pts = xyz + static_cast<size_t>(b) * N * 3;
  const int npad = pdr_round_up(N, kScanStep);
  float* sx = reinterpret_cast<float*>(smem);
  float* sy = sx + npad;
  float* sz = sy + npad;
  const int per_warp = 4 * kPass + 4 * buf_floats(group, C);  // bytes, a multiple of 16
  unsigned char* mine = smem + (kStaged ? 3 * npad * 4 : 0) + warp * per_warp;
  int* slots = reinterpret_cast<int*>(mine);
  float* buf = reinterpret_cast<float*>(slots + kPass);

  if (kStaged) pdr_stage_support(pts, N, sx, sy, sz);

  const float* tab = table + static_cast<size_t>(b) * N * C;
  for (int j = 0; j < qpw; ++j) {
    const int m = (blockIdx.x * qpw + j) * kWarps + warp;
    if (m >= M) break;  // warp-uniform
    const size_t qrow = static_cast<size_t>(b) * M + m;
    const float qx = centers[qrow * 3];
    const float qy = centers[qrow * 3 + 1];
    const float qz = centers[qrow * 3 + 2];
    const size_t start = qrow * K * C;
    PdrScanState st;
    int cnt = 0, first = 0;
    bool done = false;
    for (int lo = 0; lo < K; lo += kPass) {
      const int hi = min(K, lo + kPass);
      if (!done) {
        cnt = pdr_ball_scan_pass<kStaged>(sx, sy, sz, pts, N, qx, qy, qz, r2, lo, hi, slots,
                                          lane, st);
        if (lo == 0 && cnt > 0) first = slots[0];
        done = cnt < hi;  // else the next pass resumes the scan
      }
      // repeat-first padding; row 0 for an empty ball
      for (int k = lo + lane; k < hi; k += 32) {
        const int s = k < cnt ? slots[k - lo] : first;
        slots[k - lo] = s;
        idx[qrow * K + k] = s;
      }
      __syncwarp();
      if (group > 0) {
        copy_assembled(tab, C, group, gathered, start, slots, lo, hi, buf, lane);
      } else {
        for (int k = lo; k < hi; ++k) {
          const float* src = tab + static_cast<size_t>(slots[k - lo]) * C;
          float* dst = gathered + start + static_cast<size_t>(k) * C;
          for (int c = lane; c < C; c += 32) dst[c] = __ldg(src + c);
        }
      }
      __syncwarp();  // the slots are rewritten by the next pass
    }
    if (lane == 0) counts[qrow] = min(cnt, K);
  }
}

}  // namespace

// xyz (B, N, 3) f32, centers (B, M, 3) f32, table (B, N, C) f32 ->
// gathered (B, M, K, C) f32, idx (B, M, K) i32, counts (B, M) i32.  qpw:
// centres a warp takes in turn; the gathered output is 16-byte aligned.
extern "C" int pdr_ball_query_group(const void* xyz, const void* centers,
                                    const void* table, int B, int N, int M, int K, int C,
                                    float r2, int qpw, void* gathered, void* idx, void* counts,
                                    void* stream) {
  if (K < 1 || C < 1 || M < 1 || qpw < 1 || reinterpret_cast<uintptr_t>(gathered) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int group = min(kMaxGroup, (kBufFloats - 4) / C);
  const int smem = kWarps * (4 * kPass + 4 * buf_floats(group, C)) + pdr_staged_bytes(N);
  const bool staged = N <= kScanMaxStaged;
  auto kernel = staged ? ball_query_group_kernel<true> : ball_query_group_kernel<false>;
  static int allowed[2] = {0, 0};  // the dynamic shared memory each variant may take
  if (smem > allowed[staged]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[staged] = smem;
  }
  const dim3 grid((M + kWarps * qpw - 1) / (kWarps * qpw), B);
  kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(centers),
      static_cast<const float*>(table), N, M, K, C, r2, qpw, group,
      static_cast<float*>(gathered), static_cast<int*>(idx), static_cast<int*>(counts));
  PDR_RETURN_LAUNCH_ERROR();
}
