// Fused ball query + gather of one or two feature tables with position
// channels, written straight into the grouped (B, M, K, C) layout.
//
// Replaces the TPU kernel ops/pallas_window.py::_window_kernel_t (called by
// windowed_ball_group_t, pallas_window.py:1022; its lane-major twin
// _window_kernel / windowed_ball_group, pallas_window.py:596, computes the
// same function and is served by this kernel too).  It ports the function,
// not the TPU windowing: no support sort, no query sort, no hi/lo bf16
// split, and the output is in original query order.
//
// Semantics, per query: the first <= K support points with d^2 < r^2 in
// original index order; slot k < count holds the k-th of them, slots past
// the count repeat the first.  For each table the slot's channels are
// [features (Ci), rel = abs - query (3), abs (3), query (3, optional)], all
// bfloat16, abs being the neighbour's exact float32 position.  An empty
// ball follows empty_mode: 0 = "center_zero" (zero features, abs = query,
// rel = 0; QueryAndGroup subset=False) or 1 = "row0" (every slot is
// support row 0; the reference ball query's zeroed idx).  counts (B, M)
// are capped at K.  The training route also asks for idx (B, M, K): the
// backward (csrc/group_scatter.cu) scatters the grouped cotangent by it.
//
// What bounds it on this card: bytes.  The grouped output (B*M*K*(Ci+6|9)
// bf16 per table, ~28 MB at the level-0 feature-transfer shapes) dwarfs the
// inputs; the scan costs ~9 float ops per (query, point) pair and stops at
// the K-th neighbour.  The first port (one warp a query scanning 32 points
// a step from global memory, then one 2-byte store per output element with
// a divide and a modulo each) ran 13x its byte bound.
//
// Design: one warp a query, kWarps warps a block, each warp taking
// `qpw` queries of one batch row in turn.
// - Scan: the block stages its batch row of the support in shared memory as
//   x / y / z arrays padded with +inf to a multiple of 32 * kPer (up to
//   kMaxStaged points; a larger support is read from global memory).  A
//   lane tests kPer points a step (lane, lane + 32, ...), so a step covers
//   32 * kPer points in index order; one __any_sync skips the hit
//   bookkeeping (a ballot, a popcount prefix and a slot store for each of
//   the kPer sub-steps) on the common step without a hit.  The scan stops
//   at the end of the step in which the count reaches K.  This scan is the
//   fused group's own: the ball query (#3) and the fused ball query +
//   gather (#8) keep common.cuh's, and all three give the same idx.
// - Write: the warp resolves each slot's source row once and writes its
//   position channels, rounded to bf16, to a per-warp table in shared
//   memory.  Then, for each table and each group of 8 slots, it assembles
//   the group's part of the output row in a shared-memory buffer: table
//   rows arrive as the widest vector (16, 8, 4 or 2 bytes) that C and the
//   table's alignment allow, position channels from the slot table, slot
//   and channel stepped incrementally (no divide per element).  The buffer
//   goes out with 16-byte stores, consecutive lanes on consecutive 16
//   bytes; the unaligned head and tail elements of a group, if any, with
//   2-byte stores.
// A null out0 skips the write (counts and idx are still written): it
// measures the scan's share of the time.
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMaxK = 64;
constexpr int kPer = 4;  // points a lane tests a scan step
constexpr int kStep = 32 * kPer;
constexpr int kMaxStaged = 8192;  // support points staged in shared memory
constexpr int kGroupSlots = 8;  // slots assembled in the buffer at a time
constexpr int kPosCols = 9;

typedef unsigned short bf16_bits;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// per-warp shared memory: slots, source rows, position channels, buffer
__host__ __device__ inline int warp_bytes(int buf_elems) {
  return 2 * kMaxK * 4 + kMaxK * kPosCols * 2 + buf_elems * 2;
}

__host__ __device__ inline int buf_elems(int cout_max) {
  return round_up(kGroupSlots * cout_max + 8, 8);
}

// the first <= K support points in the ball, in index order, into slots;
// returns the count capped at K (slots visible to the whole warp)
template <bool kStaged>
__device__ __forceinline__ int ball_scan(const float* sx, const float* sy, const float* sz,
                                         const float* __restrict__ pts, int N, int end,
                                         float qx, float qy, float qz, float r2, int K,
                                         int* slots, int lane) {
  const unsigned below = (1u << lane) - 1u;
  int cnt = 0;
  for (int base = 0; base < end && cnt < K; base += kStep) {
    unsigned hits = 0u;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int n = base + 32 * j + lane;
      float x, y, z;
      if (kStaged) {  // padded with +inf: never in the ball
        x = sx[n];
        y = sy[n];
        z = sz[n];
      } else if (n < N) {
        x = __ldg(pts + 3 * n);
        y = __ldg(pts + 3 * n + 1);
        z = __ldg(pts + 3 * n + 2);
      } else {
        x = y = z = INFINITY;
      }
      hits |= static_cast<unsigned>(pdr_sqdist3(x, y, z, qx, qy, qz) < r2) << j;
    }
    if (__any_sync(PDR_FULL_MASK, hits != 0u)) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const bool hit = (hits >> j) & 1u;
        const unsigned bal = __ballot_sync(PDR_FULL_MASK, hit);
        const int rank = cnt + __popc(bal & below);
        if (hit && rank < K) slots[rank] = base + 32 * j + lane;
        cnt += __popc(bal);
      }
    }
  }
  __syncwarp();
  return min(cnt, K);
}

// w consecutive bf16 of a table row into buf (w = 8, 4, 2 or 1; src < 0
// gives zeros)
__device__ __forceinline__ void copy_vec(const bf16_bits* __restrict__ row, int w,
                                         bf16_bits* dst) {
  union {
    uint4 u4;
    uint2 u2;
    unsigned u1;
    bf16_bits h[8];
  } v;
  v.u4 = make_uint4(0u, 0u, 0u, 0u);
  if (row != nullptr) {
    if (w == 8) {
      v.u4 = __ldg(reinterpret_cast<const uint4*>(row));
    } else if (w == 4) {
      v.u2 = __ldg(reinterpret_cast<const uint2*>(row));
    } else if (w == 2) {
      v.u1 = __ldg(reinterpret_cast<const unsigned*>(row));
    } else {
      v.h[0] = __ldg(row);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < w) dst[j] = v.h[j];
  }
}

// one table's K * cout output row of one query
__device__ __forceinline__ void write_table(const bf16_bits* __restrict__ tab, int C, int w,
                                            bf16_bits* __restrict__ out, size_t row_start,
                                            const int* srcs, const bf16_bits* pos, int pc,
                                            bf16_bits* buf, int K, int lane) {
  const int cout = C + pc;
  const int nvec = C / w;
  const int vq = 32 / nvec, vr = 32 % nvec;  // a 32-vector step in (slot, vector)
  const int pq = 32 / pc, pr = 32 % pc;  // a 32-element step in (slot, channel)
  for (int k0 = 0; k0 < K; k0 += kGroupSlots) {
    const int ns = min(kGroupSlots, K - k0);
    const size_t g0 = row_start + static_cast<size_t>(k0) * cout;  // first element
    const size_t gbase = g0 & ~static_cast<size_t>(7);  // buf[0] <-> out[gbase]
    const int off = static_cast<int>(g0 - gbase);
    const size_t gend = g0 + static_cast<size_t>(ns) * cout;
    // features: vector v of slot s
    {
      int s = lane / nvec, v = lane - (lane / nvec) * nvec;
      while (s < ns) {
        const int src = srcs[k0 + s];
        const bf16_bits* row =
            src >= 0 ? tab + static_cast<size_t>(src) * C + v * w : nullptr;
        copy_vec(row, w, buf + off + s * cout + v * w);
        s += vq;
        v += vr;
        if (v >= nvec) {
          v -= nvec;
          ++s;
        }
      }
    }
    // position channels: channel p of slot s
    {
      int s = lane / pc, p = lane - (lane / pc) * pc;
      while (s < ns) {
        buf[off + s * cout + C + p] = pos[(k0 + s) * kPosCols + p];
        s += pq;
        p += pr;
        if (p >= pc) {
          p -= pc;
          ++s;
        }
      }
    }
    __syncwarp();
    const int nchunks = static_cast<int>((gend - gbase + 7) / 8);
    for (int c = lane; c < nchunks; c += 32) {
      const size_t g = gbase + static_cast<size_t>(c) * 8;
      if (g >= g0 && g + 8 <= gend) {
        *reinterpret_cast<uint4*>(out + g) = *reinterpret_cast<const uint4*>(buf + 8 * c);
      } else {
        for (int j = 0; j < 8; ++j) {
          if (g + j >= g0 && g + j < gend) out[g + j] = buf[8 * c + j];
        }
      }
    }
    __syncwarp();
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kWarps * 32)
ball_group_kernel(const float* __restrict__ support, const float* __restrict__ queries,
                  int N, int M, int K, float r2, int include_center, int empty_mode, int qpw,
                  int buf_len, const bf16_bits* __restrict__ tab0, int C0, int w0,
                  bf16_bits* __restrict__ out0, const bf16_bits* __restrict__ tab1, int C1,
                  int w1, bf16_bits* __restrict__ out1, int* __restrict__ counts,
                  int* __restrict__ idx) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const float* pts = support + static_cast<size_t>(b) * N * 3;
  const int npad = round_up(N, kStep);
  float* sx = reinterpret_cast<float*>(smem);
  float* sy = sx + npad;
  float* sz = sy + npad;
  unsigned char* mine = smem + (kStaged ? 3 * npad * 4 : 0) + warp * warp_bytes(buf_len);
  int* slots = reinterpret_cast<int*>(mine);
  int* srcs = slots + kMaxK;
  bf16_bits* pos = reinterpret_cast<bf16_bits*>(srcs + kMaxK);
  bf16_bits* buf = pos + kMaxK * kPosCols;

  if (kStaged) {
    for (int f = threadIdx.x; f < 3 * npad; f += blockDim.x) {
      const int i = f / 3;
      const int c = f - 3 * i;
      (c == 0 ? sx : c == 1 ? sy : sz)[i] = f < 3 * N ? pts[f] : INFINITY;
    }
    __syncthreads();
  }

  const bool center_zero = empty_mode == 0;
  const int pc = include_center ? 9 : 6;
  const size_t nb = static_cast<size_t>(b) * N;
  for (int j = 0; j < qpw; ++j) {
    const int m = (blockIdx.x * qpw + j) * kWarps + warp;
    if (m >= M) break;  // warp-uniform
    const size_t qrow = static_cast<size_t>(b) * M + m;
    const float qx = queries[qrow * 3];
    const float qy = queries[qrow * 3 + 1];
    const float qz = queries[qrow * 3 + 2];
    const int cnt = ball_scan<kStaged>(sx, sy, sz, pts, N, kStaged ? npad : N, qx, qy, qz,
                                       r2, K, slots, lane);
    if (lane == 0) counts[qrow] = cnt;
    const int first = cnt > 0 ? slots[0] : 0;
    // each slot's source row (-1: an empty ball under center_zero) and its
    // position channels
    for (int k = lane; k < K; k += 32) {
      const int nbr = k < cnt ? slots[k] : first;
      if (idx != nullptr) idx[qrow * K + k] = nbr;
      const int src = (cnt == 0 && center_zero) ? -1 : nbr;
      srcs[k] = src;
      float ax = qx, ay = qy, az = qz;
      if (src >= 0) {
        if (kStaged) {
          ax = sx[src];
          ay = sy[src];
          az = sz[src];
        } else {
          ax = pts[3 * src];
          ay = pts[3 * src + 1];
          az = pts[3 * src + 2];
        }
      }
      const float v[kPosCols] = {__fsub_rn(ax, qx), __fsub_rn(ay, qy), __fsub_rn(az, qz),
                                 ax, ay, az, qx, qy, qz};
#pragma unroll
      for (int p = 0; p < kPosCols; ++p) {
        pos[k * kPosCols + p] = __bfloat16_as_ushort(__float2bfloat16_rn(v[p]));
      }
    }
    __syncwarp();
    if (out0 != nullptr) {
      write_table(tab0 + nb * C0, C0, w0, out0, qrow * K * (C0 + pc), srcs, pos, pc, buf,
                  K, lane);
      if (tab1 != nullptr) {
        write_table(tab1 + nb * C1, C1, w1, out1, qrow * K * (C1 + pc), srcs, pos, pc,
                    buf, K, lane);
      }
    }
    __syncwarp();  // slots, srcs and pos are rewritten by the next query
  }
}

// the widest vector (in bf16 elements) that every row of a (B, N, C) table
// starts on
int vec_width(const void* tab, int C) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(tab);
  for (int w = 8; w > 1; w /= 2) {
    if (C % w == 0 && a % (2 * w) == 0) return w;
  }
  return 1;
}

}  // namespace

// support (B, N, 3) f32, queries (B, M, 3) f32, tab0 (B, N, C0) bf16 and an
// optional tab1 (B, N, C1) bf16 (null when absent) -> out_i (B, M, K, Ci+6|9)
// bf16, counts (B, M) i32 and, when idx is not null, idx (B, M, K) i32 (the
// neighbours' original support indices, which the backward scatters by).
// qpw: queries a warp takes in turn.  K <= 64 (checked by the caller); a
// null out0 writes counts and idx only.
extern "C" int pdr_ball_group(const void* support, const void* queries, int B, int N,
                              int M, int K, float r2, int include_center,
                              int empty_mode, int qpw, const void* tab0, int C0,
                              void* out0, const void* tab1, int C1, void* out1,
                              void* counts, void* idx, void* stream) {
  if (K < 1 || K > kMaxK || qpw < 1 || M < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int pc = include_center ? 9 : 6;
  const int blen = buf_elems((tab1 != nullptr && C1 > C0 ? C1 : C0) + pc);
  const int per_warps = kWarps * warp_bytes(blen);
  const int staged_bytes = 3 * round_up(N, kStep) * 4;
  const bool staged = N <= kMaxStaged;
  const int smem = per_warps + (staged ? staged_bytes : 0);
  const dim3 grid((M + kWarps * qpw - 1) / (kWarps * qpw), B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sup = static_cast<const float*>(support);
  const float* q = static_cast<const float*>(queries);
  const bf16_bits* t0 = static_cast<const bf16_bits*>(tab0);
  const bf16_bits* t1 = static_cast<const bf16_bits*>(tab1);
  const int w0 = vec_width(tab0, C0);
  const int w1 = tab1 != nullptr ? vec_width(tab1, C1) : 1;
  auto kernel = staged ? ball_group_kernel<true> : ball_group_kernel<false>;
  static int allowed[2] = {0, 0};  // the dynamic shared memory each variant may take
  if (smem > allowed[staged]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[staged] = smem;
  }
  kernel<<<grid, kWarps * 32, smem, s>>>(
      sup, q, N, M, K, r2, include_center, empty_mode, qpw, blen, t0, C0, w0,
      static_cast<bf16_bits*>(out0), t1, C1, w1, static_cast<bf16_bits*>(out1),
      static_cast<int*>(counts), static_cast<int*>(idx));
  PDR_RETURN_LAUNCH_ERROR();
}
