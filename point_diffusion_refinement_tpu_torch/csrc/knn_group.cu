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
// What bounds it on this card: bytes, the k rows of C + 11 bf16 values
// written per query (22 MB at the level-0 feature propagation of a B=4
// denoise step); the selection costs ~10 operations per (query, point) pair.
// The first port (one thread a query with a k-deep insertion chain, 64
// blocks at that shape, then one warp per output row with 2-byte stores)
// ran 40x its byte bound.
//
// Design, in two phases of one block of 256 threads:
// - Selection: knn.cu's, shared through knn_select.cuh: G lanes a query
//   (the caller picks G from the query count, as for knn), each lane's
//   sorted list in registers, k rounds of a lexicographic (distance, index)
//   minimum, any 1 <= k <= N.  Lane 0 of a query writes each (distance,
//   index) pair to a (B, M, k) scratch as the group emits it, in slot
//   order, and sums the inverse distances of the weights' denominator in
//   that same order.
// - Write: after one block barrier, each warp takes the block's queries in
//   turn.  A query's k * (C + 11) output values are one contiguous run; the
//   warp assembles it in a shared-memory buffer aligned to the output's
//   16-byte grid, a group of whole slots at a time: table rows arrive as the
//   widest vector (16, 8, 4 or 2 bytes) that C and the table's address
//   allow, position channels are computed from the float32 support and
//   rounded to bf16 once.  The buffer leaves as aligned 16-byte stores, the
//   group's unaligned head and tail as 2-byte stores.  A row wider than the
//   buffer is assembled by values instead, each lane stepping (slot,
//   channel) by 32 with no divide per value.
#include <cuda_bf16.h>

#include <cstdint>

#include "knn_select.cuh"

namespace {

typedef unsigned short bf16_bits;

constexpr int kThreads = pdr_select::kSelectThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 1024;  // output values a warp assembles at a time
constexpr int kPosCols = 11;
constexpr int kUnroll = 4;  // values a lane assembles per step

__device__ __forceinline__ bf16_bits to_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// One query's selection, read back from the scratch by the write phase.
struct Query {
  const float* d;  // its k distances
  const int* i;    // its k neighbours
  float wsum, qx, qy, qz;
};

// Position channel p (0..10) of slot s: squared distance, inverse-distance
// weight, neighbour xyz, neighbour - query, query xyz, rounded to bf16 once.
__device__ __forceinline__ bf16_bits pos_value(const Query& q, const float* pts, int s, int src,
                                               int p) {
  const float d = q.d[s];
  float f;
  if (p == 0) {
    f = d;
  } else if (p == 1) {
    f = (1.0f / (d + 1e-8f)) / q.wsum;
  } else {
    const int ax = (p - 2) % 3;
    const float pa = pts[static_cast<size_t>(src) * 3 + ax];
    const float qa = ax == 0 ? q.qx : (ax == 1 ? q.qy : q.qz);
    f = p < 5 ? pa : (p < 8 ? __fsub_rn(pa, qa) : qa);
  }
  return to_bits(f);
}

// buf[0 .. n) -> out[g .. g + n) for the values inside [lo, hi): aligned
// 16-byte stores, the unaligned head and tail as 2-byte stores (g is a
// multiple of 8)
__device__ __forceinline__ void store_run(bf16_bits* __restrict__ out, size_t g, int n,
                                          size_t lo, size_t hi, const bf16_bits* buf,
                                          int lane) {
  for (int v = lane; v * 8 < n; v += 32) {
    const size_t gv = g + static_cast<size_t>(v) * 8;
    if (gv >= lo && gv + 8 <= hi) {
      *reinterpret_cast<uint4*>(out + gv) = *reinterpret_cast<const uint4*>(buf + 8 * v);
    } else {
      for (int j = 0; j < 8; ++j) {
        if (gv + j >= lo && gv + j < hi) out[gv + j] = buf[8 * v + j];
      }
    }
  }
}

// The run in groups of whole slots, table rows read as vectors of wv
// values (8, 4, 2 or 1, as C and the table's alignment allow); each group
// of ns slots is assembled in buf at its 16-byte offset and stored.
__device__ void write_slots(const Query& q, const bf16_bits* __restrict__ tab,
                           const float* pts, int C, int W, int k, int wv,
                           bf16_bits* __restrict__ out, size_t run0, bf16_bits* buf,
                           int lane) {
  const int gs = max(1, (kChunk - 8) / W);  // slots a group
  const int nvec = C / wv;
  for (int k0 = 0; k0 < k; k0 += gs) {
    const int ns = min(gs, k - k0);
    const size_t g0 = run0 + static_cast<size_t>(k0) * W;
    const size_t gbase = g0 & ~static_cast<size_t>(7);
    const int off = static_cast<int>(g0 - gbase);
    for (int t = lane; t < ns * nvec; t += 32) {
      const int s = t / nvec;
      const int v = t - s * nvec;
      const bf16_bits* row = tab + static_cast<size_t>(q.i[k0 + s]) * C + v * wv;
      union {
        uint4 u4;
        uint2 u2;
        unsigned u1;
        bf16_bits h[8];
      } x;
      if (wv == 8) {
        x.u4 = __ldg(reinterpret_cast<const uint4*>(row));
      } else if (wv == 4) {
        x.u2 = __ldg(reinterpret_cast<const uint2*>(row));
      } else if (wv == 2) {
        x.u1 = __ldg(reinterpret_cast<const unsigned*>(row));
      } else {
        x.h[0] = __ldg(row);
      }
      bf16_bits* dst = buf + off + s * W + v * wv;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < wv) dst[j] = x.h[j];
      }
    }
    for (int t = lane; t < ns * kPosCols; t += 32) {
      const int s = t / kPosCols;
      const int p = t - s * kPosCols;
      buf[off + s * W + C + p] = pos_value(q, pts, k0 + s, q.i[k0 + s], p);
    }
    __syncwarp();
    const size_t gend = g0 + static_cast<size_t>(ns) * W;
    store_run(out, gbase, static_cast<int>(gend - gbase), g0, gend, buf, lane);
    __syncwarp();  // the buffer is rewritten by the next group
  }
}

// The run in chunks of kChunk values on the output's 16-byte grid, for rows
// wider than a chunk: each lane steps (slot, channel) by 32 values, no
// divide per value, kUnroll values a step with their loads issued first.
__device__ void write_run(const Query& q, const bf16_bits* __restrict__ tab, const float* pts,
                          int C, int W, int k, bf16_bits* __restrict__ out, size_t g0,
                          bf16_bits* buf, int lane) {
  const int pq = 32 / W, pr = 32 % W;  // a 32-value step in (slot, channel)
  const size_t gend = g0 + static_cast<size_t>(k) * W;
  for (size_t cs = g0 & ~static_cast<size_t>(7); cs < gend; cs += kChunk) {
    const int n_el = static_cast<int>(min(static_cast<size_t>(kChunk), gend - cs));
    // this lane's first value of the chunk at or after g0
    int e = lane;
    long long rel = static_cast<long long>(cs) - static_cast<long long>(g0) + lane;
    if (rel < 0) {
      e += 32;
      rel += 32;
    }
    int s = static_cast<int>(rel / W);
    int c = static_cast<int>(rel - static_cast<long long>(s) * W);
    for (; e < n_el; e += 32 * kUnroll) {
      bf16_bits v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        v[u] = 0;
        if (e + 32 * u < n_el) {
          const int src = q.i[s];
          v[u] = c < C ? __ldg(tab + static_cast<size_t>(src) * C + c)
                       : pos_value(q, pts, s, src, c - C);
        }
        s += pq;
        c += pr;
        if (c >= W) {
          c -= W;
          ++s;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (e + 32 * u < n_el) buf[e + 32 * u] = v[u];
      }
    }
    __syncwarp();
    store_run(out, cs, n_el, g0, gend, buf, lane);
    __syncwarp();  // the buffer is rewritten by the next chunk
  }
}

template <int L, int G>
__global__ void __launch_bounds__(kThreads)
knn_group_kernel(const float* __restrict__ query, const float* __restrict__ points,
                 const bf16_bits* __restrict__ table, int M, int N, int C, int k, int wv,
                 float* sdist, int* sidx, bf16_bits* __restrict__ out) {
  __shared__ float sx[pdr_select::kSelectTile];
  __shared__ float sy[pdr_select::kSelectTile];
  __shared__ float sz[pdr_select::kSelectTile];
  constexpr int kGroups = kThreads / G;
  __shared__ float swsum[kGroups];
  __shared__ __align__(16) bf16_bits sbuf[kWarps][kChunk];

  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kGroups;
  const float* pts = points + static_cast<size_t>(b) * N * 3;

  // ---- selection: (distance, index) pairs to the scratch, in slot order
  {
    const int lane = threadIdx.x % G;
    const int m = m0 + threadIdx.x / G;
    // a query past M computes on the last row and writes nothing
    const size_t qrow = static_cast<size_t>(b) * M + min(m, M - 1);
    const float qx = query[qrow * 3];
    const float qy = query[qrow * 3 + 1];
    const float qz = query[qrow * 3 + 2];
    const bool writes = m < M && lane == 0;
    float* od = sdist + qrow * k;
    int* oi = sidx + qrow * k;
    float wsum = 0.f;
    pdr_select::select<L, G>(pts, N, k, lane, qx, qy, qz, sx, sy, sz,
                          [&](int j, float d, int i) {
                            const float r = 1.0f / (d + 1e-8f);
                            wsum = j == 0 ? r : wsum + r;
                            if (writes) {
                              od[j] = d;
                              oi[j] = i;
                            }
                          });
    if (writes) swsum[threadIdx.x / G] = wsum;
  }
  __syncthreads();  // the scratch rows and sums of the block's queries

  // ---- write: one warp a query, its k * (C + 11) values as one run
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nq = min(kGroups, M - m0);
  const int W = C + kPosCols;
  const bf16_bits* tab = table + static_cast<size_t>(b) * N * C;
  bf16_bits* buf = sbuf[warp];
  for (int ql = warp; ql < nq; ql += kWarps) {
    const size_t qrow = static_cast<size_t>(b) * M + m0 + ql;
    const Query qu{sdist + qrow * k, sidx + qrow * k, swsum[ql], query[qrow * 3],
                   query[qrow * 3 + 1], query[qrow * 3 + 2]};
    if (wv > 0) {
      write_slots(qu, tab, pts, C, W, k, wv, out, qrow * k * W, buf, lane);
    } else {
      write_run(qu, tab, pts, C, W, k, out, qrow * k * W, buf, lane);
    }
  }
}

}  // namespace

// query (B, M, 3), points (B, N, 3) f32, table (B, N, C) bf16 ->
// out (B, M, k, C + 11) bf16: [table row, squared distance, inverse-distance
// weight, neighbour xyz, neighbour - query, query xyz].  1 <= k <= N,
// C >= 1 (checked by the caller); lanes a query: 1, 2, 4 or 8; dist (B, M,
// k) f32 and idx (B, M, k) i32 are scratch the kernel fills (the neighbours
// as knn gives them).
extern "C" int pdr_knn_group(const void* query, const void* points, const void* table,
                             int B, int M, int N, int C, int k, int lanes, void* dist,
                             void* idx, void* out, void* stream) {
  if (k < 1 || k > N || M < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* q = static_cast<const float*>(query);
  const float* p = static_cast<const float*>(points);
  const bf16_bits* t = static_cast<const bf16_bits*>(table);
  float* d = static_cast<float*>(dist);
  int* i = static_cast<int*>(idx);
  bf16_bits* o = static_cast<bf16_bits*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the widest vector every table row starts on, or 0 (by values) where a
  // slot's row does not fit the assembly buffer
  int wv = 0;
  if (C + kPosCols + 8 <= kChunk) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(table);
    wv = 1;
    for (int w = 8; w > 1; w /= 2) {
      if (C % w == 0 && a % (2 * w) == 0) {
        wv = w;
        break;
      }
    }
  }
  const bool ok = pdr_select::dispatch(lanes, k, [&](auto l, auto g) {
    constexpr int L = decltype(l)::value, G = decltype(g)::value;
    constexpr int kGroups = kThreads / G;
    const dim3 grid((M + kGroups - 1) / kGroups, B);
    knn_group_kernel<L, G><<<grid, kThreads, 0, s>>>(q, p, t, M, N, C, k, wv, d, i, o);
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  PDR_RETURN_LAUNCH_ERROR();
}
