// Scatter-add of grouped cotangents into table rows, in a fixed order:
//   out[b, n, c] = sum of dg[b, m, k, c] over the slots (m, k) with
//   idx[b, m, k] = n, taken in ascending flat slot order s = (b*M + m)*K + k
//   and starting from 0.0f.
//
// The deterministic counterpart of csrc/group_scatter.cu (kernel B), with
// the same contract: float32 or bfloat16 dg read in place with ``ld``
// elements between consecutive slots, int32 idx, optional ``counts`` whose
// zero entries skip the ball, a float32 (B, N, C) result.  Every backward
// of a gather in the port's training step runs through it (the grouping
// kernels' backwards, gather_points / group_points, the class embedding,
// PVCNN's voxel transfers).  It replaces no TPU kernel: the JAX package's
// backwards are one-hot einsums (models/grouping.py::_fused_ball_gather_bwd),
// whose sums XLA takes in a fixed order, so its jitted step repeats run to
// run; kernel B's float32 atomics land in an order that changes from run to
// run, and so did the port's training step.  The order here is the one of
// the plain version (ops/scatter.py, a serial index_add_ on the CPU), so a
// launch equals the plain version run on CPU copies bit for bit.
//
// Design: an inverse index, then one ordered sum a row.
//   1. count: each slot adds 1 to its row (integer atomics, whose result
//      does not depend on their order), one atomic for the lanes of a warp
//      that share a row (__match_any_sync: an empty ball's K slots are one);
//   2. scan: the exclusive prefix of the B*N counts, in three launches (the
//      sums of tiles of kScanTile rows, their prefix in one block, each
//      tile's prefix), so ``start[r] .. start[r + 1]`` is row r's list;
//   3. fill: each slot writes its id at its row's cursor (warp-aggregated
//      like the count), which leaves each list in an order that changes
//      from run to run;
//   4. order each list: a thread sorts a list of at most kShortList ids in
//      place; a block sorts one of at most kSortCap in shared memory
//      (bitonic); a longer list (one row taking a large share of a batch
//      row's slots: a full voxel, an empty-ball row, a chamfer hot spot) is
//      rebuilt by one block walking its batch row's slots in order and
//      compacting the matches.  Ids are unique, so the sorted order is
//      fixed;
//   5. sum: a group of lanes a row (a power of two up to 32, lanes over
//      channels) for lists of at most kLongSum ids, reading the dg rows in
//      list order; a longer list by blocks of kSumChannels channels each
//      (so one long list's loads spread over SMs), each staging tiles of
//      its dg values in shared memory, double buffered, while one thread a
//      channel adds the previous tile in order.
// Steps 4 and 5 take their long lists from work lists that step 4 builds,
// through persistent blocks, so no launch size depends on the data and no
// host sync is needed: every buffer is sized from B*M*K and B*N, taken from
// PyTorch's allocator by the wrapper, and the launch replays inside a
// captured graph.
//
// What bounds it: bytes (dg read once, the inverse index written and read
// a few times), and for a long list its serial sum: one float32 add after
// another, as the contract orders.  A first design summed a long list in
// one block over all its channels: at the level-0 feature transfer of a
// B=32 DDPM step (61408 ids on the empty balls' row) that took 3.3 ms a
// launch, bound by the block's loads; blocks of eight channels each, one
// tile at a time, took 1.1 ms.
#include <climits>

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;
constexpr int kScanTile = kScanThreads * kScanItems;  // rows a scan block covers
constexpr int kShortList = 32;   // a thread sorts a list this long in place
constexpr int kSortThreads = 1024;
constexpr int kSortCap = 8192;   // a block sorts a list this long in shared memory
constexpr int kLongSum = 128;    // blocks, not a lane group, sum a longer list
constexpr int kSumThreads = 512;
constexpr int kSumChannels = 4;  // channels of a long list a block sums
constexpr int kSumSlots = 1024;  // slots of a long list a block stages at a time
constexpr int kSumLoaders = kSumThreads - 32;  // every warp but the adders'
constexpr int kSumPerLoader = (kSumSlots * kSumChannels + kSumLoaders - 1) / kSumLoaders;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// The row of slot s in the flat (B * N) row space, or -1 for a skipped ball
// or a lane past the end.
__device__ __forceinline__ int slot_row(const int* __restrict__ idx,
                                        const int* __restrict__ counts, int N, int M, int K,
                                        int S, int s) {
  if (s >= S) return -1;
  const int ball = s / K;
  if (counts != nullptr && counts[ball] == 0) return -1;
  return (ball / M) * N + __ldg(idx + s);
}

__global__ void __launch_bounds__(kThreads)
scatter_ordered_count(const int* __restrict__ idx, const int* __restrict__ counts, int N,
                      int M, int K, int S, int* __restrict__ cnt) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  const int row = slot_row(idx, counts, N, M, K, S, s);
  const unsigned peers = __match_any_sync(PDR_FULL_MASK, row);
  const int lane = threadIdx.x & 31;
  if (row >= 0 && lane == __ffs(peers) - 1) atomicAdd(cnt + row, __popc(peers));
}

__global__ void __launch_bounds__(kThreads)
scatter_ordered_fill(const int* __restrict__ idx, const int* __restrict__ counts, int N,
                     int M, int K, int S, const int* __restrict__ start,
                     int* __restrict__ cursor, int* __restrict__ list) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  const int row = slot_row(idx, counts, N, M, K, S, s);
  const unsigned peers = __match_any_sync(PDR_FULL_MASK, row);
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (row >= 0 && lane == leader) base = atomicAdd(cursor + row, __popc(peers));
  base = __shfl_sync(peers, base, leader);
  if (row >= 0) list[start[row] + base + __popc(peers & ((1u << lane) - 1u))] = s;
}

// Inclusive prefix sum over the block (kScanThreads threads); all threads
// call it.
__device__ int block_inclusive_scan(int v) {
  __shared__ int warp_total[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(PDR_FULL_MASK, v, d);
    if (lane >= d) v += y;
  }
  if (lane == 31) warp_total[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int t = warp_total[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(PDR_FULL_MASK, t, d);
      if (lane >= d) t += y;
    }
    warp_total[lane] = t;
  }
  __syncthreads();
  const int out = v + (warp > 0 ? warp_total[warp - 1] : 0);
  __syncthreads();  // warp_total is read before the next call writes it
  return out;
}

__global__ void __launch_bounds__(kScanThreads)
scatter_ordered_tile_sums(const int* __restrict__ cnt, int n, int* __restrict__ parts) {
  const int base = blockIdx.x * kScanTile + threadIdx.x * kScanItems;
  int sum = 0;
#pragma unroll
  for (int u = 0; u < kScanItems; ++u) {
    if (base + u < n) sum += cnt[base + u];
  }
  sum = block_inclusive_scan(sum);
  if (threadIdx.x == kScanThreads - 1) parts[blockIdx.x] = sum;
}

// The exclusive prefix of the tiles' sums, in place, in one block; also
// clears the two work-list counters.
__global__ void __launch_bounds__(kScanThreads)
scatter_ordered_scan_parts(int* __restrict__ parts, int tiles, int* __restrict__ counters) {
  __shared__ int carry;
  if (threadIdx.x == 0) {
    carry = 0;
    counters[0] = 0;
    counters[1] = 0;
  }
  __syncthreads();
  for (int base = 0; base < tiles; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < tiles ? parts[i] : 0;
    const int incl = block_inclusive_scan(v);
    const int c = carry;
    if (i < tiles) parts[i] = c + incl - v;
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry = c + incl;
    __syncthreads();
  }
}

// start[i] = the exclusive prefix of cnt at i (i < n = B*N + 1); cnt is
// cleared for its use as the fill's cursors.
__global__ void __launch_bounds__(kScanThreads)
scatter_ordered_tile_scan(int* __restrict__ cnt, int n, const int* __restrict__ parts,
                          int* __restrict__ start) {
  const int base = blockIdx.x * kScanTile + threadIdx.x * kScanItems;
  int v[kScanItems];
  int local = 0;
#pragma unroll
  for (int u = 0; u < kScanItems; ++u) {
    v[u] = base + u < n ? cnt[base + u] : 0;
    local += v[u];
  }
  int run = parts[blockIdx.x] + block_inclusive_scan(local) - local;
#pragma unroll
  for (int u = 0; u < kScanItems; ++u) {
    if (base + u < n) {
      start[base + u] = run;
      cnt[base + u] = 0;
    }
    run += v[u];
  }
}

// Sorts lists of at most kShortList ids in place, a thread a row, and puts
// the rows of longer lists on the work lists: to sort (counters[0]) and to
// sum by a block (counters[1]).
__global__ void __launch_bounds__(kThreads)
scatter_ordered_sort_short(const int* __restrict__ start, int R, int* __restrict__ list,
                           int* __restrict__ sort_rows, int* __restrict__ sum_rows,
                           int* __restrict__ counters) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const int a = start[r];
  const int L = start[r + 1] - a;
  if (L > kLongSum) sum_rows[atomicAdd(counters + 1, 1)] = r;
  if (L <= 1) return;
  if (L > kShortList) {
    sort_rows[atomicAdd(counters, 1)] = r;
    return;
  }
  int* l = list + a;
  for (int i = 1; i < L; ++i) {
    const int x = l[i];
    int j = i - 1;
    while (j >= 0 && l[j] > x) {
      l[j + 1] = l[j];
      --j;
    }
    l[j + 1] = x;
  }
}

// Bitonic sort of buf[0, n2) ascending, n2 a power of two; the whole block
// calls it.
__device__ void block_bitonic_sort(int* buf, int n2) {
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n2; i += blockDim.x) {
        const int p = i ^ j;
        if (p > i) {
          const int x = buf[i], y = buf[p];
          if ((x > y) == ((i & k) == 0)) {
            buf[i] = y;
            buf[p] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// A block a work-list row, persistent: a list of at most kSortCap ids is
// sorted in shared memory; a longer one is rebuilt in slot order by walking
// the slots of the row's batch row and compacting those that land on it.
__global__ void __launch_bounds__(kSortThreads)
scatter_ordered_sort_long(const int* __restrict__ idx, const int* __restrict__ counts, int N,
                          int M, int K, const int* __restrict__ start,
                          const int* __restrict__ sort_rows, const int* __restrict__ counters,
                          int* __restrict__ list) {
  __shared__ int buf[kSortCap];
  __shared__ int warp_hits[kSortThreads / 32];
  const int rows = counters[0];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int w = blockIdx.x; w < rows; w += gridDim.x) {
    const int r = sort_rows[w];
    const int a = start[r];
    const int L = start[r + 1] - a;
    if (L <= kSortCap) {
      int n2 = 1;
      while (n2 < L) n2 <<= 1;
      for (int i = threadIdx.x; i < n2; i += kSortThreads) buf[i] = i < L ? list[a + i] : INT_MAX;
      __syncthreads();
      block_bitonic_sort(buf, n2);
      for (int i = threadIdx.x; i < L; i += kSortThreads) list[a + i] = buf[i];
      __syncthreads();
      continue;
    }
    const int b = r / N, target = r - b * N;
    const int s0 = b * M * K, s1 = s0 + M * K;
    int found = 0;  // the same in every thread
    for (int base = s0; base < s1; base += kSortThreads) {
      const int s = base + threadIdx.x;
      bool hit = false;
      if (s < s1) {
        hit = __ldg(idx + s) == target && (counts == nullptr || counts[s / K] != 0);
      }
      const unsigned bal = __ballot_sync(PDR_FULL_MASK, hit);
      if (lane == 0) warp_hits[warp] = __popc(bal);
      __syncthreads();
      int before = 0, total = 0;
      for (int v = 0; v < kSortThreads / 32; ++v) {
        before += v < warp ? warp_hits[v] : 0;
        total += warp_hits[v];
      }
      if (hit) list[a + found + before + __popc(bal & ((1u << lane) - 1u))] = s;
      found += total;
      __syncthreads();
    }
  }
}

// Lane groups of ``group`` lanes, a row each: the rows of at most kLongSum
// ids (a block sums the others), lanes over channels, terms in list order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_ordered_sum_rows(const T* __restrict__ dg, int ld, const int* __restrict__ start,
                         const int* __restrict__ list, int R, int C, int group,
                         float* __restrict__ out) {
  constexpr int kUnroll = 8;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int r = static_cast<int>(t / group);
  const int lane = static_cast<int>(t - static_cast<long long>(r) * group);
  if (r >= R) return;
  const int a = start[r];
  const int L = start[r + 1] - a;
  if (L > kLongSum) return;
  for (int c = lane; c < C; c += group) {
    float acc = 0.0f;
    for (int p0 = 0; p0 < L; p0 += kUnroll) {
      int s[kUnroll];
      float x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (p0 + u < L) s[u] = list[a + p0 + u];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (p0 + u < L) x[u] = to_float(dg[static_cast<size_t>(s[u]) * ld + c]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (p0 + u < L) acc = __fadd_rn(acc, x[u]);
      }
    }
    out[static_cast<size_t>(r) * C + c] = acc;
  }
}

// Tile t of a long list (kSumSlots slots from slot t * kSumSlots of the
// list at ``a``, channels [0, cc) of ``g``) into ``tile``, by the loader
// threads: each issues its loads together, then stores them.
template <typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ g, int ld,
                                           const int* __restrict__ list, int a, int L, int cc,
                                           int t, float* __restrict__ tile) {
  const int q = t * kSumSlots;
  const int total = min(kSumSlots, L - q) * cc;
  const int me = threadIdx.x - 32;
  float v[kSumPerLoader];
#pragma unroll
  for (int u = 0; u < kSumPerLoader; ++u) {
    const int e = me + u * kSumLoaders;
    if (e < total) {
      const int j = e / cc;
      v[u] = to_float(g[static_cast<size_t>(list[a + q + j]) * ld + (e - j * cc)]);
    }
  }
#pragma unroll
  for (int u = 0; u < kSumPerLoader; ++u) {
    const int e = me + u * kSumLoaders;
    if (e < total) tile[e] = v[u];
  }
}

// A block a (row of more than kLongSum ids, kSumChannels channels) work
// item, persistent: a long list's channels are split over blocks, so its
// loads are spread over SMs.  Warp 0 adds, one thread a channel, in list
// order, from one of two shared-memory tiles while the other warps stage
// the next tile's dg values in the other (double buffered: the serial
// adds and the loads overlap).
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
scatter_ordered_sum_long(const T* __restrict__ dg, int ld, const int* __restrict__ start,
                         const int* __restrict__ list, const int* __restrict__ sum_rows,
                         const int* __restrict__ counters, int C, float* __restrict__ out) {
  __shared__ float tile[2][kSumSlots * kSumChannels];
  const int chunks = (C + kSumChannels - 1) / kSumChannels;
  const int items = counters[1] * chunks;
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const int r = sum_rows[w / chunks];
    const int c0 = (w % chunks) * kSumChannels;
    const int cc = min(kSumChannels, C - c0);
    const int a = start[r];
    const int L = start[r + 1] - a;
    const int tiles = (L + kSumSlots - 1) / kSumSlots;
    const T* g = dg + c0;
    if (threadIdx.x >= 32) stage_tile(g, ld, list, a, L, cc, 0, tile[0]);
    __syncthreads();
    float acc = 0.0f;
    for (int t = 0; t < tiles; ++t) {
      if (threadIdx.x >= 32) {
        if (t + 1 < tiles) stage_tile(g, ld, list, a, L, cc, t + 1, tile[(t + 1) & 1]);
      } else if (threadIdx.x < cc) {
        const float* b = tile[t & 1];
        const int n = min(kSumSlots, L - t * kSumSlots);
#pragma unroll 16
        for (int j = 0; j < n; ++j) acc = __fadd_rn(acc, b[j * cc + threadIdx.x]);
      }
      __syncthreads();
    }
    if (threadIdx.x < cc) out[static_cast<size_t>(r) * C + c0 + threadIdx.x] = acc;
  }
}

// The workspace's int32 layout, in order: cnt and start (R + 1 each), the
// two work lists (R each), their counters (2), the tiles' sums, the lists
// (S).
long long workspace_ints(long long R, long long S) {
  const long long tiles = (R + 1 + kScanTile - 1) / kScanTile;
  return 2 * (R + 1) + 2 * R + 2 + tiles + S;
}

// The SMs of the current device, times ``per_sm`` blocks (a persistent
// grid).
int resident_blocks(int per_sm) {
  static int sms = 0;  // read at the first (eager) launch, before any capture
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return per_sm * sms;
}

template <typename T>
void launch(const void* dg, int ld, const int* idx, const int* counts, int B, int N, int M,
            int K, int C, int* work, float* out, cudaStream_t st) {
  const int R = B * N, S = B * M * K;
  const int tiles = (R + 1 + kScanTile - 1) / kScanTile;
  int* cnt = work;
  int* start = cnt + (R + 1);
  int* sort_rows = start + (R + 1);
  int* sum_rows = sort_rows + R;
  int* counters = sum_rows + R;
  int* parts = counters + 2;
  int* list = parts + tiles;
  const T* g = static_cast<const T*>(dg);
  const int slot_blocks = (S + kThreads - 1) / kThreads;
  int group = 1;
  while (group < 32 && group < C) group <<= 1;

  cudaMemsetAsync(cnt, 0, sizeof(int) * (R + 1), st);
  if (S > 0) {
    scatter_ordered_count<<<slot_blocks, kThreads, 0, st>>>(idx, counts, N, M, K, S, cnt);
  }
  scatter_ordered_tile_sums<<<tiles, kScanThreads, 0, st>>>(cnt, R + 1, parts);
  scatter_ordered_scan_parts<<<1, kScanThreads, 0, st>>>(parts, tiles, counters);
  scatter_ordered_tile_scan<<<tiles, kScanThreads, 0, st>>>(cnt, R + 1, parts, start);
  if (S > 0) {
    scatter_ordered_fill<<<slot_blocks, kThreads, 0, st>>>(idx, counts, N, M, K, S, start,
                                                           cnt, list);
  }
  scatter_ordered_sort_short<<<(R + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      start, R, list, sort_rows, sum_rows, counters);
  scatter_ordered_sort_long<<<resident_blocks(2), kSortThreads, 0, st>>>(
      idx, counts, N, M, K, start, sort_rows, counters, list);
  const long long lanes = static_cast<long long>(R) * group;
  scatter_ordered_sum_rows<T><<<static_cast<unsigned>((lanes + kThreads - 1) / kThreads),
                                kThreads, 0, st>>>(g, ld, start, list, R, C, group, out);
  scatter_ordered_sum_long<T><<<resident_blocks(4), kSumThreads, 0, st>>>(
      g, ld, start, list, sum_rows, counters, C, out);
}

}  // namespace

// The int32 workspace a launch needs at (B, N, M, K), or -1 beyond int32.
extern "C" int pdr_group_scatter_ordered_workspace(int B, int N, int M, int K) {
  const long long R = static_cast<long long>(B) * N;
  const long long S = static_cast<long long>(B) * M * K;
  if (R >= INT_MAX || S >= INT_MAX) return -1;
  const long long w = workspace_ints(R, S);
  return w >= INT_MAX ? -1 : static_cast<int>(w);
}

// dg (B, M, K, C) f32 (dg_bf16 = 0) or bf16 (dg_bf16 = 1), ``ld`` elements
// between consecutive (m, k) rows; idx (B, M, K) i32 in [0, N); counts
// (B, M) i32 or null; work: pdr_group_scatter_ordered_workspace(B, N, M, K)
// int32s; out (B, N, C) f32, every element written.
extern "C" int pdr_group_scatter_ordered(const void* dg, int dg_bf16, int ld, const void* idx,
                                         const void* counts, int B, int N, int M, int K,
                                         int C, void* work, void* out, void* stream) {
  if (B < 1 || N < 1 || M < 0 || K < 1 || C < 1 || ld < C ||
      pdr_group_scatter_ordered_workspace(B, N, M, K) < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  (dg_bf16 ? &launch<__nv_bfloat16> : &launch<float>)(
      dg, ld, static_cast<const int*>(idx), static_cast<const int*>(counts), B, N, M, K, C,
      static_cast<int*>(work), static_cast<float*>(out), st);
  PDR_RETURN_LAUNCH_ERROR();
}
