// Scatter-add of grouped cotangents into table rows, in a fixed order:
//   out[b, n, c] = the sum of dg[b, m, k, c] over the slots (m, k) with
//   idx[b, m, k] = n, taken in this order.  A run is a maximal stretch of
//   consecutive slots (m, k), (m, k + 1), ... of one ball whose idx equals
//   the row; a ball that ``counts`` skips has no runs.  Each run's terms are
//   summed in slot order from 0.0f, then the runs' partials are summed into
//   the row in ascending order of their first slot, from 0.0f.
//
// The deterministic counterpart of csrc/group_scatter.cu (kernel B), with
// the same contract: float32 or bfloat16 dg read in place with ``ld``
// elements between consecutive slots, int32 idx, optional ``counts`` whose
// zero entries skip the ball, a float32 (B, N, C) result.  One launch may
// take a second table gathered with the same idx (the features and the
// positions of the fused ball group): both share the inverse index.  Every
// backward of a gather in the port's training step runs through it (the
// grouping kernels' backwards, gather_points / group_points, the class
// embedding, PVCNN's voxel transfers).  It replaces no TPU kernel: the JAX
// package's backwards are one-hot einsums (models/grouping.py::
// _fused_ball_gather_bwd), whose sums XLA takes in a fixed order, so its
// jitted step repeats run to run; kernel B's float32 atomics land in an
// order that changes from run to run.  The order here is the one of the
// plain version (ops/scatter.py, two serial index_add_ on the CPU: the
// slots into their runs, the runs into their rows), so a launch equals the
// plain version run on CPU copies bit for bit.  Where K = 1 every run is one
// slot and the order is plain slot order.
//
// Design: an inverse index over runs, not slots, in four kernels and a
// memset.
//   1. count: a warp reads 32 consecutive slots, marks where each run starts
//      by comparing a slot's idx with its neighbour's (__shfl_up_sync), and
//      adds 1 to the row of each run (integer atomics, one for the lanes of
//      a warp that share a row).  The ball query fills an empty ball's K
//      slots with row 0 and pads a ball of h < K hits with its first hit, so
//      those become one run each: the level-0 empty-ball row of a B = 32
//      DDPM step holds ~1.9k runs instead of ~61k slots;
//   2. scan: the exclusive prefix of the B*N counts in one pass (each block
//      takes a tile in order of arrival, publishes its sum and adds up the
//      sums of the tiles before it), so ``start[r] .. start[r + 1]`` is row
//      r's list; it sets each row's cursor to its start and puts rows of
//      more runs than a group of lanes sorts (16 a lane) on a work list;
//   3. fill: each run writes its first slot (and whether it is longer than
//      one slot) at its row's cursor, in an order that changes from run to
//      run; the warp then sums each run longer than one slot, a group of
//      lanes a run (lanes over channels), in slot order from 0.0f, into a
//      float32 partial at index first_slot / 2 (two such runs never share
//      it).  A one-slot run is read from dg in place later;
//   4. sum, in one launch with two kinds of block:
//      - short lists: groups of g lanes (a power of two from 2 to 32, over
//        consecutive channels), persistent, take work items in turn, a row
//        and 2 g P of its channels (P pairs a lane: more where the rows are
//        many); a group sorts the row's runs by first slot in shared memory
//        (bitonic, at most 16 g runs) and adds their values in that order;
//      - long lists: a block a work item (a row and kChain of its
//        channels), persistent.  It marks the row's runs in a bitmap over
//        its batch row's slots (in windows of kWinWords words), takes them
//        out in slot order through a prefix count of the bitmap, and adds
//        the partials in that order: warps of loaders stage tiles of
//        partials in shared memory, double buffered, while one thread a
//        channel adds the previous tile.
// No launch size depends on the data and no host sync is needed: every
// buffer is sized from B*M*K, B*N and the channels, taken from PyTorch's
// allocator by the wrapper, and the launch replays inside a captured graph.
//
// What bounds it: bytes (dg read once; the partials, a small share, written
// and read once), and the serial chain of a row: K adds for the longest run
// plus one add a run on the row, no longer one add a slot.  The design it
// replaced (lists of slots, nine launches and a memset) spent 0.3755 ms of
// 0.5295 on the 61k-slot chain of the B = 32 level-0 transfer, and its
// fixed cost set a K = 1 call's time.
#include <algorithm>
#include <climits>

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;       // count and fill: a thread a slot
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;
constexpr int kScanTile = kScanThreads * kScanItems;  // rows a scan block covers
constexpr int kShortWords = 512;    // a warp's short lists: 16 g runs a row of g lanes
constexpr long long kShortLanes = 1 << 22;  // lanes beyond which a lane takes more pairs
constexpr int kSumThreads = 512;
constexpr int kWinWords = 1024;     // a long list's bitmap window: 32768 slots
constexpr int kPerWord = kWinWords / kSumThreads;  // bitmap words a thread counts
constexpr int kOrdCap = 2048;       // runs of a long list a block orders at a time
constexpr int kChain = 32;          // channels of a long list a work item adds
constexpr int kTileFloats = 4608;   // a staged tile of partials
constexpr int kTileRuns = 256;      // runs a tile at most
constexpr int kLoaders = kSumThreads - kChain;
constexpr int kPerLoader = (kTileFloats + kLoaders - 1) / kLoaders;
// the sum kernel's dynamic shared memory: a long-list block's two bitmaps,
// its ordered runs and two tiles, small enough for four blocks an SM; a
// short-list block's sorted lists fit in it
constexpr int kSumSmemBytes = (2 * kWinWords + kOrdCap + 2 * kTileFloats) * 4;
static_assert(kSumThreads / 32 * kShortWords * 4 <= kSumSmemBytes, "short lists");

// A table: its cotangent (B, M, K, C) at ``ld``, its result (B, N, C), and
// where its channels start in a row of partials.
struct Table {
  const void* dg;
  int ld, C, bf16, coff;
  float* out;
};

__device__ __forceinline__ float load(const float* g, size_t i) { return __ldg(g + i); }
__device__ __forceinline__ float load(const __nv_bfloat16* g, size_t i) {
  return __bfloat162float(g[i]);
}

// Slot s's idx ``v``, whether it belongs to a kept ball, and whether it
// starts a run; every lane of the warp calls it (lanes past the end too).
__device__ __forceinline__ void read_slot(const int* __restrict__ idx,
                                          const int* __restrict__ counts, int K, int S,
                                          int s, int lane, int& v, bool& kept, bool& starts) {
  const int ball = s / K;
  const int k = s - ball * K;
  kept = s < S && (counts == nullptr || counts[ball] != 0);
  v = kept ? __ldg(idx + s) : -1;
  int up = __shfl_up_sync(PDR_FULL_MASK, v, 1);
  if (lane == 0 && kept && k != 0) up = __ldg(idx + s - 1);  // the same ball: kept too
  starts = kept && (k == 0 || up != v);
}

__global__ void __launch_bounds__(kThreads)
scatter_ordered_count(const int* __restrict__ idx, const int* __restrict__ counts, int N,
                      int M, int K, int S, int* __restrict__ cnt) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int v;
  bool kept, starts;
  read_slot(idx, counts, K, S, s, lane, v, kept, starts);
  const int row = starts ? (s / K / M) * N + v : -1;
  const unsigned peers = __match_any_sync(PDR_FULL_MASK, row);
  if (row >= 0 && lane == __ffs(peers) - 1) atomicAdd(cnt + row, __popc(peers));
}

// Inclusive prefix sum over the block (kBlock threads) and the block's
// total; all threads call it.
template <int kBlock>
__device__ int block_inclusive_scan(int v, int& total) {
  constexpr int kWarps = kBlock / 32;
  __shared__ int warp_total[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(PDR_FULL_MASK, v, d);
    if (lane >= d) v += y;
  }
  if (lane == 31) warp_total[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kWarps ? warp_total[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(PDR_FULL_MASK, t, d);
      if (lane >= d) t += y;
    }
    if (lane < kWarps) warp_total[lane] = t;
  }
  __syncthreads();
  const int out = v + (warp > 0 ? warp_total[warp - 1] : 0);
  total = warp_total[kWarps - 1];
  __syncthreads();  // warp_total is read before the next call writes it
  return out;
}

// start[i] = the exclusive prefix of cnt at i (i <= R), in one pass: a block
// takes the next tile by ``ticket``, publishes its tile's sum (plus one, so
// 0 means not yet) in agg and adds up the sums of the tiles before it, which
// blocks already running have published or are about to (none waits before
// publishing).  cnt becomes the fill's cursors, each at its row's start;
// rows of more than ``short_cap`` runs go on the work list.
__global__ void __launch_bounds__(kScanThreads)
scatter_ordered_scan(int* __restrict__ cnt, int R, int short_cap, int* __restrict__ start,
                     int* ticket, int* agg, int* __restrict__ long_rows,
                     int* __restrict__ n_long) {
  __shared__ int tile, prefix;
  if (threadIdx.x == 0) tile = atomicAdd(ticket, 1);
  __syncthreads();
  const int t = tile;
  const int base = t * kScanTile + threadIdx.x * kScanItems;
  int v[kScanItems];
  int local = 0;
#pragma unroll
  for (int u = 0; u < kScanItems; ++u) {
    v[u] = base + u <= R ? cnt[base + u] : 0;
    local += v[u];
  }
  int total;
  const int incl = block_inclusive_scan<kScanThreads>(local, total);
  if (threadIdx.x == 0) atomicExch(agg + t, total + 1);
  if (threadIdx.x < 32) {
    const volatile int* published = agg;
    int sum = 0;
    for (int p = threadIdx.x; p < t; p += 32) {
      int x = published[p];
      while (x == 0) x = published[p];
      sum += x - 1;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) sum += __shfl_xor_sync(PDR_FULL_MASK, sum, d);
    if (threadIdx.x == 0) prefix = sum;
  }
  __syncthreads();
  int run = prefix + incl - local;
#pragma unroll
  for (int u = 0; u < kScanItems; ++u) {
    const int i = base + u;
    if (i <= R) {
      start[i] = run;
      cnt[i] = run;
      if (v[u] > short_cap) long_rows[atomicAdd(n_long, 1)] = i;
    }
    run += v[u];
  }
}

// The sums of a run's len slots from s at channels c and c + dc (if
// ``two``), each in slot order from 0.0f: two channels' loads in flight.
template <typename T>
__device__ __forceinline__ void run_sum(const T* __restrict__ g, int ld, int s, int len, int c,
                                        int dc, bool two, float& acc0, float& acc1) {
  constexpr int kUnroll = 8;
  acc0 = 0.0f;
  acc1 = 0.0f;
  const int c1 = two ? c + dc : c;
  int j = 0;
  for (; j + kUnroll <= len; j += kUnroll) {
    float x[kUnroll], y[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t row = static_cast<size_t>(s + j + u) * ld;
      x[u] = load(g, row + c);
      y[u] = load(g, row + c1);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      acc0 = __fadd_rn(acc0, x[u]);
      acc1 = __fadd_rn(acc1, y[u]);
    }
  }
  for (; j < len; ++j) {
    const size_t row = static_cast<size_t>(s + j) * ld;
    acc0 = __fadd_rn(acc0, load(g, row + c));
    acc1 = __fadd_rn(acc1, load(g, row + c1));
  }
}

// The partials of the warp's runs longer than one slot (lanes ``runs``,
// first slot s, length len) of table t: a group of lanes a run, lanes over
// channels.
__device__ void run_partials(const Table& t, unsigned runs, int s, int len, int lane,
                             int Ctot, float* __restrict__ part) {
  int g = 1;
  while (g < 32 && g < t.C) g <<= 1;
  const int groups = 32 / g, gi = lane / g, sub = lane - gi * g;
  unsigned rest = runs;
  while (rest) {  // the same in every lane
    int mine = -1;
    for (int q = 0; q < groups && rest; ++q) {
      const int bit = __ffs(rest) - 1;
      rest &= rest - 1u;
      if (q == gi) mine = bit;
    }
    const int src = mine < 0 ? 0 : mine;
    const int rs = __shfl_sync(PDR_FULL_MASK, s, src);
    const int rl = __shfl_sync(PDR_FULL_MASK, len, src);
    if (mine < 0) continue;
    float* p = part + static_cast<size_t>(rs >> 1) * Ctot + t.coff;
    for (int c = sub; c < t.C; c += 2 * g) {
      const bool two = c + g < t.C;
      float a0, a1;
      if (t.bf16) {
        run_sum(static_cast<const __nv_bfloat16*>(t.dg), t.ld, rs, rl, c, g, two, a0, a1);
      } else {
        run_sum(static_cast<const float*>(t.dg), t.ld, rs, rl, c, g, two, a0, a1);
      }
      p[c] = a0;
      if (two) p[c + g] = a1;
    }
  }
}

// Each run writes (first slot << 1 | longer than one slot) at its row's
// cursor (which the scan set to the row's start), then the warp sums its
// runs longer than one slot.
__global__ void __launch_bounds__(kThreads)
scatter_ordered_fill(const int* __restrict__ idx, const int* __restrict__ counts, int N,
                     int M, int K, int S, int* __restrict__ cursor, unsigned* __restrict__ list,
                     Table t1, Table t2, float* __restrict__ part) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int v;
  bool kept, starts;
  read_slot(idx, counts, K, S, s, lane, v, kept, starts);
  // a run ends where the next run starts or the kept slots end; the warp's
  // last run may go on past the warp
  const unsigned ends = __ballot_sync(PDR_FULL_MASK, starts || !kept);
  const unsigned after = ends & ~((2u << lane) - 1u);
  int len = after ? __ffs(after) - 1 - lane : 32 - lane;
  const unsigned open = __ballot_sync(PDR_FULL_MASK, starts && after == 0u);
  if (open) {
    const int o = __ffs(open) - 1;
    const int ov = __shfl_sync(PDR_FULL_MASK, v, o);
    int more = 0;
    for (int t0 = s - lane + 32;; t0 += 32) {
      const int t = t0 + lane;
      const bool same = t < S && t % K != 0 && __ldg(idx + t) == ov;
      const unsigned stop = __ballot_sync(PDR_FULL_MASK, !same);
      if (stop) {
        more += __ffs(stop) - 1;
        break;
      }
      more += 32;
    }
    if (lane == o) len += more;
  }
  const bool multi = starts && len > 1;
  const int row = starts ? (s / K / M) * N + v : -1;
  const unsigned peers = __match_any_sync(PDR_FULL_MASK, row);
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (row >= 0 && lane == leader) base = atomicAdd(cursor + row, __popc(peers));
  base = __shfl_sync(peers, base, leader);
  if (row >= 0) {
    list[base + __popc(peers & ((1u << lane) - 1u))] =
        (static_cast<unsigned>(s) << 1) | (multi ? 1u : 0u);
  }
  const unsigned runs = __ballot_sync(PDR_FULL_MASK, multi);
  if (runs) {
    const int Ctot = t1.C + t2.C;
    run_partials(t1, runs, s, len, lane, Ctot, part);
    if (t2.C > 0) run_partials(t2, runs, s, len, lane, Ctot, part);
  }
}

// The value of run ``e`` at channel c of the partial row (c < t1.C: table
// 1's, else table 2's): its partial, or a one-slot run's dg value.
// Channel c of the partial rows as a channel of its table: the fields are
// selected by value (a reference to a kernel parameter would put the
// parameter in local memory).
struct Chan {
  const void* dg;
  int ld, bf16, c;
};

__device__ __forceinline__ Chan channel(const Table& t1, const Table& t2, int c) {
  const bool first = c < t1.C;
  return Chan{first ? t1.dg : t2.dg, first ? t1.ld : t2.ld, first ? t1.bf16 : t2.bf16,
              first ? c : c - t1.C};
}

__device__ __forceinline__ float run_value(const Chan& ch, int Ctot,
                                           const float* __restrict__ part, unsigned e, int c) {
  if (e & 1u) return part[static_cast<size_t>(e >> 2) * Ctot + c];
  const size_t i = static_cast<size_t>(e >> 1) * ch.ld + ch.c;
  return ch.bf16 ? load(static_cast<const __nv_bfloat16*>(ch.dg), i)
                 : load(static_cast<const float*>(ch.dg), i);
}

__device__ __forceinline__ void store_out(const Table& t1, const Table& t2, int r, int c,
                                          float v) {
  const bool first = c < t1.C;
  float* out = first ? t1.out : t2.out;
  const int C = first ? t1.C : t2.C;
  out[static_cast<size_t>(r) * C + (first ? c : c - t1.C)] = v;
}

// Short lists (at most 16 g runs): a group of g lanes (g >= 2) takes work
// items in turn, ``groups`` apart (a persistent grid: the voxel transfers'
// million rows would otherwise be as many short-lived warps); an item is a
// row and 2 g P of its channels, P pairs a lane.  The group sorts its row's
// runs by first slot in shared memory (bitonic, the list padded to a power
// of two), then adds the row's values in that order; a row of one run or
// none takes neither.
__device__ void sum_short(const Table& t1, const Table& t2, int Ctot,
                          const float* __restrict__ part, const int* __restrict__ start,
                          const unsigned* __restrict__ list, int R, int g, int P,
                          long long block, long long blocks, unsigned* buf) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = 32 / g, gi = lane / g, sub = lane - gi * g;
  const int cap = kShortWords / rows;
  const int chunk = 2 * g * P;
  const int chunks = (Ctot + chunk - 1) / chunk;
  const long long items = static_cast<long long>(R) * chunks;
  const long long groups = blocks * (kSumThreads / 32) * rows;
  const unsigned mask = g == 32 ? PDR_FULL_MASK : ((1u << g) - 1u) << (gi * g);
  unsigned* ents = buf + warp * kShortWords + gi * cap;
  for (long long item = (block * (kSumThreads / 32) + warp) * rows + gi; item < items;
       item += groups) {
    const long long r = item / chunks;
    const int a = start[r];
    const int L = start[r + 1] - a;
    if (L > cap) continue;  // a long list
    const int cbase = static_cast<int>(item - r * chunks) * chunk + sub;
    if (L <= 1) {
      const unsigned e = L == 1 ? list[a] : 0u;
      for (int c = cbase; c < cbase + chunk && c < Ctot; c += g) {
        store_out(t1, t2, static_cast<int>(r), c,
                  L == 1 ? __fadd_rn(0.0f, run_value(channel(t1, t2, c), Ctot, part, e, c))
                         : 0.0f);
      }
      continue;
    }
    int n2 = 2;
    while (n2 < L) n2 <<= 1;
    for (int i = sub; i < n2; i += g) ents[i] = i < L ? list[a + i] : UINT_MAX;
    __syncwarp(mask);
    for (int k = 2; k <= n2; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = sub; i < n2; i += g) {
          const int p = i ^ j;
          if (p > i) {
            const unsigned x = ents[i], y = ents[p];
            if ((x > y) == ((i & k) == 0)) {
              ents[i] = y;
              ents[p] = x;
            }
          }
        }
        __syncwarp(mask);
      }
    }
    for (int c0 = cbase; c0 < cbase + chunk && c0 < Ctot; c0 += 2 * g) {
      const int c1 = c0 + g;
      const bool has1 = c1 < Ctot;
      const Chan ch0 = channel(t1, t2, c0), ch1 = channel(t1, t2, has1 ? c1 : c0);
      constexpr int kUnroll = 4;  // 8 loads in flight a lane, at 32 registers
      float acc0 = 0.0f, acc1 = 0.0f;
      for (int p0 = 0; p0 < L; p0 += kUnroll) {
        float x[kUnroll], y[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (p0 + u < L) {
            const unsigned e = ents[p0 + u];
            x[u] = run_value(ch0, Ctot, part, e, c0);
            y[u] = has1 ? run_value(ch1, Ctot, part, e, c1) : 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (p0 + u < L) {
            acc0 = __fadd_rn(acc0, x[u]);
            acc1 = __fadd_rn(acc1, y[u]);
          }
        }
      }
      store_out(t1, t2, static_cast<int>(r), c0, acc0);
      if (has1) store_out(t1, t2, static_cast<int>(r), c1, acc1);
    }
    __syncwarp(mask);  // the list is read before the next item writes it
  }
}

// Tile ``tile`` of the n ordered runs (at most ``per_tile`` runs, channels
// [c0, c0 + cc)) into ``dst``, by the loader threads: each issues its loads
// together, then stores them.
__device__ __forceinline__ void stage_tile(const Table& t1, const Table& t2, int Ctot,
                                           const float* __restrict__ part,
                                           const unsigned* ord, int n, int per_tile, int c0,
                                           int cc, int tile, float* dst) {
  const int q = tile * per_tile;
  const int total = min(per_tile, n - q) * cc;
  const int me = threadIdx.x - kChain;
  constexpr int kHalf = (kPerLoader + 1) / 2;  // two rounds: no spill at 32 registers
#pragma unroll
  for (int u0 = 0; u0 < kPerLoader; u0 += kHalf) {
    float x[kHalf];
#pragma unroll
    for (int u = 0; u < kHalf; ++u) {
      const int e = me + (u0 + u) * kLoaders;
      if (u0 + u < kPerLoader && e < total) {
        const int j = e / cc;
        const int c = c0 + (e - j * cc);
        x[u] = run_value(channel(t1, t2, c), Ctot, part, ord[q + j], c);
      }
    }
#pragma unroll
    for (int u = 0; u < kHalf; ++u) {
      const int e = me + (u0 + u) * kLoaders;
      if (u0 + u < kPerLoader && e < total) dst[e] = x[u];
    }
  }
}

// Adds the n ordered runs at channels [c0, c0 + cc) to ``acc``: threads
// below kChain add, one a channel, from one tile while the others stage the
// next.
__device__ void chain_long(const Table& t1, const Table& t2, int Ctot,
                           const float* __restrict__ part, const unsigned* ord, int n, int c0,
                           int cc, float& acc, float* tiles) {
  const int per_tile = min(kTileRuns, kTileFloats / cc);
  const int count = (n + per_tile - 1) / per_tile;
  if (threadIdx.x >= kChain) stage_tile(t1, t2, Ctot, part, ord, n, per_tile, c0, cc, 0, tiles);
  __syncthreads();
  for (int t = 0; t < count; ++t) {
    if (threadIdx.x >= kChain) {
      if (t + 1 < count) {
        stage_tile(t1, t2, Ctot, part, ord, n, per_tile, c0, cc, t + 1,
                   tiles + ((t + 1) & 1) * kTileFloats);
      }
    } else if (static_cast<int>(threadIdx.x) < cc) {
      const float* b = tiles + (t & 1) * kTileFloats;
      const int m = min(per_tile, n - t * per_tile);
#pragma unroll 16
      for (int j = 0; j < m; ++j) acc = __fadd_rn(acc, b[j * cc + threadIdx.x]);
    }
    __syncthreads();
  }
}

// Long lists: a block a work item, persistent; an item is a work-list row
// and kChain of its channels.  The row's runs are marked in bitmaps over its
// batch row's slots, a window at a time, taken out in slot order by a
// prefix count of the marks, and added kOrdCap at a time, each channel's sum
// running on in its thread's register.
__device__ void sum_long(const Table& t1, const Table& t2, int Ctot,
                         const float* __restrict__ part, const int* __restrict__ start,
                         const unsigned* __restrict__ list, const int* __restrict__ long_rows,
                         const int* __restrict__ n_long, int N, int M, int K, int blocks,
                         unsigned* smem) {
  unsigned* present = smem;
  unsigned* longer = present + kWinWords;  // the run is longer than one slot
  unsigned* ord = longer + kWinWords;
  float* tiles = reinterpret_cast<float*>(ord + kOrdCap);
  const int chunks = (Ctot + kChain - 1) / kChain;
  const int items = *n_long * chunks;
  const int span = M * K;
  for (int w = blockIdx.x; w < items; w += blocks) {
    const int r = long_rows[w / chunks];
    const int c0 = (w % chunks) * kChain;
    const int cc = min(kChain, Ctot - c0);
    const int a = start[r];
    const int L = start[r + 1] - a;
    const int s0 = (r / N) * span;
    float acc = 0.0f;
    for (int w0 = 0; w0 < span; w0 += kWinWords * 32) {
      const int bits = min(kWinWords * 32, span - w0);
      const int words = (bits + 31) / 32;
      for (int i = threadIdx.x; i < words; i += kSumThreads) {
        present[i] = 0u;
        longer[i] = 0u;
      }
      __syncthreads();
      for (int p = threadIdx.x; p < L; p += kSumThreads) {
        const unsigned e = list[a + p];
        const int off = static_cast<int>(e >> 1) - s0 - w0;
        if (off >= 0 && off < bits) {
          atomicOr(present + (off >> 5), 1u << (off & 31));
          if (e & 1u) atomicOr(longer + (off >> 5), 1u << (off & 31));
        }
      }
      __syncthreads();
      const int w_lo = threadIdx.x * kPerWord;
      int have = 0;
#pragma unroll
      for (int u = 0; u < kPerWord; ++u) {
        if (w_lo + u < words) have += __popc(present[w_lo + u]);
      }
      int total;
      const int before = block_inclusive_scan<kSumThreads>(have, total) - have;
      for (int q0 = 0; q0 < total; q0 += kOrdCap) {
        const int n = min(kOrdCap, total - q0);
        if (have > 0 && before < q0 + n && before + have > q0) {
          int rank = before;
          for (int u = 0; u < kPerWord && w_lo + u < words; ++u) {
            unsigned m = present[w_lo + u];
            const unsigned lg = longer[w_lo + u];
            while (m) {
              const int bit = __ffs(m) - 1;
              m &= m - 1u;
              if (rank >= q0 && rank < q0 + n) {
                const unsigned s = static_cast<unsigned>(s0 + w0 + (w_lo + u) * 32 + bit);
                ord[rank - q0] = (s << 1) | ((lg >> bit) & 1u);
              }
              ++rank;
            }
          }
        }
        __syncthreads();
        chain_long(t1, t2, Ctot, part, ord, n, c0, cc, acc, tiles);
      }
    }
    if (static_cast<int>(threadIdx.x) < cc) store_out(t1, t2, r, c0 + threadIdx.x, acc);
  }
}

// The first ``long_blocks`` blocks take the long lists, the others the
// short ones, g lanes a row.
// Four blocks an SM (32 registers a thread): the value loads of the short
// lists are random reads of dg, and the more warps wait on them at once the
// faster they come; on an H100 the kNN gathers' backwards took 0.33-0.36 ms
// at four blocks, 0.77-0.92 at one.
__global__ void __launch_bounds__(kSumThreads, 4)
scatter_ordered_sum(Table t1, Table t2, const float* __restrict__ part,
                    const int* __restrict__ start, const unsigned* __restrict__ list,
                    const int* __restrict__ long_rows, const int* __restrict__ n_long, int R,
                    int N, int M, int K, int long_blocks, int g, int P) {
  const long long short_blocks = static_cast<long long>(gridDim.x) - long_blocks;
  extern __shared__ __align__(16) unsigned sum_smem[];
  const int Ctot = t1.C + t2.C;
  if (static_cast<int>(blockIdx.x) < long_blocks) {
    sum_long(t1, t2, Ctot, part, start, list, long_rows, n_long, N, M, K, long_blocks,
             sum_smem);
  } else {
    sum_short(t1, t2, Ctot, part, start, list, R, g, P,
              static_cast<long long>(blockIdx.x) - long_blocks, short_blocks, sum_smem);
  }
}

// The SMs of the current device, read once.
int multiprocessors() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

// The workspace's 4-byte words, in order: cnt (R + 1), the scan's ticket
// and the long-row count, the tiles' sums (the memset clears these), start
// (R + 1), the long rows (R), the lists (S), and the float32 partials of the
// runs longer than one slot (ceil(S / 2) rows of Ctot; none where K = 1).
long long workspace_words(long long R, long long S, int K, int Ctot) {
  const long long tiles = (R + 1 + kScanTile - 1) / kScanTile;
  return 2 * (R + 1) + 2 + tiles + R + S + (K > 1 ? (S + 1) / 2 * Ctot : 0);
}

void launch(Table t1, Table t2, const int* idx, const int* counts, int B, int N, int M, int K,
            int* work, cudaStream_t st) {
  const int R = B * N, S = B * M * K;
  const int tiles = (R + 1 + kScanTile - 1) / kScanTile;
  int* cnt = work;
  int* ticket = cnt + (R + 1);
  int* n_long = ticket + 1;
  int* agg = n_long + 1;
  int* start = agg + tiles;
  int* long_rows = start + (R + 1);
  unsigned* list = reinterpret_cast<unsigned*>(long_rows + R);
  float* part = reinterpret_cast<float*>(list + S);
  // the short lists' lanes: g lanes over consecutive channels (stores of
  // whole lines), two channels a lane, and P pairs a lane where the rows
  // are many, so that a row is one work item (the voxel transfers' rows,
  // mostly empty, would otherwise take one more item for a last channel)
  const int Ctot = t1.C + t2.C;
  int g = 2;
  while (g < 32 && 2 * g < Ctot) g <<= 1;
  int P = 1;
  while (2 * g * P < Ctot &&
         static_cast<long long>(R) * ((Ctot + 2 * g * P - 1) / (2 * g * P)) * g > kShortLanes) {
    P <<= 1;
  }

  cudaMemsetAsync(cnt, 0, sizeof(int) * (R + 3 + tiles), st);
  const int slot_blocks = (S + kThreads - 1) / kThreads;
  if (S > 0) {
    scatter_ordered_count<<<slot_blocks, kThreads, 0, st>>>(idx, counts, N, M, K, S, cnt);
  }
  // a row of g lanes sorts at most 16 g runs (a warp's kShortWords)
  const int short_cap = kShortWords / (32 / g);
  scatter_ordered_scan<<<tiles, kScanThreads, 0, st>>>(cnt, R, short_cap, start, ticket, agg,
                                                       long_rows, n_long);
  if (S > 0) {
    scatter_ordered_fill<<<slot_blocks, kThreads, 0, st>>>(idx, counts, N, M, K, S, cnt, list,
                                                           t1, t2, part);
  }
  // a long list holds more than short_cap of the S runs
  const int long_blocks = std::min(
      multiprocessors(), (S / (short_cap + 1) + 1) * ((Ctot + kChain - 1) / kChain));
  const long long short_items = static_cast<long long>(R) * ((Ctot + 2 * g * P - 1) / (2 * g * P));
  // at most four waves of four blocks an SM; the groups then take items in turn
  const long long short_blocks = std::min<long long>(
      (short_items * g + kSumThreads - 1) / kSumThreads, 16LL * multiprocessors());
  cudaFuncSetAttribute(scatter_ordered_sum, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSumSmemBytes);
  scatter_ordered_sum<<<static_cast<unsigned>(long_blocks + short_blocks), kSumThreads,
                        kSumSmemBytes, st>>>(t1, t2, part, start, list, long_rows, n_long, R,
                                             N, M, K, long_blocks, g, P);
}

}  // namespace

// The 4-byte workspace words a launch needs at (B, N, M, K) with C
// channels in all (both tables), or -1 beyond int32 indexing.
extern "C" int pdr_group_scatter_ordered_workspace(int B, int N, int M, int K, int C) {
  const long long R = static_cast<long long>(B) * N;
  const long long S = static_cast<long long>(B) * M * K;
  // a slot's index plus a warp, and a row's plus a scan tile, stay in int32
  if (R >= INT_MAX - kScanTile || S >= INT_MAX - kScanTile) return -1;
  const long long w = workspace_words(R, S, K, C);
  return w >= INT_MAX ? -1 : static_cast<int>(w);
}

// dg (B, M, K, C) f32 (dg_bf16 = 0) or bf16 (dg_bf16 = 1), ``ld`` elements
// between consecutive (m, k) rows; optionally a second table dg2 (B, M, K,
// C2) gathered with the same idx (C2 = 0: none); idx (B, M, K) i32 in
// [0, N); counts (B, M) i32 or null; work:
// pdr_group_scatter_ordered_workspace(B, N, M, K, C + C2) words; out
// (B, N, C) and out2 (B, N, C2) f32, every element written.
extern "C" int pdr_group_scatter_ordered(const void* dg, int dg_bf16, int ld, int C,
                                         const void* dg2, int dg2_bf16, int ld2, int C2,
                                         const void* idx, const void* counts, int B, int N,
                                         int M, int K, void* work, void* out, void* out2,
                                         void* stream) {
  if (B < 1 || N < 1 || M < 0 || K < 1 || C < 1 || ld < C || C2 < 0 ||
      (C2 > 0 && (dg2 == nullptr || out2 == nullptr || ld2 < C2)) ||
      pdr_group_scatter_ordered_workspace(B, N, M, K, C + C2) < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Table t1{dg, ld, C, dg_bf16, 0, static_cast<float*>(out)};
  const Table t2{dg2, ld2, C2, dg2_bf16, C, static_cast<float*>(out2)};
  launch(t1, t2, static_cast<const int*>(idx), static_cast<const int*>(counts), B, N, M, K,
         static_cast<int*>(work), static_cast<cudaStream_t>(stream));
  PDR_RETURN_LAUNCH_ERROR();
}
