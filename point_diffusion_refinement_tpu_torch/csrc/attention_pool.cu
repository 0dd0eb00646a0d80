// The AttentionPool forward in three sweeps over the grouped tensors
// (statistics of k, v and q, statistics of h, and scores + masked softmax +
// weighted value sum), the first two in thread-block clusters that finish
// their GroupNorm vectors in the last cluster of each batch row, and one
// elementwise pass that writes the normalised query rows between them.
//
// Replaces the TPU kernels ops/pallas_attention.py::_stats_kernel,
// _h_stats_kernel and _out_kernel (called by fused_attention_pool,
// pallas_attention.py:294, :348, :379), and the XLA glue between them
// (_group_mul_add, :187, and _pgn_mu_s_b, :204).
//
// What bounds it on this card: bytes at the wide shallow levels (one read of
// the two (B, M, K, C) bf16 tensors per sweep, a few dozen operations per
// byte), operations at the deep levels (contractions of 330-650 channels
// over few rows).  The first port gave each block one tile of 64 rows and
// every output column: the deepest sites ran 32 blocks on 132 SMs, each
// walking every weight in 64 x 64 tiles staged with two barriers and no
// overlap, and the shallow sites loaded their tiles element by element.
//
// Design:
// - One block of four warps a row tile (sweeps 1 and 2) or a unit of whole
//   centres (sweep 3) and a group of 64-column chunks of the sweep's output:
//   sweep 1's chunks are those of k (over g) and of v (over gfo), sweep 2's
//   those of h, sweep 3's those of the output.  Where the row tiles alone
//   give two blocks an SM at B=4, a block takes every chunk; at the deep
//   sites, which have few rows, the chunks split over more blocks.  A group
//   that needs a whole intermediate row (kn for h, hn for the scores)
//   recomputes it in its block, so the split is as coarse as filling the
//   card allows.  Writing kn / hn once in bf16 at the deep sites is
//   untried; blocks that walked several row tiles each (persistent, the
//   next tile's copy in flight) ran slower than one tile a block with many
//   blocks resident (PERF.md), and went.
// - A tile's rows are one contiguous run of the (rows, C) input: copied
//   with 16-byte cp.async into a raw buffer, then laid out once in shared
//   memory at a padded stride (no per-element global access).  The block's
//   weights are copied alongside, and kept resident where they fit in no
//   more shared memory than the ring; otherwise they stream through a
//   two-stage cp.async ring of 64 x 64 tiles with one barrier a stage.
//   Copies are tracked by mbarriers, so the activation copy never waits on
//   the ring.
// - Products: bf16 mma.sync.m16n8k16 with float32 accumulation, fragments
//   loaded with ldmatrix.  (wgmma would need a warpgroup per 64 rows and the
//   weight tile in its swizzled layout; at depths of 13-651 the staging, not
//   the product, sets the pace: untried.)
// - Row tiles hold R = 64, 32 or 16 rows, chosen by the rows in flight on
//   an SM, so any width up to a few thousand channels runs; a unit
//   of the out sweep holds R / K whole centres when K <= R, and a centre
//   with K > R slots spans ceil(K / R) tiles, the softmax carried across
//   them.
// - Softmax in one pass: a running maximum, sum and weighted sum per
//   (centre, column), one exp per slot.
// - Sweeps 1 and 2 run in thread-block clusters of cs consecutive row tiles
//   (cudaLaunchKernelEx; cs from the occupancy rule at cluster_size).  Each
//   block keeps its per-column sums and sums of squares in shared memory;
//   the cluster's blocks add them through distributed shared memory in rank
//   order, so a batch row has P / cs rows of partial sums in a (B, P / cs +
//   1, ld) scratch.  Rank 0 takes the batch row's ticket (an int32
//   atomicAdd) as it starts, its latency under the tile's copy; the cluster
//   that takes the last one adds the rows up in float64 in ascending order
//   (each block a share of the 16-byte columns, in row runs fixed by the
//   shapes) into the last row, once every cluster has counted its row
//   written (a release reduction after the cluster barrier; every other
//   cluster started before it, so it waits only on clusters that are
//   running or done).  Its rank 0 writes the GroupNorm vectors in the
//   types the next kernel reads and sets the tickets back to 0, so a
//   captured graph replays with no memset.  The statistics are the same
//   whichever cluster finishes.  Sweep 1 also sums
//   qd = relu(mm + b0) over each cluster's slice of the centres (16-byte
//   loads, while the tile's copy is in flight), so its finish writes the
//   first GroupNorm over [q, k] (q's and k's per-channel float32 (mul, add))
//   and the values' GroupNorm.  The query rows qn = bf16(bf16(qd) * mul +
//   add) need those vectors, so they are one coalesced elementwise pass
//   between sweeps 1 and 2 (attn_qn_kernel).
//
// Rounding points (the function's, repeated by the plain version): bf16
// operands, float32 accumulation rounded to bf16, bf16 bias add; the first
// GroupNorm on the k half as a float32 multiply-add rounded to bf16; the
// second and third in bf16 as (x - mu) * s + b with mu, s, b rounded to bf16;
// scores masked with bf16(-1e9); softmax and the weighted sum in float32.
#include "common.cuh"

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <algorithm>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

namespace {

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;  // four warps
constexpr int kNC = 64;        // output columns of a block's chunk
constexpr int kKC = 64;        // depth of a staged weight tile
constexpr int kWLd = kKC + 8;  // row stride of a staged weight tile
constexpr int kStages = 2;     // weight tiles in the ring
constexpr int kResidentElems = 16384;  // weights a block keeps resident, at most
constexpr int kSLd = kNC + 2;  // row stride of the score / value chunks
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ bf16 rb(float x) { return __float2bfloat16_rn(x); }
// bf16 arithmetic: the float32 result of two bf16 operands, rounded once
__device__ __forceinline__ bf16 badd(bf16 a, bf16 b) { return rb(bf(a) + bf(b)); }
__device__ __forceinline__ bf16 bsub(bf16 a, bf16 b) { return rb(bf(a) - bf(b)); }
__device__ __forceinline__ bf16 bmul(bf16 a, bf16 b) { return rb(bf(a) * bf(b)); }
__device__ __forceinline__ bf16 brelu(bf16 a) { return bf(a) > 0.f ? a : rb(0.f); }

__host__ __device__ constexpr int up16(int x) { return (x + 15) / 16 * 16; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// Copies are tracked by mbarriers, not commit groups, so a tile of
// activations in flight never holds up the weight ring: each thread issues
// its copies and then arrives (without raising the expected count) once they
// land; a waiter spins on the phase's parity.
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void bar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(smem_addr(bar)));
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A tile of R rows: four warps as WR row groups of 16 by WC column groups;
// each warp holds NT n-tiles of 8 columns of the block's 64.
template <int R>
struct Shape {
  static constexpr int WR = R / 16;
  static constexpr int WC = 4 / WR;
  static constexpr int NT = kNC / WC / 8;
};

// The weight ring: kStages tiles of kNC x kWLd bf16 and a barrier each (the
// next tile's copy in flight while this one multiplies);
// `pos` counts the tiles the block has issued, so tile u lives in stage
// u % kStages and completes phase (u / kStages) of its barrier.
struct Ring {
  bf16* tiles;
  uint64_t* bars;
  int pos;
};

// A weight given transposed (rows of Kp, k contiguous) in global memory,
// and, where the block keeps it resident, its rows [base, ...) in shared
// memory at stride lds (s is null when the weight streams through the ring).
struct Weight {
  const bf16* g;
  const bf16* s;
  int lds, base;
};

// Copy rows [row0, row0 + nrows) of a weight (rows of Kp) to dst at stride
// Kp + 8; the caller arrives on a barrier after its copies.
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src, int Kp,
                                           int row0, int nrows) {
  const int vec = Kp >> 3;
  for (int i = threadIdx.x; i < nrows * vec; i += kThreads) {
    const int r = i / vec;
    const int v = i - r * vec;
    cp_async16(dst + r * (Kp + 8) + 8 * v, src + static_cast<size_t>(row0 + r) * Kp + 8 * v);
  }
}

// The block's product acc = A (R x Kp, shared memory, stride lda) times
// columns [n0, n0 + ncols) of the weight: read in place where the block
// keeps it resident, else streamed through the ring.  Kp and ncols are
// multiples of 16.  acc[j][e] is row (warp % WR) * 16 + g +
// 8 * (e / 2), chunk column (warp / WR) * (kNC / WC) + 8 * j + 2 * t + e % 2
// with g = lane / 4, t = lane % 4.  Starts and ends with a block barrier, so
// what the caller wrote to A before is visible and the ring is free after.
template <int R>
__device__ void gemm(float (&acc)[Shape<R>::NT][4], const bf16* A, int lda, int Kp,
                     const Weight& w, int n0, int ncols, Ring& ring) {
  using S = Shape<R>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp % S::WR, wc = warp / S::WR;
#pragma unroll
  for (int j = 0; j < S::NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  if (w.s != nullptr) {  // resident: no staging, no barrier but the first
    const bf16* a_row = A + (wr * 16 + (lane & 15)) * lda + 8 * (lane >> 4);
    const int col0 = wc * (kNC / S::WC);
    const int ntiles = min(S::NT, max(0, (ncols - col0) >> 3));
    const bf16* b_row = w.s + (n0 - w.base + col0 + (lane & 7) + 8 * (lane >> 4)) * w.lds +
                        8 * ((lane >> 3) & 1);
    __syncthreads();
    for (int ks = 0; ks < Kp; ks += 16) {
      uint32_t a[4];
      ldsm_x4(a, a_row + ks);
#pragma unroll
      for (int j = 0; j < S::NT; j += 2) {
        if (j < ntiles) {
          uint32_t b[4];
          ldsm_x4(b, b_row + 8 * j * w.lds + ks);
          mma16816(acc[j], a, b[0], b[1]);
          mma16816(acc[j + 1], a, b[2], b[3]);
        }
      }
    }
    return;
  }
  const bf16* __restrict__ Wt = w.g;
  const int nk = (Kp + kKC - 1) / kKC;
  auto issue = [&](int kt) {
    if (kt >= nk) return;
    const int k0 = kt * kKC;
    const int vec = min(kKC, Kp - k0) >> 3;
    const int stage = (ring.pos + kt) % kStages;
    bf16* st = ring.tiles + stage * kNC * kWLd;
    for (int i = threadIdx.x; i < ncols * vec; i += kThreads) {
      const int n = i / vec;
      const int kk = (i - n * vec) << 3;
      cp_async16(st + n * kWLd + kk, Wt + static_cast<size_t>(n0 + n) * Kp + k0 + kk);
    }
    bar_arrive_copies(ring.bars + stage);
  };
  __syncthreads();
  issue(0);
  // this lane's ldmatrix rows: A rows wr*16 + lane % 16 at depth 8 * (lane / 16);
  // B rows (output columns) of n-tile pairs, depth 8 * ((lane / 8) % 2)
  const bf16* a_row = A + (wr * 16 + (lane & 15)) * lda + 8 * (lane >> 4);
  const int col0 = wc * (kNC / S::WC);
  const int b_row = col0 + (lane & 7) + 8 * (lane >> 4);
  const int b_k = 8 * ((lane >> 3) & 1);
  const int ntiles = min(S::NT, max(0, (ncols - col0) >> 3));  // even
  for (int kt = 0; kt < nk; ++kt) {
    const int u = ring.pos + kt;
    bar_wait(ring.bars + u % kStages, (u / kStages) & 1);
    __syncthreads();  // every warp is done with tile kt - 1, whose stage refills
    issue(kt + 1);
    const bf16* st = ring.tiles + (u % kStages) * kNC * kWLd;
    const int kc = min(kKC, Kp - kt * kKC);
    for (int ks = 0; ks < kc; ks += 16) {
      uint32_t a[4];
      ldsm_x4(a, a_row + kt * kKC + ks);
#pragma unroll
      for (int j = 0; j < S::NT; j += 2) {
        if (j < ntiles) {
          uint32_t b[4];
          ldsm_x4(b, st + (b_row + 8 * j) * kWLd + ks + b_k);
          mma16816(acc[j], a, b[0], b[1]);
          mma16816(acc[j + 1], a, b[2], b[3]);
        }
      }
    }
  }
  ring.pos += nk;
  __syncthreads();
}

// ---- activation tiles ------------------------------------------------------
// Issue the 16-byte copies of rows [r0, r0 + nrows) of a contiguous
// (rows, C) bf16 matrix (one run of nrows * C values) into raw, then arrive
// on bar once they land; returns where the run starts in raw.  The copies
// cover the 16-byte words that hold the run, which lie inside the
// allocation (PyTorch rounds allocations to 512 bytes).
__device__ __forceinline__ int issue_rows(bf16* raw, const bf16* src, int C, size_t r0,
                                          int nrows, uint64_t* bar) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src + r0 * C);
  const bf16* base = reinterpret_cast<const bf16*>(a & ~static_cast<uintptr_t>(15));
  const int head = static_cast<int>((a & 15) >> 1);
  const int nvec = (head + nrows * C + 7) >> 3;
  for (int i = threadIdx.x; i < nvec; i += kThreads) cp_async16(raw + 8 * i, base + 8 * i);
  bar_arrive_copies(bar);
  return head;
}

// raw[head + r * C + c] -> dst[r * ld + c] for the tile's nrows rows, the
// (row, column) position stepped, not divided, per value
__device__ __forceinline__ void lay_out(bf16* dst, int ld, const bf16* raw, int head, int C,
                                        int nrows) {
  const int n = nrows * C;
  int r = threadIdx.x / C, c = threadIdx.x - (threadIdx.x / C) * C;
  const int dq = kThreads / C, dr = kThreads % C;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    dst[r * ld + c] = raw[head + i];
    r += dq;
    c += dr;
    if (c >= C) {
      c -= C;
      ++r;
    }
  }
}

// zero columns [C, Cp) of an R-row buffer: the products read them
__device__ __forceinline__ void zero_pad(bf16* dst, int ld, int C, int Cp, int R) {
  const int pad = Cp - C;
  for (int i = threadIdx.x; i < R * pad; i += kThreads) {
    const int r = i / pad;
    dst[r * ld + C + (i - r * pad)] = rb(0.f);
  }
}

// raw buffer of a tile: R * C values and the run's misaligned head, in
// 16-byte words
__host__ __device__ constexpr int raw_elems(int R, int C) { return (R * C + 15 + 7) / 8 * 8; }

// ---- per-column statistics --------------------------------------------------
// This thread's running sums of its accumulator columns over the rows it
// saw; added row by row in tile order.
template <int R>
struct ColSums {
  float s[Shape<R>::NT][2], q[Shape<R>::NT][2];
  __device__ void clear() {
#pragma unroll
    for (int j = 0; j < Shape<R>::NT; ++j) s[j][0] = s[j][1] = q[j][0] = q[j][1] = 0.f;
  }
  __device__ __forceinline__ void add(int j, int e, float v) {
    s[j][e & 1] += v;
    q[j][e & 1] += v * v;
  }
  // the block's sums of chunk columns [0, ncols) -> row[n0 + c] (sums) and
  // row[C + n0 + c] (squares) for n0 + c < limit; fixed order: the 8 row
  // groups of a warp by shuffles, then the warps' row groups in order
  __device__ void write(float* red, int n0, int ncols, int limit, int C, float* row) {
    using S = Shape<R>;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wr = warp % S::WR, wc = warp / S::WR;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < S::NT; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float a = s[j][h], b = q[j][h];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          a += __shfl_xor_sync(PDR_FULL_MASK, a, off);
          b += __shfl_xor_sync(PDR_FULL_MASK, b, off);
        }
        if (g == 0) {
          const int c = wc * (kNC / S::WC) + 8 * j + 2 * t + h;
          red[(wr * 2 + 0) * kNC + c] = a;
          red[(wr * 2 + 1) * kNC + c] = b;
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * ncols; i += kThreads) {
      const int which = i / ncols;
      const int c = i - which * ncols;
      if (n0 + c < limit) {
        float v = red[which * kNC + c];
        for (int w = 1; w < S::WR; ++w) v += red[(w * 2 + which) * kNC + c];
        row[which * C + n0 + c] = v;
      }
    }
  }
};

struct Args {
  const bf16 *g, *gfo;          // (B, M*K, Ck), (B, M*K, Cv)
  const bf16 *w1t, *b1;         // (c2p, Ckp), (c2p)
  const bf16 *w4t, *b4;         // (Cop, Cvp), (Cop)
  const bf16 *w2kt, *b2;        // (Ip, c2p), (Ip)
  const bf16 *w3t, *b3;         // (Cop, Ip), (Cop)
  const bf16* qp;               // (B, M, I)
  const float *mulk, *addk;     // (B, c2)
  const bf16 *mu1, *s1, *bb1;   // (B, I)
  const bf16 *mu2, *s2, *bb2;   // (B, Co)
  const int* counts;            // (B, M) or null
  float* part;                  // (B, Pr + 1, row_floats(C)): C = c2 + Co + c1 or I
  float* out;                   // (B, M, Co)
  // the finishing work of sweeps 1 and 2
  const bf16 *mm, *b0;          // (B, M, c1) = feat W0 rounded to bf16, (c1)
  const float *sc0, *bi0;       // first GroupNorm (normed0), or h's (normed1)
  const float *sc2, *bi2;       // the values' GroupNorm (normed2)
  float *mulq, *addq;           // (B, c1)
  float *omulk, *oaddk;         // (B, c2)
  bf16 *fmu, *fs, *fbb;         // (B, Co) of the values, or (B, I) of h
  int* tickets;                 // (B, kTicketInts), 0 between launches
};

struct Dims {
  int M, K, P;                  // centres, slots, row blocks (tiles or units) a batch row
  int Pr;                       // rows of partial sums a batch row: P / the cluster size
  int cpb, resident;            // column chunks a block; weights kept in shared memory
  int Ck, Cv, c2, I, Co, c1;    // channel counts
  int Ckp, Cvp, c2p, Ip, Cop;   // rounded up to 16
};

// chunk column cc of accumulator (j, e) and its tile row
template <int R>
__device__ __forceinline__ int acc_col(int j, int e) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return (warp / Shape<R>::WR) * (kNC / Shape<R>::WC) + 8 * j + 2 * (lane & 3) + (e & 1);
}
template <int R>
__device__ __forceinline__ int acc_row(int e) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return (warp % Shape<R>::WR) * 16 + (lane >> 2) + 8 * (e >> 1);
}

// k = relu(g W1 + b1) of a tile, GroupNorm'd: kn = bf16(k * mulk + addk)
// (zero past c2) -> kn[row * ldk + col] for all c2p columns
template <int R>
__device__ void key_norm(const bf16* A, int lda, const Args& a, const Dims& d, const float* mulk,
                         const float* addk, bf16* kn, int ldk, const Weight& w1, Ring& ring) {
  float acc[Shape<R>::NT][4];
  for (int n0 = 0; n0 < d.c2p; n0 += kNC) {
    const int ncols = min(kNC, d.c2p - n0);
    gemm<R>(acc, A, lda, d.Ckp, w1, n0, ncols, ring);
#pragma unroll
    for (int j = 0; j < Shape<R>::NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cc = acc_col<R>(j, e);
        if (cc < ncols) {
          const int col = n0 + cc;
          bf16 v = rb(0.f);
          if (col < d.c2) {
            const bf16 kd = brelu(badd(rb(acc[j][e]), a.b1[col]));
            v = rb(bf(kd) * mulk[col] + addk[col]);
          }
          kn[acc_row<R>(e) * ldk + col] = v;
        }
      }
    }
  }
}

// Shared memory of a sweep, from the front: the ring's barriers and the
// activation barrier (64 bytes), the ring, then the sweep's buffers in bf16
// and its float scratch.  Every region is a multiple of 16 bytes.
constexpr int kBarBytes = 64;
constexpr int kRingElems = kStages * kNC * kWLd;
constexpr int kRedBytes = 2 * 4 * kNC * 4;  // a chunk's sums of each row group of a tile
constexpr int kRedFloats = kRedBytes / 4;

struct Smem {
  uint64_t* bars;  // kStages ring barriers, then the activation barrier
  bf16* next;
  __device__ explicit Smem(unsigned char* raw)
      : bars(reinterpret_cast<uint64_t*>(raw)),
        next(reinterpret_cast<bf16*>(raw + kBarBytes)) {}
  __device__ bf16* take(int elems) {
    bf16* p = next;
    next += elems;
    return p;
  }
};

// the ring's barriers expect one arrival a thread, the activation barrier
// `act` (one a thread for each matrix a tile copies)
__device__ __forceinline__ void init_bars(uint64_t* bars, int act = kThreads) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) bar_init(bars + i, kThreads);
    bar_init(bars + kStages, act);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::);
  }
  __syncthreads();
}

// ---- the column sums of sweeps 1 and 2: clusters, tickets, the finish --------
constexpr int kFlagOffset = 32;  // the cluster's "last" flag, in the barrier bytes
// a batch row's tickets: clusters that took one, clusters whose row is written
constexpr int kTicketInts = 2;

// floats a row of partial sums of C columns takes: C sums, C squares, padded
// to whole 16-byte vectors
__host__ __device__ constexpr int row_floats(int C) { return (2 * C + 3) / 4 * 4; }

// Per-channel sums and sums of squares of qd = relu(bf16(mm + b0)) over
// rows [m0, m1) of one batch row's mm (rows of c1) -> s[c], q[c]; thread
// `first` of `threads` owns its channels and adds the rows in order, 16-byte
// loads where the rows are whole vectors, eight rows' loads in flight.
__device__ void q_sums(const bf16* mm, const bf16* b0, int c1, int m0, int m1, float* s,
                       float* q, int first, int threads) {
  if ((c1 & 7) == 0 && (reinterpret_cast<uintptr_t>(mm) & 15) == 0) {
    for (int v = first; v < (c1 >> 3); v += threads) {
      bf16 bias[8];
      float as[8], aq[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        bias[e] = b0[8 * v + e];
        as[e] = aq[e] = 0.f;
      }
#pragma unroll 8
      for (int m = m0; m < m1; ++m) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(mm + static_cast<size_t>(m) * c1) + v);
        const bf16* xv = reinterpret_cast<const bf16*>(&x);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float f = bf(brelu(badd(xv[e], bias[e])));
          as[e] += f;
          aq[e] += f * f;
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s[8 * v + e] = as[e];
        q[8 * v + e] = aq[e];
      }
    }
  } else {
    for (int c = first; c < c1; c += threads) {
      float as = 0.f, aq = 0.f;
#pragma unroll 8
      for (int m = m0; m < m1; ++m) {
        const float f = bf(brelu(badd(mm[static_cast<size_t>(m) * c1 + c], b0[c])));
        as += f;
        aq += f * f;
      }
      s[c] = as;
      q[c] = aq;
    }
  }
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// A barrier over the cluster (a block barrier where the cluster is one block)
__device__ __forceinline__ void cluster_barrier(cg::cluster_group& cl, int cs) {
  if (cs > 1) {
    cl.sync();
  } else {
    __syncthreads();
  }
}

// The batch row's ticket of clusters started (tk[0]), taken by rank 0's
// thread 0 as the block starts, its latency hidden behind the tile's copy
// (other threads get 0).  The cluster that takes the last one finishes the
// batch row: every other cluster of the row took a lower ticket, so it has
// started by then and the finishing cluster waits only on clusters that
// are running or done.
__device__ __forceinline__ int start_ticket(int* tk, int rank) {
  return rank == 0 && threadIdx.x == 0 ? atomicAdd(tk, 1) : 0;
}

// The cluster's column sums -> its row of the partial sums.  Each block
// left its sums of its ncols columns in sums (the sums, then the squares,
// ld_s apart); the cluster's block r adds every block's value in rank order
// (distributed shared memory) for its share of the columns and writes it
// to row[c] and row[C + c].  Rank 0's thread 0 tells every block whether
// the cluster finishes the batch row (its start ticket is the last of
// nclusters) through the block's flag before the second cluster barrier,
// after which no block reads another's shared memory, then counts the row
// written (tk[1]) by a release reduction, which the barrier orders after
// every thread's writes.  Returns true in the finishing cluster's blocks.
__device__ bool cluster_row(const float* sums, int ld_s, int ncols, float* row, int C, int* tk,
                            int ticket, int nclusters, int* flag) {
  cg::cluster_group cl = cg::this_cluster();
  const int cs = static_cast<int>(cl.num_blocks()), rank = static_cast<int>(cl.block_rank());
  cluster_barrier(cl, cs);  // every block's sums are in its shared memory
  if (rank == 0 && threadIdx.x == 0) {
    for (int r = 0; r < cs; ++r) *cl.map_shared_rank(flag, r) = ticket == nclusters - 1;
  }
  for (int i = rank * kThreads + threadIdx.x; i < 2 * ncols; i += cs * kThreads) {
    const int which = i / ncols;
    const int c = i - which * ncols;
    float v = 0.f;
    for (int r = 0; r < cs; ++r) v += cl.map_shared_rank(sums, r)[which * ld_s + c];
    row[which * C + c] = v;
  }
  cluster_barrier(cl, cs);
  if (rank == 0 && threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(tk + 1) : "memory");
  }
  return *flag != 0;
}

// In the batch row's finishing cluster: once every cluster's row is
// written, the Pr partial rows (ld floats apart, a multiple of 4) added up
// in float64 in ascending row order and rounded once into row Pr, block
// `rank` of `cs` taking its range of the row's 16-byte columns, four
// columns a thread; where the range leaves threads idle its rows split into
// runs, added in run order (the runs' sums in scratch, 128 x 4 doubles of
// the block's shared memory, free once its sums are added).  The split
// follows (Pr, ld, cs) alone, not which cluster came last.  Ends with the
// cluster barrier, after which rank 0 may read the whole totals row; rank
// 0 then sets the tickets back to 0.
__device__ void column_totals(float* part, int Pr, int ld, const int* tk, int nclusters,
                              double* scratch) {
  cg::cluster_group cl = cg::this_cluster();
  const int cs = static_cast<int>(cl.num_blocks()), rank = static_cast<int>(cl.block_rank());
  if (threadIdx.x == 0) {  // acquire; the barrier passes it to the block
    while (load_acquire(tk + 1) < nclusters) __nanosleep(32);
  }
  __syncthreads();
  const int nv = ld / 4, per = (nv + cs - 1) / cs;
  const int c0 = min(nv, rank * per), nc = min(nv, c0 + per) - c0;
  float4* tot = reinterpret_cast<float4*>(part + static_cast<size_t>(Pr) * ld);
  const int splits = nc > 0 ? max(1, min(kThreads / nc, Pr)) : 1;
  const int run = (Pr + splits - 1) / splits;
  for (int i = threadIdx.x; i < nc * splits; i += kThreads) {
    const int s = i / nc;
    const int c = c0 + i - s * nc;
    const int p1 = min(Pr, (s + 1) * run);
    double v[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll 16
    for (int p = s * run; p < p1; ++p) {
      const float4 x =
          __ldcg(reinterpret_cast<const float4*>(part + static_cast<size_t>(p) * ld) + c);
      v[0] += x.x;
      v[1] += x.y;
      v[2] += x.z;
      v[3] += x.w;
    }
    if (splits == 1) {
      tot[c] = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int e = 0; e < 4; ++e) scratch[4 * i + e] = v[e];
    }
  }
  if (splits > 1) {
    __syncthreads();
    for (int c = threadIdx.x; c < nc; c += kThreads) {
      double v[4] = {scratch[4 * c], scratch[4 * c + 1], scratch[4 * c + 2], scratch[4 * c + 3]};
      for (int s = 1; s < splits; ++s) {
        for (int e = 0; e < 4; ++e) v[e] += scratch[4 * (s * nc + c) + e];
      }
      tot[c0 + c] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  __threadfence();  // this block's share of the totals, before the barrier
  cluster_barrier(cl, cs);
}

__device__ __forceinline__ void mean_rstd(float sum, float ssq, float cnt, float& mean,
                                          float& rstd) {
  mean = sum / cnt;
  rstd = rsqrtf(fmaxf(ssq / cnt - mean * mean, 0.f) + 1e-5f);
}

// (mean, rstd) -> grp[2 g], grp[2 g + 1] of the ng <= 32 groups of gs
// consecutive channels of a GroupNorm over cnt values a channel's group,
// channel i's (sum, sum of squares) at(i): lane g of each warp adds its
// warp's share of group g's channels (every fourth), the four warps' sums
// then added in warp order through scratch (256 floats).
template <typename At>
__device__ void group_stats(int ng, int gs, float cnt, At at, float* grp, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float s = 0.f, q = 0.f;
  if (lane < ng) {
#pragma unroll 4
    for (int i = warp; i < gs; i += kThreads / 32) {
      const float2 v = at(lane * gs + i);
      s += v.x;
      q += v.y;
    }
  }
  scratch[2 * threadIdx.x] = s;
  scratch[2 * threadIdx.x + 1] = q;
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < ng) {
    s = q = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) {
      s += scratch[2 * (w * 32 + threadIdx.x)];
      q += scratch[2 * (w * 32 + threadIdx.x) + 1];
    }
    mean_rstd(s, q, cnt, grp[2 * threadIdx.x], grp[2 * threadIdx.x + 1]);
  }
  __syncthreads();
}

// (mu, s, b) in bf16 of a GroupNorm of C channels from its groups' (mean,
// rstd) in grp (gs channels a group, identity lanes past normed)
__device__ void write_pgn(const float* grp, int gs, int normed, int C, const float* sc,
                          const float* bi, bf16* mu, bf16* s, bf16* bb) {
  for (int c = threadIdx.x; c < C; c += kThreads) {
    if (c < normed) {
      const int g = c / gs;
      mu[c] = rb(grp[2 * g]);
      s[c] = rb(grp[2 * g + 1] * sc[c]);
      bb[c] = rb(bi[c]);
    } else {
      mu[c] = rb(0.f);
      s[c] = rb(1.f);
      bb[c] = rb(0.f);
    }
  }
}

// Sweep 1's finish, in rank 0 of the batch row's last cluster, from the totals
// row tot (sums of k's c2 channels, the values' Co, q's c1, then their
// squares): the first GroupNorm over [q, k], a q channel's sums times K
// (each q row stands for K rows) -> q's and k's per-channel float32 (mul,
// add), identity past normed0; the values' GroupNorm -> (mu, s, b) in bf16.
// red: the groups' (mean, rstd), the first GroupNorm's then the values',
// and group_stats' scratch.
__device__ void finish_stats(const Args& a, const Dims& d, int b, const float* tot, float* red) {
  const int c12 = d.c1 + d.c2, ctot = d.c2 + d.Co + d.c1;
  const int ng0 = min(32, c12), normed0 = c12 - c12 % ng0, gs0 = normed0 / ng0;
  const int ng2 = min(32, d.Co), normed2 = d.Co - d.Co % ng2, gs2 = normed2 / ng2;
  const float rows = static_cast<float>(d.M) * static_cast<float>(d.K);
  const float K = static_cast<float>(d.K);
  const float* qt = tot + d.c2 + d.Co;
  group_stats(ng0, gs0, rows * static_cast<float>(gs0), [&](int i) {
    return i < d.c1 ? make_float2(__ldcg(qt + i) * K, __ldcg(qt + ctot + i) * K)
                    : make_float2(__ldcg(tot + i - d.c1), __ldcg(tot + ctot + i - d.c1));
  }, red, red + 128);
  group_stats(ng2, gs2, rows * static_cast<float>(gs2), [&](int i) {
    return make_float2(__ldcg(tot + d.c2 + i), __ldcg(tot + ctot + d.c2 + i));
  }, red + 64, red + 128);
  for (int i = threadIdx.x; i < c12; i += kThreads) {
    float mul = 1.f, add = 0.f;
    if (i < normed0) {
      const int g = i / gs0;
      mul = red[2 * g + 1] * a.sc0[i];
      add = a.bi0[i] - red[2 * g] * mul;
    }
    if (i < d.c1) {
      a.mulq[static_cast<size_t>(b) * d.c1 + i] = mul;
      a.addq[static_cast<size_t>(b) * d.c1 + i] = add;
    } else {
      a.omulk[static_cast<size_t>(b) * d.c2 + i - d.c1] = mul;
      a.oaddk[static_cast<size_t>(b) * d.c2 + i - d.c1] = add;
    }
  }
  const size_t o = static_cast<size_t>(b) * d.Co;
  write_pgn(red + 64, gs2, normed2, d.Co, a.sc2, a.bi2, a.fmu + o, a.fs + o, a.fbb + o);
}

// Sweep 2's finish: h's GroupNorm -> (mu, s, b) in bf16, from the totals
// row tot (sums of h's I channels, then their squares)
__device__ void finish_h(const Args& a, const Dims& d, int b, const float* tot, float* red) {
  const int ng = min(32, d.I), normed = d.I - d.I % ng, gs = normed / ng;
  group_stats(ng, gs, static_cast<float>(d.M) * static_cast<float>(d.K) * static_cast<float>(gs),
              [&](int i) { return make_float2(__ldcg(tot + i), __ldcg(tot + d.I + i)); }, red,
              red + 128);
  const size_t o = static_cast<size_t>(b) * d.I;
  write_pgn(red, gs, normed, d.I, a.sc0, a.bi0, a.fmu + o, a.fs + o, a.fbb + o);
}

// Sweep 1: per-column sums and sums of squares of k = relu(g W1 + b1) and
// v = gfo W4 + b4 over one row tile.  Blocks y < gk take groups of cpb of
// k's column chunks, the rest v's; blocks y = 0 also sum q over their
// cluster's slice of the centres.  -> the cluster's row u / cs of part
// (B, Pr + 1, row of c2 + Co + c1); the batch row's last cluster adds the
// rows up and finishes.
template <int R>
__global__ void __launch_bounds__(kThreads, 4) attn_stats_kernel(Args a, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem sm(smem_raw);
  const int nck = (d.c2p + kNC - 1) / kNC, ncv = (d.Cop + kNC - 1) / kNC;
  const int gk = (nck + d.cpb - 1) / d.cpb;
  const bool is_k = static_cast<int>(blockIdx.y) < gk;
  const int ch0 = (is_k ? blockIdx.y : blockIdx.y - gk) * d.cpb;
  const int ch1 = min(is_k ? nck : ncv, ch0 + d.cpb);
  const int C = is_k ? d.Ck : d.Cv, Cp = is_k ? d.Ckp : d.Cvp;
  const int cout = is_k ? d.c2 : d.Co, coutp = is_k ? d.c2p : d.Cop;
  const int n_lo = ch0 * kNC, n_hi = min(coutp, ch1 * kNC);
  const bf16* __restrict__ wt = is_k ? a.w1t : a.w4t;
  const bf16* __restrict__ bias = is_k ? a.b1 : a.b4;
  const int u = blockIdx.x, b = blockIdx.z;
  const int rows = d.M * d.K;
  const int nrows = min(R, rows - u * R);
  const bf16* src = (is_k ? a.g : a.gfo) + static_cast<size_t>(b) * rows * C;
  const int lda = max(d.Ckp, d.Cvp) + 8;
  Ring ring{nullptr, sm.bars, 0};
  Weight w{wt, nullptr, Cp + 8, n_lo};
  if (d.resident) {
    w.s = sm.take(d.cpb * kNC * lda);
  } else {
    ring.tiles = sm.take(kRingElems);
  }
  bf16* A = sm.take(R * lda);
  bf16* raw = sm.take(raw_elems(R, max(d.Ck, d.Cv)));
  float* red = reinterpret_cast<float*>(sm.next);
  float* csum = red + kRedFloats;  // the block's column sums: nb sums, then nb squares
  const int nb = n_hi - n_lo;
  uint64_t* abar = sm.bars + kStages;
  int* tk = a.tickets + kTicketInts * b;
  const int cs = d.P / d.Pr, uc = u / cs, rank = u - uc * cs;  // the cluster, the rank in it
  const int ticket = start_ticket(tk, rank);
  const int ctot = d.c2 + d.Co + d.c1, ld = row_floats(ctot);
  float* part = a.part + static_cast<size_t>(b) * (d.Pr + 1) * ld;
  float* row = part + static_cast<size_t>(uc) * ld;
  init_bars(sm.bars);
  const int head = issue_rows(raw, src, C, static_cast<size_t>(u) * R, nrows, abar);
  if (d.resident) {  // the block's rows of the weight, once
    stage_rows(const_cast<bf16*>(w.s), wt, Cp, n_lo, n_hi - n_lo);
    bar_arrive_copies(sm.bars);
  }
  if (blockIdx.y == 0) {  // q over the cluster's slice of the centres, while the copies land
    const int mq = (d.M + d.Pr - 1) / d.Pr;
    const int m0 = min(d.M, uc * mq);
    q_sums(a.mm + static_cast<size_t>(b) * d.M * d.c1, a.b0, d.c1, m0, min(d.M, m0 + mq),
           row + d.c2 + d.Co, row + ctot + d.c2 + d.Co, rank * kThreads + threadIdx.x,
           cs * kThreads);
    if (rank == 0) {
      for (int i = 2 * ctot + threadIdx.x; i < ld; i += kThreads) row[i] = 0.f;
    }
  }
  zero_pad(A, lda, C, Cp, R);
  bar_wait(abar, 0);
  lay_out(A, lda, raw, head, C, nrows);
  if (d.resident) bar_wait(sm.bars, 0);
  float acc[Shape<R>::NT][4];
  for (int n0 = n_lo; n0 < n_hi; n0 += kNC) {
    const int ncols = min(kNC, n_hi - n0);
    gemm<R>(acc, A, lda, Cp, w, n0, ncols, ring);
    ColSums<R> sums;
    sums.clear();
#pragma unroll
    for (int j = 0; j < Shape<R>::NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cc = acc_col<R>(j, e);
        if (cc < ncols && acc_row<R>(e) < nrows) {
          bf16 v = badd(rb(acc[j][e]), bias[n0 + cc]);
          if (is_k) v = brelu(v);
          sums.add(j, e, bf(v));
        }
      }
    }
    sums.write(red, n0 - n_lo, ncols, cout - n_lo, nb, csum);
  }
  const int nclusters = d.Pr * static_cast<int>(gridDim.y);
  int* flag = reinterpret_cast<int*>(smem_raw + kFlagOffset);
  if (!cluster_row(csum, nb, min(n_hi, cout) - n_lo, row + (is_k ? 0 : d.c2) + n_lo, ctot, tk,
                   ticket, nclusters, flag)) {
    return;
  }
  column_totals(part, d.Pr, ld, tk, nclusters, reinterpret_cast<double*>(smem_raw + kBarBytes));
  if (rank != 0) return;
  if (threadIdx.x == 0) tk[0] = tk[1] = 0;
  finish_stats(a, d, b, part + static_cast<size_t>(d.Pr) * ld, red);
}

// Sweep 2: per-column sums of h = relu(qp + (kn W2k + b2)) over one row
// tile, a group of cpb of h's column chunks -> the cluster's row u / cs of
// part (B, Pr + 1, row of I); the batch row's last cluster adds the rows up
// and finishes.
template <int R>
__global__ void __launch_bounds__(kThreads, 4) attn_hstats_kernel(Args a, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem sm(smem_raw);
  const int nch = (d.Ip + kNC - 1) / kNC;
  const int n_lo = blockIdx.y * d.cpb * kNC;
  const int n_hi = min(d.Ip, min(nch, static_cast<int>(blockIdx.y + 1) * d.cpb) * kNC);
  const int u = blockIdx.x, b = blockIdx.z;
  const int rows = d.M * d.K;
  const int nrows = min(R, rows - u * R);
  const bf16* src = a.g + static_cast<size_t>(b) * rows * d.Ck;
  const int lda = d.Ckp + 8, ldk = d.c2p + 8;
  Ring ring{nullptr, sm.bars, 0};
  Weight w1{a.w1t, nullptr, lda, 0}, w2{a.w2kt, nullptr, ldk, n_lo};
  if (d.resident) {
    w1.s = sm.take(d.c2p * lda);
    w2.s = sm.take(d.cpb * kNC * ldk);
  } else {
    ring.tiles = sm.take(kRingElems);
  }
  bf16* A = sm.take(R * lda);
  bf16* kn = sm.take(R * ldk);
  // the raw tile lies in kn's place where it fits: kn is written after it
  // is laid out
  bf16* raw = raw_elems(R, d.Ck) <= R * ldk ? kn : sm.take(raw_elems(R, d.Ck));
  float* red = reinterpret_cast<float*>(sm.next);
  float* csum = red + kRedFloats;  // the block's column sums: nb sums, then nb squares
  const int nb = n_hi - n_lo;
  uint64_t* abar = sm.bars + kStages;
  int* tk = a.tickets + kTicketInts * b;
  const int cs = d.P / d.Pr, uc = u / cs, rank = u - uc * cs;  // the cluster, the rank in it
  const int ticket = start_ticket(tk, rank);
  init_bars(sm.bars);
  const int head = issue_rows(raw, src, d.Ck, static_cast<size_t>(u) * R, nrows, abar);
  if (d.resident) {
    stage_rows(const_cast<bf16*>(w1.s), a.w1t, d.Ckp, 0, d.c2p);
    stage_rows(const_cast<bf16*>(w2.s), a.w2kt, d.c2p, n_lo, n_hi - n_lo);
    bar_arrive_copies(sm.bars);
  }
  zero_pad(A, lda, d.Ck, d.Ckp, R);
  const float* mulk = a.mulk + static_cast<size_t>(b) * d.c2;
  const float* addk = a.addk + static_cast<size_t>(b) * d.c2;
  const bf16* qp = a.qp + static_cast<size_t>(b) * d.M * d.I;
  bar_wait(abar, 0);
  lay_out(A, lda, raw, head, d.Ck, nrows);
  if (d.resident) bar_wait(sm.bars, 0);
  key_norm<R>(A, lda, a, d, mulk, addk, kn, ldk, w1, ring);
  // the centres of this thread's two rows
  const int m_lo = (u * R + acc_row<R>(0)) / d.K, m_hi = (u * R + acc_row<R>(2)) / d.K;
  const int ld = row_floats(d.I);
  float* part = a.part + static_cast<size_t>(b) * (d.Pr + 1) * ld;
  float* row = part + static_cast<size_t>(uc) * ld;
  float acc[Shape<R>::NT][4];
  for (int n0 = n_lo; n0 < n_hi; n0 += kNC) {
    const int ncols = min(kNC, n_hi - n0);
    gemm<R>(acc, kn, ldk, d.c2p, w2, n0, ncols, ring);
    ColSums<R> sums;
    sums.clear();
#pragma unroll
    for (int j = 0; j < Shape<R>::NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cc = acc_col<R>(j, e);
        const int col = n0 + cc;
        if (cc < ncols && col < d.I && acc_row<R>(e) < nrows) {
          const bf16 kp = badd(rb(acc[j][e]), a.b2[col]);
          const int m = e < 2 ? m_lo : m_hi;
          sums.add(j, e, bf(brelu(badd(qp[static_cast<size_t>(m) * d.I + col], kp))));
        }
      }
    }
    sums.write(red, n0 - n_lo, ncols, d.I - n_lo, nb, csum);
  }
  if (blockIdx.y == 0 && rank == 0) {
    for (int i = 2 * d.I + threadIdx.x; i < ld; i += kThreads) row[i] = 0.f;
  }
  const int nclusters = d.Pr * static_cast<int>(gridDim.y);
  int* flag = reinterpret_cast<int*>(smem_raw + kFlagOffset);
  if (!cluster_row(csum, nb, min(n_hi, d.I) - n_lo, row + n_lo, d.I, tk, ticket, nclusters,
                   flag)) {
    return;
  }
  column_totals(part, d.Pr, ld, tk, nclusters, reinterpret_cast<double*>(smem_raw + kBarBytes));
  if (rank != 0) return;
  if (threadIdx.x == 0) tk[0] = tk[1] = 0;
  finish_h(a, d, b, part + static_cast<size_t>(d.Pr) * ld, red);
}

// One slot of the online softmax over a centre's slots: running maximum mx,
// sum l and weighted value sum o of column values; one exp a slot.
__device__ __forceinline__ void softmax_step(float sc, float v, float& mx, float& l, float& o) {
  if (sc > mx) {
    const float scale = __expf(mx - sc);  // 0 for the first slot (mx = -inf)
    l = l * scale + 1.f;
    o = o * scale + v;
    mx = sc;
  } else {
    const float e = __expf(sc - mx);
    l += e;
    o += v * e;
  }
}

// Sweep 3: the pooled output of one unit, a group of cpb of the output's
// column chunks.  A unit is R / K whole centres (K <= R) or one centre whose
// slots span nsub = ceil(K / R) tiles, the softmax carried across them (one
// chunk a block then).
template <int R>
__global__ void __launch_bounds__(kThreads, 4) attn_out_kernel(Args a, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem sm(smem_raw);
  const int nch = (d.Cop + kNC - 1) / kNC;
  const int n_lo = blockIdx.y * d.cpb * kNC;
  const int n_hi = min(d.Cop, min(nch, static_cast<int>(blockIdx.y + 1) * d.cpb) * kNC);
  const int u = blockIdx.x, b = blockIdx.z;
  const int rows = d.M * d.K;
  const bf16* gsrc = a.g + static_cast<size_t>(b) * rows * d.Ck;
  const bf16* vsrc = a.gfo + static_cast<size_t>(b) * rows * d.Cv;
  // kn and then the values share one buffer of stride ldk
  const int lda = max(d.Ckp, d.Ip) + 8, ldk = max(d.c2p, d.Cvp) + 8;
  Ring ring{nullptr, sm.bars, 0};
  Weight w1{a.w1t, nullptr, d.Ckp + 8, 0}, w2{a.w2kt, nullptr, d.c2p + 8, 0};
  Weight w3{a.w3t, nullptr, d.Ip + 8, n_lo}, w4{a.w4t, nullptr, d.Cvp + 8, n_lo};
  if (d.resident) {
    w1.s = sm.take(d.c2p * (d.Ckp + 8));
    w2.s = sm.take(d.Ip * (d.c2p + 8));
    w3.s = sm.take(d.cpb * kNC * (d.Ip + 8));
    w4.s = sm.take(d.cpb * kNC * (d.Cvp + 8));
  } else {
    ring.tiles = sm.take(kRingElems);
  }
  bf16* A = sm.take(R * lda);  // g, then hn
  bf16* kn = sm.take(R * ldk);  // the raw g tile, kn, then the values
  bf16* V = kn;
  const int ldv = ldk;
  bf16* sS = sm.take(R * kSLd);
  bf16* sV = sm.take(R * kSLd);
  // raw tiles lie in buffers free while they wait, where they fit: g's in
  // kn's place, gfo's in the scores' and values' chunks
  bf16* rawg = raw_elems(R, d.Ck) <= R * ldk ? kn : sm.take(raw_elems(R, d.Ck));
  bf16* rawv = raw_elems(R, d.Cv) <= 2 * R * kSLd ? sS : sm.take(raw_elems(R, d.Cv));
  uint64_t* abar = sm.bars + kStages;
  init_bars(sm.bars, 2 * kThreads);  // both matrices' copies of every thread
  const float* mulk = a.mulk + static_cast<size_t>(b) * d.c2;
  const float* addk = a.addk + static_cast<size_t>(b) * d.c2;
  const bf16* qp = a.qp + static_cast<size_t>(b) * d.M * d.I;
  const bf16* mu1 = a.mu1 + static_cast<size_t>(b) * d.I;
  const bf16* s1 = a.s1 + static_cast<size_t>(b) * d.I;
  const bf16* bb1 = a.bb1 + static_cast<size_t>(b) * d.I;
  const bf16* mu2 = a.mu2 + static_cast<size_t>(b) * d.Co;
  const bf16* s2 = a.s2 + static_cast<size_t>(b) * d.Co;
  const bf16* bb2 = a.bb2 + static_cast<size_t>(b) * d.Co;
  const int* counts = a.counts != nullptr ? a.counts + static_cast<size_t>(b) * d.M : nullptr;
  float* out = a.out + static_cast<size_t>(b) * d.M * d.Co;
  const bf16 masked = rb(-1e9f);

  const bool whole = d.K <= R;  // a tile holds whole centres
  const int cpt = whole ? R / d.K : 1;
  const int nsub = whole ? 1 : (d.K + R - 1) / R;
  const int m0 = u * cpt;
  if (d.resident) {
    stage_rows(const_cast<bf16*>(w1.s), a.w1t, d.Ckp, 0, d.c2p);
    stage_rows(const_cast<bf16*>(w2.s), a.w2kt, d.c2p, 0, d.Ip);
    stage_rows(const_cast<bf16*>(w3.s), a.w3t, d.Ip, n_lo, n_hi - n_lo);
    stage_rows(const_cast<bf16*>(w4.s), a.w4t, d.Cvp, n_lo, n_hi - n_lo);
    bar_arrive_copies(sm.bars);
  }
  float acc[Shape<R>::NT][4];
  float mx = -INFINITY, l = 0.f, o = 0.f;  // a centre's state across its tiles
  for (int s = 0; s < nsub; ++s) {
    const int row0 = whole ? m0 * d.K : u * d.K + s * R;
    const int nrows = whole ? min(cpt, d.M - m0) * d.K : min(R, d.K - s * R);
    const int hg = issue_rows(rawg, gsrc, d.Ck, row0, nrows, abar);
    const int hv = issue_rows(rawv, vsrc, d.Cv, row0, nrows, abar);
    bar_wait(abar, s & 1);
    lay_out(A, lda, rawg, hg, d.Ck, nrows);
    zero_pad(A, lda, d.Ck, d.Ckp, R);  // the last tile's hn lay there
    if (d.resident && s == 0) bar_wait(sm.bars, 0);
    // kn, then h = relu(qp + kn W2k + b2) -> hn = GN1(h) in A's place
    key_norm<R>(A, lda, a, d, mulk, addk, kn, ldk, w1, ring);
    const int r_lo = acc_row<R>(0), r_hi = acc_row<R>(2);
    const int m_lo = whole ? m0 + r_lo / d.K : u;
    const int m_hi = whole ? m0 + r_hi / d.K : u;
    for (int h0 = 0; h0 < d.Ip; h0 += kNC) {
      const int hc = min(kNC, d.Ip - h0);
      gemm<R>(acc, kn, ldk, d.c2p, w2, h0, hc, ring);
#pragma unroll
      for (int j = 0; j < Shape<R>::NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cc = acc_col<R>(j, e);
          if (cc < hc) {
            const int col = h0 + cc;
            const int row = e < 2 ? r_lo : r_hi;
            bf16 hn = rb(0.f);
            if (row < nrows && col < d.I) {
              const bf16 kp = badd(rb(acc[j][e]), a.b2[col]);
              const int m = e < 2 ? m_lo : m_hi;
              const bf16 h = brelu(badd(qp[static_cast<size_t>(m) * d.I + col], kp));
              hn = badd(bmul(bsub(h, mu1[col]), s1[col]), bb1[col]);
            }
            A[row * lda + col] = hn;
          }
        }
      }
    }
    __syncthreads();  // every warp is done with kn: the values take its place
    lay_out(V, ldv, rawv, hv, d.Cv, nrows);
    zero_pad(V, ldv, d.Cv, d.Cvp, R);
    bool keep_lo = true, keep_hi = true;
    if (counts != nullptr) {
      const int slot_lo = whole ? r_lo % d.K : s * R + r_lo;
      const int slot_hi = whole ? r_hi % d.K : s * R + r_hi;
      if (r_lo < nrows) keep_lo = slot_lo < max(counts[m_lo], 1);
      if (r_hi < nrows) keep_hi = slot_hi < max(counts[m_hi], 1);
    }
    // scores (masked) and values of each of the block's column chunks
    for (int n0 = n_lo; n0 < n_hi; n0 += kNC) {
      const int ncols = min(kNC, n_hi - n0);
      gemm<R>(acc, A, lda, d.Ip, w3, n0, ncols, ring);
#pragma unroll
      for (int j = 0; j < Shape<R>::NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cc = acc_col<R>(j, e);
          if (cc < ncols) {
            const bf16 sc = badd(rb(acc[j][e]), a.b3[n0 + cc]);
            sS[acc_row<R>(e) * kSLd + cc] = (e < 2 ? keep_lo : keep_hi) ? sc : masked;
          }
        }
      }
      gemm<R>(acc, V, ldv, d.Cvp, w4, n0, ncols, ring);
#pragma unroll
      for (int j = 0; j < Shape<R>::NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cc = acc_col<R>(j, e);
          if (cc < ncols) {
            const int col = n0 + cc;
            bf16 vn = rb(0.f);
            if (col < d.Co) {
              const bf16 vd = badd(rb(acc[j][e]), a.b4[col]);
              vn = brelu(badd(bmul(bsub(vd, mu2[col]), s2[col]), bb2[col]));
            }
            sV[acc_row<R>(e) * kSLd + cc] = vn;
          }
        }
      }
      __syncthreads();
      if (whole) {
        const int ncent = nrows / d.K;
        for (int i = threadIdx.x; i < ncent * ncols; i += kThreads) {
          const int mt = i / ncols;
          const int cc = i - mt * ncols;
          if (n0 + cc < d.Co) {
            float cmx = -INFINITY, cl = 0.f, co = 0.f;
            for (int k = 0; k < d.K; ++k) {
              const int r = mt * d.K + k;
              softmax_step(bf(sS[r * kSLd + cc]), bf(sV[r * kSLd + cc]), cmx, cl, co);
            }
            out[static_cast<size_t>(m0 + mt) * d.Co + n0 + cc] = co / cl;
          }
        }
      } else if (static_cast<int>(threadIdx.x) < ncols) {
        const int cc = threadIdx.x;
        for (int r = 0; r < nrows; ++r) {
          softmax_step(bf(sS[r * kSLd + cc]), bf(sV[r * kSLd + cc]), mx, l, o);
        }
        if (s + 1 == nsub && n0 + cc < d.Co) out[static_cast<size_t>(u) * d.Co + n0 + cc] = o / l;
      }
      // the next chunk's (or tile's) products start with a barrier before
      // sS / sV (or A / V) are rewritten
    }
    __syncthreads();  // raw buffers and A / V are rewritten by the next tile
  }
}

// ---- the query rows -----------------------------------------------------------
// qn = bf16(bf16(qd) * mul + add), qd = relu(bf16(mm + b0)), over (B, M, c1)
// with q's per-channel (mul, add) (B, c1) from sweep 1's finish: a thread 8
// consecutive values, one 16-byte load and store, where c1 is a multiple
// of 8 and the pointers are 16-byte aligned (vec); else one value a thread.
// Bound by bytes: mm read once, qn written once.
constexpr int kQnThreads = 256;

__global__ void __launch_bounds__(kQnThreads) attn_qn_kernel(
    const bf16* __restrict__ mm, const bf16* __restrict__ b0, const float* __restrict__ mulq,
    const float* __restrict__ addq, bf16* __restrict__ qn, int M, int c1, size_t n, int vec) {
  const size_t stride = static_cast<size_t>(gridDim.x) * kQnThreads;
  const size_t first = static_cast<size_t>(blockIdx.x) * kQnThreads + threadIdx.x;
  if (vec) {
    for (size_t v = first; v < n / 8; v += stride) {
      const size_t row = 8 * v / c1;
      const int c = static_cast<int>(8 * v - row * c1);
      const size_t bc = row / M * c1 + c;
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(mm) + v);
      const float4 m0 = __ldg(reinterpret_cast<const float4*>(mulq + bc));
      const float4 m1 = __ldg(reinterpret_cast<const float4*>(mulq + bc) + 1);
      const float4 a0 = __ldg(reinterpret_cast<const float4*>(addq + bc));
      const float4 a1 = __ldg(reinterpret_cast<const float4*>(addq + bc) + 1);
      const float mul[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
      const float add[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const bf16* xv = reinterpret_cast<const bf16*>(&x);
      uint4 y;
      bf16* yv = reinterpret_cast<bf16*>(&y);
#pragma unroll
      for (int e = 0; e < 8; ++e) yv[e] = rb(bf(brelu(badd(xv[e], b0[c + e]))) * mul[e] + add[e]);
      reinterpret_cast<uint4*>(qn)[v] = y;
    }
  } else {
    for (size_t i = first; i < n; i += stride) {
      const size_t row = i / c1;
      const int c = static_cast<int>(i - row * c1);
      const size_t bc = row / M * c1 + c;
      qn[i] = rb(bf(brelu(badd(mm[i], b0[c]))) * mulq[bc] + addq[bc]);
    }
  }
}

// ---- host side --------------------------------------------------------------

// weights a block keeps resident (elements), given d.cpb
size_t weight_elems(int S, const Dims& d) {
  const size_t rows = static_cast<size_t>(d.cpb) * kNC;
  if (S == 1) return rows * (std::max(d.Ckp, d.Cvp) + 8);
  if (S == 2) return static_cast<size_t>(d.c2p) * (d.Ckp + 8) + rows * (d.c2p + 8);
  return static_cast<size_t>(d.c2p) * (d.Ckp + 8) + static_cast<size_t>(d.Ip) * (d.c2p + 8) +
         rows * (d.Ip + 8 + d.Cvp + 8);
}

// shared memory of sweep S (1, 2, 3) at R rows a tile, given d.cpb and
// d.resident
size_t smem_bytes(int S, int R, const Dims& d) {
  size_t e = d.resident ? weight_elems(S, d) : kRingElems;
  if (S == 1) {
    e += static_cast<size_t>(R) * (std::max(d.Ckp, d.Cvp) + 8) + raw_elems(R, std::max(d.Ck, d.Cv));
  } else if (S == 2) {
    const int ldk = d.c2p + 8;
    e += static_cast<size_t>(R) * (d.Ckp + 8 + ldk);
    if (raw_elems(R, d.Ck) > R * ldk) e += raw_elems(R, d.Ck);
  } else {
    const int ldk = std::max(d.c2p, d.Cvp) + 8;
    e += static_cast<size_t>(R) * (std::max(d.Ckp, d.Ip) + 8 + ldk + 2 * kSLd);
    if (raw_elems(R, d.Ck) > R * ldk) e += raw_elems(R, d.Ck);
    if (raw_elems(R, d.Cv) > 2 * R * kSLd) e += raw_elems(R, d.Cv);
  }
  // sweeps 1 and 2: a chunk's row-group sums, then the block's column sums
  return kBarBytes + 2 * e + (S == 3 ? 0 : kRedBytes + 2 * sizeof(float) * d.cpb * kNC);
}

template <int S, int R>
void* kernel_of() {
  if (S == 1) return reinterpret_cast<void*>(attn_stats_kernel<R>);
  if (S == 2) return reinterpret_cast<void*>(attn_hstats_kernel<R>);
  return reinterpret_cast<void*>(attn_out_kernel<R>);
}

template <int S, int R>
cudaError_t allow_smem(size_t smem) {
  static size_t allowed = 0;  // the dynamic shared memory this variant may take
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel_of<S, R>(), cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) allowed = smem;
  return err;
}

// How a sweep runs at these sizes.  One block a row tile (sweeps 1 and 2)
// or unit (sweep 3) and a group of cpb column chunks: every chunk in one
// block where the row tiles alone give kTargetBlocks, fewer (down to one)
// where they do not, since each group repeats the block's shared products
// (k, and h for sweep 3).  The row tile R (64, 32 or 16) is the one that
// keeps the most rows in flight on an SM (blocks that fit its shared memory
// times R; the larger on a tie); the weights are kept resident when they
// take at most kResidentElems and no more shared memory than the ring.
constexpr int kTargetBlocks = 264;  // two a streaming multiprocessor

struct Plan {
  int R, resident, cpb, groups, units;
  size_t smem;
};

// Blocks of a sweep that fit one streaming multiprocessor: its 228 KB of
// shared memory (1 KB reserved a block), and at most four by registers
// (__launch_bounds__ caps a thread at 128).
int blocks_per_sm(size_t smem) {
  return std::min(4, static_cast<int>(233472 / (smem + 1024)));
}

Plan plan(int S, Dims d, int B) {
  auto nchunks = [](int cp) { return (cp + kNC - 1) / kNC; };
  Plan best{0, 0, 0, 0, 0, 0};
  int best_rows = 0;  // rows in flight on an SM: blocks a SM x R
  for (int R = 64; R >= 16; R /= 2) {
    const int cpt = d.K <= R ? R / d.K : 1;
    const int units = S == 3 ? (d.M + cpt - 1) / cpt : (d.M * d.K + R - 1) / R;
    const int want = std::max(1, (kTargetBlocks + units * B - 1) / (units * B));
    int cpb, groups;
    if (S == 1) {
      const int nck = nchunks(d.c2p), ncv = nchunks(d.Cop);
      cpb = std::max(1, (nck + ncv + want - 1) / want);
      groups = (nck + cpb - 1) / cpb + (ncv + cpb - 1) / cpb;
    } else {
      const int n = nchunks(S == 2 ? d.Ip : d.Cop);
      cpb = (S == 3 && d.K > R) ? 1 : std::max(1, (n + want - 1) / want);
      groups = (n + cpb - 1) / cpb;
    }
    d.cpb = cpb;
    d.resident = 0;
    const size_t streamed = smem_bytes(S, R, d);
    d.resident = weight_elems(S, d) <= static_cast<size_t>(kResidentElems);
    size_t smem = smem_bytes(S, R, d);
    if (smem > kMaxSmem || smem > streamed) {
      d.resident = 0;
      smem = streamed;
    }
    if (smem > kMaxSmem) continue;
    // a unit of the out sweep that splits a centre takes one column chunk
    // a block, repeating k and h for each: only where no whole-centre tile fits
    if (S == 3 && d.K > R && best.R != 0 && d.K <= best.R) continue;
    const int rows = blocks_per_sm(smem) * R;
    if (rows > best_rows) {
      best = Plan{R, d.resident, cpb, groups, units, smem};
      best_rows = rows;
    }
  }
  return best;
}

// ---- clusters of sweeps 1 and 2 ------------------------------------------
// Sweeps 1 and 2 launch in clusters of cs consecutive row tiles, cs dividing
// the row tiles: the largest of kMaxCluster, ..., 2 whose clusters keep at
// least (kResidentLoss - 1) / kResidentLoss of the blocks lone blocks keep
// resident (a cluster must fit one GPC), and 1 where none does or where the
// grid is less than one wave of lone blocks (clusters are packed onto fewer
// SMs than lone blocks are spread over).  Clusters of 4 and 8 ran the 17
// sites of a denoise step slower than clusters of 2 on an H100 (PERF.md):
// each block waits at the cluster barriers for the cluster's slowest.
constexpr int kMaxCluster = 2;
constexpr int kResidentLoss = 16;

// Blocks of `fn` resident at once on the current device in clusters of cs
// (cudaOccupancyMaxActiveClusters; cs = 1: blocks an SM times the SMs),
// asked once per device, kernel, shared memory and cluster size.
cudaError_t resident_blocks(const void* fn, size_t smem, int cs, int* n) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, size_t, int>, int> seen;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(device, fn, smem, cs);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = seen.find(key);
  if (it != seen.end()) {
    *n = it->second;
    return cudaSuccess;
  }
  int count = 0;
  if (cs == 1) {
    int sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&count, fn, kThreads, smem);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    count *= sms;
  } else {
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cs;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cs, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&count, fn, &cfg);
    count *= cs;
  }
  if (err != cudaSuccess) return err;
  *n = seen[key] = count;
  return cudaSuccess;
}

template <int S, int R>
cudaError_t cluster_size(const Plan& p, int B, int* cs) {
  *cs = 1;
  cudaError_t err = allow_smem<S, R>(p.smem);
  int lone = 0;
  if (err == cudaSuccess) err = resident_blocks(kernel_of<S, R>(), p.smem, 1, &lone);
  if (err != cudaSuccess || static_cast<long>(p.units) * p.groups * B < lone) return err;
  for (int c = kMaxCluster; c > 1; c /= 2) {
    if (p.units % c != 0) continue;
    int n = 0;
    err = resident_blocks(kernel_of<S, R>(), p.smem, c, &n);
    if (err != cudaSuccess) return err;
    if (static_cast<long>(n) * kResidentLoss >= static_cast<long>(lone) * (kResidentLoss - 1)) {
      *cs = c;
      break;
    }
  }
  return cudaSuccess;
}

template <int S>
cudaError_t cluster_of(const Plan& p, int B, int* cs) {
  if (p.R == 64) return cluster_size<S, 64>(p, B, cs);
  if (p.R == 32) return cluster_size<S, 32>(p, B, cs);
  return cluster_size<S, 16>(p, B, cs);
}

// Sweeps 1 and 2: d.Pr must be the row tiles over the cluster size (the
// caller sized the partial sums by it: Pr + 1 rows a batch row, the last the
// totals).  A refused cluster launch returns its error.
template <int S, int R>
int launch_at(const Args& a, Dims d, const Plan& p, int B, cudaStream_t s) {
  cudaError_t err = allow_smem<S, R>(p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  d.cpb = p.cpb;
  d.resident = p.resident;
  const dim3 grid(p.units, p.groups, B);
  if constexpr (S == 3) {
    attn_out_kernel<R><<<grid, kThreads, p.smem, s>>>(a, d);
  } else {
    int cs = 1;
    err = cluster_size<S, R>(p, B, &cs);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (p.units / cs != d.Pr) return static_cast<int>(cudaErrorInvalidValue);
    d.P = p.units;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cs;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = p.smem;
    cfg.stream = s;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    if constexpr (S == 1) {
      err = cudaLaunchKernelEx(&cfg, attn_stats_kernel<R>, a, d);
    } else {
      err = cudaLaunchKernelEx(&cfg, attn_hstats_kernel<R>, a, d);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  PDR_RETURN_LAUNCH_ERROR();
}

// The caller's P: the plan's row blocks (sweep 3) or the rows of partial
// sums (sweeps 1 and 2, in d.Pr).
template <int S>
int run(const Args& a, Dims d, int B, cudaStream_t s) {
  if (B < 1 || d.M < 1 || d.K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan(S, d, B);
  if (p.R == 0 || (S == 3 && p.units != d.P)) return static_cast<int>(cudaErrorInvalidValue);
  if (p.R == 64) return launch_at<S, 64>(a, d, p, B, s);
  if (p.R == 32) return launch_at<S, 32>(a, d, p, B, s);
  return launch_at<S, 16>(a, d, p, B, s);
}

Dims make_dims(int M, int K, int P, int Ck, int Cv, int c2, int I, int Co, int c1) {
  Dims d;
  d.M = M; d.K = K; d.P = P; d.Pr = P; d.cpb = 1; d.resident = 0;
  d.Ck = Ck; d.Cv = Cv; d.c2 = c2; d.I = I; d.Co = Co; d.c1 = c1;
  d.Ckp = up16(Ck); d.Cvp = up16(Cv); d.c2p = up16(c2); d.Ip = up16(I); d.Cop = up16(Co);
  return d;
}

template <typename T>
const T* cp(const void* p) { return static_cast<const T*>(p); }

}  // namespace

// Weights are bf16, transposed (out, in) and zero-padded to multiples of 16
// on both axes; biases bf16, zero-padded alike.  Any K >= 1.  P: sweep 3's
// row blocks (pdr_attention_row_blocks); for sweeps 1 and 2 the rows of
// partial sums, their row blocks over pdr_attention_cluster_size (the
// partial sums have P + 1 rows a batch row, the last their column totals,
// each row C sums and C squares padded to a multiple of 4 floats).
// tickets: (B, 2) int32, zero on entry, left zero; launches that share them
// must not overlap.  A width whose 16-row tile does not fit a block's shared
// memory returns cudaErrorInvalidValue.

// Sweep 1 and its finish.  g (B, M, K, Ck), gfo (B, M, K, Cv) bf16, mm
// (B, M, c1) bf16 = feat W0 (before its bias), b0 (c1) bf16, the first
// GroupNorm's scale / bias (normed0) and the values' (normed2) float32 ->
// part (B, P + 1, row of c2 + Co + c1) float32 (the row tiles' sums of k,
// v and q; row P their totals), mulq / addq (B, c1) and mulk / addk (B, c2)
// float32, mu2 / s2 / bb2 (B, Co) bf16.
extern "C" int pdr_attention_stats(const void* g, const void* gfo, const void* w1t,
                                   const void* b1, const void* w4t, const void* b4,
                                   const void* mm, const void* b0, const void* sc0,
                                   const void* bi0, const void* sc2, const void* bi2,
                                   void* part, void* mulq, void* addq, void* mulk, void* addk,
                                   void* mu2, void* s2, void* bb2, void* tickets, int B, int M,
                                   int K, int Ck, int Cv, int c2, int Co, int c1, int P,
                                   void* stream) {
  Args a = {};
  a.g = cp<bf16>(g); a.gfo = cp<bf16>(gfo);
  a.w1t = cp<bf16>(w1t); a.b1 = cp<bf16>(b1);
  a.w4t = cp<bf16>(w4t); a.b4 = cp<bf16>(b4);
  a.mm = cp<bf16>(mm); a.b0 = cp<bf16>(b0);
  a.sc0 = cp<float>(sc0); a.bi0 = cp<float>(bi0);
  a.sc2 = cp<float>(sc2); a.bi2 = cp<float>(bi2);
  a.part = static_cast<float*>(part);
  a.mulq = static_cast<float*>(mulq); a.addq = static_cast<float*>(addq);
  a.omulk = static_cast<float*>(mulk); a.oaddk = static_cast<float*>(addk);
  a.fmu = static_cast<bf16*>(mu2); a.fs = static_cast<bf16*>(s2); a.fbb = static_cast<bf16*>(bb2);
  a.tickets = static_cast<int*>(tickets);
  if (c1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  return run<1>(a, make_dims(M, K, P, Ck, Cv, c2, 16, Co, c1), B,
                static_cast<cudaStream_t>(stream));
}

// qn = bf16(bf16(relu(bf16(mm + b0))) * mulq + addq): mm, qn (B, M, c1) bf16,
// b0 (c1) bf16, mulq / addq (B, c1) float32.
extern "C" int pdr_attention_qn(const void* mm, const void* b0, const void* mulq,
                                const void* addq, void* qn, int B, int M, int c1, void* stream) {
  if (B < 1 || M < 1 || c1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(B) * M * c1;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(mm) | reinterpret_cast<uintptr_t>(mulq) |
                         reinterpret_cast<uintptr_t>(addq) | reinterpret_cast<uintptr_t>(qn);
  const int vec = c1 % 8 == 0 && (ptrs & 15) == 0;
  const size_t work = vec ? n / 8 : n;
  const int blocks = static_cast<int>(
      std::min<size_t>((work + kQnThreads - 1) / kQnThreads, 132 * 16));
  attn_qn_kernel<<<blocks, kQnThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cp<bf16>(mm), cp<bf16>(b0), cp<float>(mulq), cp<float>(addq), static_cast<bf16*>(qn), M,
      c1, n, vec);
  PDR_RETURN_LAUNCH_ERROR();
}

// Sweep 2 and its finish.  + qp (B, M, I) bf16, mulk / addk (B, c2) float32,
// h's GroupNorm scale / bias (normed1) float32 -> part (B, P + 1, row of I), mu1
// / s1 / bb1 (B, I) bf16.
extern "C" int pdr_attention_hstats(const void* g, const void* w1t, const void* b1,
                                    const void* mulk, const void* addk, const void* w2kt,
                                    const void* b2, const void* qp, const void* sc1,
                                    const void* bi1, void* part, void* mu1, void* s1, void* bb1,
                                    void* tickets, int B, int M, int K, int Ck, int c2, int I,
                                    int P, void* stream) {
  Args a = {};
  a.g = cp<bf16>(g);
  a.w1t = cp<bf16>(w1t); a.b1 = cp<bf16>(b1);
  a.mulk = cp<float>(mulk); a.addk = cp<float>(addk);
  a.w2kt = cp<bf16>(w2kt); a.b2 = cp<bf16>(b2);
  a.qp = cp<bf16>(qp);
  a.sc0 = cp<float>(sc1); a.bi0 = cp<float>(bi1);
  a.part = static_cast<float*>(part);
  a.fmu = static_cast<bf16*>(mu1); a.fs = static_cast<bf16*>(s1); a.fbb = static_cast<bf16*>(bb1);
  a.tickets = static_cast<int*>(tickets);
  return run<2>(a, make_dims(M, K, P, Ck, 16, c2, I, 16, 32), B,
                static_cast<cudaStream_t>(stream));
}

// + the GroupNorm vectors mu/s/b of h (B, I) and of v (B, Co) in bf16, counts
// (B, M) int32 or null -> out (B, M, Co) float32.
extern "C" int pdr_attention_out(const void* g, const void* gfo, const void* w1t,
                                 const void* b1, const void* mulk, const void* addk,
                                 const void* w2kt, const void* b2, const void* qp,
                                 const void* mu1, const void* s1, const void* bb1,
                                 const void* w3t, const void* b3, const void* w4t,
                                 const void* b4, const void* mu2, const void* s2,
                                 const void* bb2, const void* counts, void* out, int B, int M,
                                 int K, int Ck, int Cv, int c2, int I, int Co, int P,
                                 void* stream) {
  Args a = {};
  a.g = cp<bf16>(g); a.gfo = cp<bf16>(gfo);
  a.w1t = cp<bf16>(w1t); a.b1 = cp<bf16>(b1);
  a.mulk = cp<float>(mulk); a.addk = cp<float>(addk);
  a.w2kt = cp<bf16>(w2kt); a.b2 = cp<bf16>(b2);
  a.qp = cp<bf16>(qp);
  a.mu1 = cp<bf16>(mu1); a.s1 = cp<bf16>(s1); a.bb1 = cp<bf16>(bb1);
  a.w3t = cp<bf16>(w3t); a.b3 = cp<bf16>(b3);
  a.w4t = cp<bf16>(w4t); a.b4 = cp<bf16>(b4);
  a.mu2 = cp<bf16>(mu2); a.s2 = cp<bf16>(s2); a.bb2 = cp<bf16>(bb2);
  a.counts = cp<int>(counts);
  a.out = static_cast<float*>(out);
  return run<3>(a, make_dims(M, K, P, Ck, Cv, c2, I, Co, 32), B,
                static_cast<cudaStream_t>(stream));
}

// The row blocks P of sweep S (1: stats, 2: hstats, 3: out) at these sizes:
// row tiles a batch row (sweeps 1, 2: the rows of partial sums, one more
// for their totals) or units of whole centres (sweep 3); 0 when no row tile
// fits a block's shared memory.
extern "C" int pdr_attention_row_blocks(int S, int B, int M, int K, int Ck, int Cv, int c2,
                                        int I, int Co) {
  if (B < 1 || M < 1 || K < 1 || S < 1 || S > 3) return 0;
  return plan(S, make_dims(M, K, 0, Ck, Cv, c2, I, Co, 32), B).units;
}

// The cluster size of sweep S (1: stats, 2: hstats) at these sizes on the
// current device; 0 when no row tile fits or a device query fails.
extern "C" int pdr_attention_cluster_size(int S, int B, int M, int K, int Ck, int Cv, int c2,
                                          int I, int Co) {
  if (B < 1 || M < 1 || K < 1 || (S != 1 && S != 2)) return 0;
  const Plan p = plan(S, make_dims(M, K, 0, Ck, Cv, c2, I, Co, 32), B);
  if (p.R == 0) return 0;
  int cs = 0;
  const cudaError_t err = S == 1 ? cluster_of<1>(p, B, &cs) : cluster_of<2>(p, B, &cs);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return cs;
}
