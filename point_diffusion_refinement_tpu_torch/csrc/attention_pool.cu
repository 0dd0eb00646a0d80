// The AttentionPool forward in three sweeps over the grouped tensors
// (statistics of k and v, statistics of h, and scores + masked softmax +
// weighted value sum) and two small finishing kernels that turn the sweeps'
// partial sums into the GroupNorm vectors.
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
// - Each block writes its per-column partial sums to its own row of a
//   (B, P, 2, C) scratch; the finishing kernels add the P rows in order, so
//   the statistics are deterministic, and write the GroupNorm vectors (and
//   the normalised query rows) in the types the next sweep reads.
//
// Rounding points (the function's, repeated by the plain version): bf16
// operands, float32 accumulation rounded to bf16, bf16 bias add; the first
// GroupNorm on the k half as a float32 multiply-add rounded to bf16; the
// second and third in bf16 as (x - mu) * s + b with mu, s, b rounded to bf16;
// scores masked with bf16(-1e9); softmax and the weighted sum in float32.
#include "common.cuh"

#include <cuda_bf16.h>

#include <algorithm>
#include <cstdint>

namespace {

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
  // the block's sums of chunk columns [0, ncols) -> part[n0 + c] (sums) and
  // part[C + n0 + c] (squares) for n0 + c < limit; fixed order: the 8 row
  // groups of a warp by shuffles, then the warps' row groups in order
  __device__ void write(float* red, int n0, int ncols, int limit, int C, float* part) {
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
        part[which * C + n0 + c] = v;
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
  float* part;                  // (B, P, 2, C): C = c2 + Co (stats) or I (hstats)
  float* out;                   // (B, M, Co)
};

struct Dims {
  int M, K, P;                  // centres, slots, row blocks (tiles or units) a batch row
  int cpb, resident;            // column chunks a block; weights kept in shared memory
  int Ck, Cv, c2, I, Co;        // channel counts
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

// Sweep 1: per-column sums and sums of squares of k = relu(g W1 + b1) and
// v = gfo W4 + b4 over one row tile -> row u of part (B, P, 2, c2 + Co).
// Blocks y < gk take groups of cpb of k's column chunks, the rest v's.
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
  uint64_t* abar = sm.bars + kStages;
  init_bars(sm.bars);
  const int head = issue_rows(raw, src, C, static_cast<size_t>(u) * R, nrows, abar);
  if (d.resident) {  // the block's rows of the weight, once
    stage_rows(const_cast<bf16*>(w.s), wt, Cp, n_lo, n_hi - n_lo);
    bar_arrive_copies(sm.bars);
  }
  zero_pad(A, lda, C, Cp, R);
  bar_wait(abar, 0);
  lay_out(A, lda, raw, head, C, nrows);
  if (d.resident) bar_wait(sm.bars, 0);
  const int ctot = d.c2 + d.Co;
  float* part = a.part + (static_cast<size_t>(b) * d.P + u) * 2 * ctot + (is_k ? 0 : d.c2);
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
    sums.write(red, n0, ncols, cout, ctot, part);
  }
}

// Sweep 2: per-column sums of h = relu(qp + (kn W2k + b2)) over one row
// tile, a group of cpb of h's column chunks -> row u of part (B, P, 2, I).
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
  uint64_t* abar = sm.bars + kStages;
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
  float* part = a.part + (static_cast<size_t>(b) * d.P + u) * 2 * d.I;
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
    sums.write(red, n0, ncols, d.I, d.I, part);
  }
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

// ---- finishing kernels --------------------------------------------------
// (a, b) summed over the block in a fixed order; every thread gets the sums
__device__ __forceinline__ void block_sum2(float& a, float& b, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(PDR_FULL_MASK, a, off);
    b += __shfl_xor_sync(PDR_FULL_MASK, b, off);
  }
  if (lane == 0) {
    red[2 * warp] = a;
    red[2 * warp + 1] = b;
  }
  __syncthreads();
  a = red[0];
  b = red[1];
  for (int w = 1; w < kThreads / 32; ++w) {
    a += red[2 * w];
    b += red[2 * w + 1];
  }
}

// sums over the P partial rows (B, P, 2, ctot) of channels [c0, c0 + n) at
// offset `off`, this thread's share
__device__ __forceinline__ void partial_sums(const float* part, int P, int ctot, int off,
                                             int c0, int n, float& a, float& b) {
  for (int i = threadIdx.x; i < P * n; i += kThreads) {
    const int p = i / n;
    const float* row = part + static_cast<size_t>(p) * 2 * ctot + off + c0 + (i - p * n);
    a += row[0];
    b += row[ctot];
  }
}

__device__ __forceinline__ void mean_rstd(float sum, float ssq, float cnt, float& mean,
                                          float& rstd) {
  mean = sum / cnt;
  rstd = rsqrtf(fmaxf(ssq / cnt - mean * mean, 0.f) + 1e-5f);
}

struct FinishArgs {
  const bf16 *mm, *b0;          // (B, M, c1) = feat W0 rounded to bf16, (c1)
  const float* part;            // (B, P, 2, ctot)
  const float *sc0, *bi0;       // first GroupNorm (normed0)
  const float *sc2, *bi2;       // GroupNorm of the values or of h (normed)
  bf16* qn;                     // (B, M, c1)
  float *mulk, *addk;           // (B, c2)
  bf16 *mu, *s, *bb;            // (B, C) of the values or of h
  int M, K, P, c1, c2, C;       // C: c_out (after sweep 1) or inter_c (after sweep 2)
};

// After sweep 1: blocks x < ng0 finish a group of the first GroupNorm over
// [q (c1), k (c2)]: its q channels' sums over the centres (times K, each q
// row standing for K rows), its k channels' from the partials; then mulk /
// addk of its k channels and qn = bf16(qd * mul + add) of its q channels,
// qd = relu(mm + b0).  Blocks ng0 <= x < ng0 + ng2 finish a group of the
// values' GroupNorm: (mu, s, b) in bf16.  The last block writes the
// passthrough channels past each normed width (identity).
__global__ void __launch_bounds__(kThreads) attn_finish_stats_kernel(FinishArgs f) {
  __shared__ float red[2 * kThreads / 32];
  const int b = blockIdx.y, x = blockIdx.x;
  const int c12 = f.c1 + f.c2, ctot = f.c2 + f.C;
  const int ng0 = min(32, c12), normed0 = c12 - c12 % ng0;
  const int ng2 = min(32, f.C), normed2 = f.C - f.C % ng2;
  const float* part = f.part + static_cast<size_t>(b) * f.P * 2 * ctot;
  const bf16* mm = f.mm + static_cast<size_t>(b) * f.M * f.c1;
  bf16* qn = f.qn + static_cast<size_t>(b) * f.M * f.c1;
  auto qd_at = [&](int m, int c) {
    return brelu(badd(mm[static_cast<size_t>(m) * f.c1 + c], f.b0[c]));
  };
  if (x < ng0) {
    const int gs = normed0 / ng0, ch0 = x * gs;
    const int nq = max(0, min(ch0 + gs, f.c1) - ch0);  // q channels [ch0, ch0 + nq)
    const int k0 = max(ch0, f.c1) - f.c1, nk = gs - nq;  // k channels [k0, k0 + nk)
    float qa = 0.f, qb = 0.f, ka = 0.f, kb = 0.f;
    for (int i = threadIdx.x; i < f.M * nq; i += kThreads) {
      const int m = i / nq;
      const float v = bf(qd_at(m, ch0 + i - m * nq));
      qa += v;
      qb += v * v;
    }
    partial_sums(part, f.P, ctot, 0, k0, nk, ka, kb);
    block_sum2(qa, qb, red);
    __syncthreads();
    block_sum2(ka, kb, red);
    float mean, rstd;
    mean_rstd(qa * static_cast<float>(f.K) + ka, qb * static_cast<float>(f.K) + kb,
              static_cast<float>(f.M) * static_cast<float>(f.K) * static_cast<float>(gs),
              mean, rstd);
    for (int i = threadIdx.x; i < nk; i += kThreads) {
      const int ch = f.c1 + k0 + i;
      const float mul = rstd * f.sc0[ch];
      f.mulk[static_cast<size_t>(b) * f.c2 + k0 + i] = mul;
      f.addk[static_cast<size_t>(b) * f.c2 + k0 + i] = f.bi0[ch] - mean * mul;
    }
    for (int i = threadIdx.x; i < f.M * nq; i += kThreads) {
      const int m = i / nq;
      const int c = ch0 + i - m * nq;
      const float mul = rstd * f.sc0[c];
      const float add = f.bi0[c] - mean * mul;
      qn[static_cast<size_t>(m) * f.c1 + c] = rb(bf(qd_at(m, c)) * mul + add);
    }
  } else if (x < ng0 + ng2) {
    const int gs = normed2 / ng2, ch0 = (x - ng0) * gs;
    float sa = 0.f, sb = 0.f;
    partial_sums(part, f.P, ctot, f.c2, ch0, gs, sa, sb);
    block_sum2(sa, sb, red);
    float mean, rstd;
    mean_rstd(sa, sb, static_cast<float>(f.M) * static_cast<float>(f.K) * static_cast<float>(gs),
              mean, rstd);
    for (int i = threadIdx.x; i < gs; i += kThreads) {
      const size_t o = static_cast<size_t>(b) * f.C + ch0 + i;
      f.mu[o] = rb(mean);
      f.s[o] = rb(rstd * f.sc2[ch0 + i]);
      f.bb[o] = rb(f.bi2[ch0 + i]);
    }
  } else {
    const int nq = max(0, f.c1 - normed0);  // q channels past normed0
    for (int i = threadIdx.x; i < f.M * nq; i += kThreads) {
      const int m = i / nq;
      const int c = normed0 + i - m * nq;
      qn[static_cast<size_t>(m) * f.c1 + c] = qd_at(m, c);
    }
    for (int kc = max(0, normed0 - f.c1) + threadIdx.x; kc < f.c2; kc += kThreads) {
      f.mulk[static_cast<size_t>(b) * f.c2 + kc] = 1.f;
      f.addk[static_cast<size_t>(b) * f.c2 + kc] = 0.f;
    }
    for (int c = normed2 + threadIdx.x; c < f.C; c += kThreads) {
      const size_t o = static_cast<size_t>(b) * f.C + c;
      f.mu[o] = rb(0.f);
      f.s[o] = rb(1.f);
      f.bb[o] = rb(0.f);
    }
  }
}

// After sweep 2: (mu, s, b) of h's GroupNorm in bf16, one block a group and
// the last for the passthrough channels.
__global__ void __launch_bounds__(kThreads) attn_finish_h_kernel(FinishArgs f) {
  __shared__ float red[2 * kThreads / 32];
  const int b = blockIdx.y, x = blockIdx.x;
  const int ng = min(32, f.C), normed = f.C - f.C % ng;
  const float* part = f.part + static_cast<size_t>(b) * f.P * 2 * f.C;
  if (x < ng) {
    const int gs = normed / ng, ch0 = x * gs;
    float sa = 0.f, sb = 0.f;
    partial_sums(part, f.P, f.C, 0, ch0, gs, sa, sb);
    block_sum2(sa, sb, red);
    float mean, rstd;
    mean_rstd(sa, sb, static_cast<float>(f.M) * static_cast<float>(f.K) * static_cast<float>(gs),
              mean, rstd);
    for (int i = threadIdx.x; i < gs; i += kThreads) {
      const size_t o = static_cast<size_t>(b) * f.C + ch0 + i;
      f.mu[o] = rb(mean);
      f.s[o] = rb(rstd * f.sc2[ch0 + i]);
      f.bb[o] = rb(f.bi2[ch0 + i]);
    }
  } else {
    for (int c = normed + threadIdx.x; c < f.C; c += kThreads) {
      const size_t o = static_cast<size_t>(b) * f.C + c;
      f.mu[o] = rb(0.f);
      f.s[o] = rb(1.f);
      f.bb[o] = rb(0.f);
    }
  }
}

// ---- host side --------------------------------------------------------------
constexpr int kRedBytes = 2 * 4 * kNC * 4;

// shared memory of sweep S (1, 2, 3) at R rows a tile
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
  return kBarBytes + 2 * e + (S == 3 ? 0 : kRedBytes);
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

template <int S, int R>
int launch_at(const Args& a, Dims d, const Plan& p, int B, cudaStream_t s) {
  const cudaError_t err = allow_smem<S, R>(p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  d.cpb = p.cpb;
  d.resident = p.resident;
  const dim3 grid(p.units, p.groups, B);
  if (S == 1) attn_stats_kernel<R><<<grid, kThreads, p.smem, s>>>(a, d);
  if (S == 2) attn_hstats_kernel<R><<<grid, kThreads, p.smem, s>>>(a, d);
  if (S == 3) attn_out_kernel<R><<<grid, kThreads, p.smem, s>>>(a, d);
  PDR_RETURN_LAUNCH_ERROR();
}

// The caller's P must be the plan's row blocks (it sized the partial sums).
template <int S>
int run(const Args& a, Dims d, int B, cudaStream_t s) {
  if (B < 1 || d.M < 1 || d.K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan(S, d, B);
  if (p.R == 0 || p.units != d.P) return static_cast<int>(cudaErrorInvalidValue);
  if (p.R == 64) return launch_at<S, 64>(a, d, p, B, s);
  if (p.R == 32) return launch_at<S, 32>(a, d, p, B, s);
  return launch_at<S, 16>(a, d, p, B, s);
}

Dims make_dims(int M, int K, int P, int Ck, int Cv, int c2, int I, int Co) {
  Dims d;
  d.M = M; d.K = K; d.P = P; d.cpb = 1; d.resident = 0;
  d.Ck = Ck; d.Cv = Cv; d.c2 = c2; d.I = I; d.Co = Co;
  d.Ckp = up16(Ck); d.Cvp = up16(Cv); d.c2p = up16(c2); d.Ip = up16(I); d.Cop = up16(Co);
  return d;
}

template <typename T>
const T* cp(const void* p) { return static_cast<const T*>(p); }

}  // namespace

// Weights are bf16, transposed (out, in) and zero-padded to multiples of 16
// on both axes; biases bf16, zero-padded alike.  Any K >= 1.  P: the row
// blocks pdr_attention_row_blocks gives (the partial sums have P rows).  A
// width whose 16-row tile does not fit a block's shared memory returns
// cudaErrorInvalidValue.

// g (B, M, K, Ck), gfo (B, M, K, Cv) bf16 -> part (B, P, 2, c2 + Co) float32
// per-row-block partial sums of k (columns [0, c2)) and v ([c2, c2 + Co)).
extern "C" int pdr_attention_stats(const void* g, const void* gfo, const void* w1t,
                                   const void* b1, const void* w4t, const void* b4,
                                   void* part, int B, int M, int K, int Ck, int Cv, int c2,
                                   int Co, int P, void* stream) {
  Args a = {};
  a.g = cp<bf16>(g); a.gfo = cp<bf16>(gfo);
  a.w1t = cp<bf16>(w1t); a.b1 = cp<bf16>(b1);
  a.w4t = cp<bf16>(w4t); a.b4 = cp<bf16>(b4);
  a.part = static_cast<float*>(part);
  return run<1>(a, make_dims(M, K, P, Ck, Cv, c2, 16, Co), B, static_cast<cudaStream_t>(stream));
}

// + qp (B, M, I) bf16, mulk / addk (B, c2) float32 -> part (B, P, 2, I).
extern "C" int pdr_attention_hstats(const void* g, const void* w1t, const void* b1,
                                    const void* mulk, const void* addk, const void* w2kt,
                                    const void* b2, const void* qp, void* part, int B, int M,
                                    int K, int Ck, int c2, int I, int P, void* stream) {
  Args a = {};
  a.g = cp<bf16>(g);
  a.w1t = cp<bf16>(w1t); a.b1 = cp<bf16>(b1);
  a.mulk = cp<float>(mulk); a.addk = cp<float>(addk);
  a.w2kt = cp<bf16>(w2kt); a.b2 = cp<bf16>(b2);
  a.qp = cp<bf16>(qp);
  a.part = static_cast<float*>(part);
  return run<2>(a, make_dims(M, K, P, Ck, 16, c2, I, 16), B, static_cast<cudaStream_t>(stream));
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
  return run<3>(a, make_dims(M, K, P, Ck, Cv, c2, I, Co), B, static_cast<cudaStream_t>(stream));
}

// The row blocks P of sweep S (1: stats, 2: hstats, 3: out) at these sizes:
// row tiles a batch row (sweeps 1, 2) or units of whole centres (sweep 3),
// the rows of the partial sums the caller allocates and passes back; 0 when
// no row tile fits a block's shared memory.
extern "C" int pdr_attention_row_blocks(int S, int B, int M, int K, int Ck, int Cv, int c2,
                                        int I, int Co) {
  if (B < 1 || M < 1 || K < 1 || S < 1 || S > 3) return 0;
  return plan(S, make_dims(M, K, 0, Ck, Cv, c2, I, Co), B).units;
}

// After sweep 1: mm (B, M, c1) bf16 = feat W0 (before its bias), b0 (c1)
// bf16, part (B, P, 2, c2 + Co), the first GroupNorm's scale / bias
// (normed0) and the values' (normed2) float32 -> qn (B, M, c1) bf16, mulk /
// addk (B, c2) float32, mu2 / s2 / bb2 (B, Co) bf16.
extern "C" int pdr_attention_finish_stats(const void* mm, const void* b0, const void* part,
                                          const void* sc0, const void* bi0, const void* sc2,
                                          const void* bi2, void* qn, void* mulk, void* addk,
                                          void* mu2, void* s2, void* bb2, int B, int M, int K,
                                          int P, int c1, int c2, int Co, void* stream) {
  if (B < 1 || M < 1 || c1 < 1 || c2 < 1 || Co < 1) return static_cast<int>(cudaErrorInvalidValue);
  FinishArgs f = {cp<bf16>(mm), cp<bf16>(b0), cp<float>(part), cp<float>(sc0), cp<float>(bi0),
                  cp<float>(sc2), cp<float>(bi2), static_cast<bf16*>(qn),
                  static_cast<float*>(mulk), static_cast<float*>(addk), static_cast<bf16*>(mu2),
                  static_cast<bf16*>(s2), static_cast<bf16*>(bb2), M, K, P, c1, c2, Co};
  const dim3 grid(std::min(32, c1 + c2) + std::min(32, Co) + 1, B);
  attn_finish_stats_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(f);
  PDR_RETURN_LAUNCH_ERROR();
}

// After sweep 2: part (B, P, 2, I), h's GroupNorm scale / bias (normed1)
// float32 -> mu1 / s1 / bb1 (B, I) bf16.
extern "C" int pdr_attention_finish_h(const void* part, const void* sc1, const void* bi1,
                                      void* mu1, void* s1, void* bb1, int B, int M, int K,
                                      int P, int I, void* stream) {
  if (B < 1 || M < 1 || I < 1) return static_cast<int>(cudaErrorInvalidValue);
  FinishArgs f = {};
  f.part = cp<float>(part);
  f.sc2 = cp<float>(sc1);
  f.bi2 = cp<float>(bi1);
  f.mu = static_cast<bf16*>(mu1);
  f.s = static_cast<bf16*>(s1);
  f.bb = static_cast<bf16*>(bb1);
  f.M = M; f.K = K; f.P = P; f.C = I;
  const dim3 grid(std::min(32, I) + 1, B);
  attn_finish_h_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(f);
  PDR_RETURN_LAUNCH_ERROR();
}
