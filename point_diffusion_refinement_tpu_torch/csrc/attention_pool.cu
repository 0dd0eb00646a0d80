// The AttentionPool forward in three sweeps over the grouped tensors:
// statistics of k and v, statistics of h, and scores + masked softmax +
// weighted value sum.
//
// Replaces the TPU kernels ops/pallas_attention.py::_stats_kernel,
// _h_stats_kernel and _out_kernel (called by fused_attention_pool,
// pallas_attention.py:294, :348, :379).
//
// What bounds it on this card: bytes at the wide shallow levels (one read of
// the two (B, M, K, C) bf16 tensors per sweep, a few dozen operations per
// byte), operations at the deep levels (contractions of 330-650 channels
// over few rows).  Every (rows, C) intermediate between the products stays
// in shared memory; only per-tile statistics and the (B, M, c_out) result
// are written.
//
// Design: one block of four warps owns a tile of 64 rows = 64 / K whole
// centres of one batch row, so the softmax over a centre's K slots never
// leaves the block.  The four products are the kernel's own: bf16
// mma.sync.m16n8k16 with float32 accumulation, each warp 16 rows by a chunk
// of 64 output columns, the activations read from shared memory and the
// weights staged through shared memory in 64 x 64 tiles read from global
// memory (they stay in L2), so a layer wider than shared memory (651 x 651
// at the deepest level) needs no special case.  Blocks run in no order: each
// writes its per-channel partial sums to its own row of a scratch tensor and
// the caller adds the rows up, which keeps the statistics deterministic.
// The query part and the counts are indexed directly per centre.
//
// Rounding points (the function's, repeated by the plain version): bf16
// operands, float32 accumulation rounded to bf16, bf16 bias add; the first
// GroupNorm on the k half as a float32 multiply-add rounded to bf16; the
// second and third in bf16 as (x - mu) * s + b; scores masked with bf16(-1e9);
// softmax and the weighted sum in float32.
#include "common.cuh"

#include <cuda_bf16.h>

#include <algorithm>
#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 64;      // rows of a tile
constexpr int kThreads = 128;  // four warps, 16 rows each
constexpr int kNC = 64;        // output columns of a chunk
constexpr int kKC = 64;        // contraction depth of a staged weight tile
constexpr int kWLd = kKC + 8;  // row stride of the staged weight tile
constexpr int kSLd = kNC + 2;  // row stride of the score / value chunks
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ bf16 rb(float x) { return __float2bfloat16_rn(x); }
// bf16 arithmetic: the float32 result of two bf16 operands, rounded once
__device__ __forceinline__ bf16 badd(bf16 a, bf16 b) { return rb(bf(a) + bf(b)); }
__device__ __forceinline__ bf16 bsub(bf16 a, bf16 b) { return rb(bf(a) - bf(b)); }
__device__ __forceinline__ bf16 bmul(bf16 a, bf16 b) { return rb(bf(a) * bf(b)); }
__device__ __forceinline__ bf16 brelu(bf16 a) { return bf(a) > 0.f ? a : rb(0.f); }

struct Dims {
  int M, K, MT, T;            // centres, slots, centres of a tile, tiles
  int Ck, Cv, c2, I, Co;      // channel counts
  int Ckp, Cvp, c2p, Ip, Cop; // rounded up to 16
  int ld0, ld1;               // row strides of the two activation buffers
};

__host__ __device__ inline int up16(int x) { return (x + 15) / 16 * 16; }

inline Dims make_dims(int M, int K, int Ck, int Cv, int c2, int I, int Co) {
  Dims d;
  d.M = M;
  d.K = K;
  d.MT = K <= kRows ? kRows / K : 0;
  d.T = d.MT ? (M + d.MT - 1) / d.MT : 0;
  d.Ck = Ck; d.Cv = Cv; d.c2 = c2; d.I = I; d.Co = Co;
  d.Ckp = up16(Ck); d.Cvp = up16(Cv); d.c2p = up16(c2); d.Ip = up16(I); d.Cop = up16(Co);
  d.ld0 = d.ld1 = 0;
  return d;
}

// Rows [0, nrows) of a contiguous (rows, C) bf16 matrix -> dst[r * ld + c];
// columns C..Cp of every row and rows nrows..64 are zeroed.
__device__ void load_tile(bf16* dst, int ld, const bf16* __restrict__ src, int C, int Cp,
                          int nrows) {
  const int n = nrows * C;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nvec = n >> 3;
    for (int v = threadIdx.x; v < nvec; v += kThreads) {
      const uint4 raw = reinterpret_cast<const uint4*>(src)[v];
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
      int r = (v << 3) / C;
      int c = (v << 3) - r * C;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        dst[r * ld + c] = e[i];
        if (++c == C) {
          c = 0;
          ++r;
        }
      }
    }
    for (int i = (nvec << 3) + threadIdx.x; i < n; i += kThreads) {
      const int r = i / C;
      dst[r * ld + (i - r * C)] = src[i];
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int r = i / C;
      dst[r * ld + (i - r * C)] = src[i];
    }
  }
  const bf16 zero = rb(0.f);
  const int padc = Cp - C;
  for (int i = threadIdx.x; i < nrows * padc; i += kThreads) {
    const int r = i / padc;
    dst[r * ld + C + (i - r * padc)] = zero;
  }
  for (int i = threadIdx.x; i < (kRows - nrows) * Cp; i += kThreads) {
    const int r = i / Cp;
    dst[(nrows + r) * ld + (i - r * Cp)] = zero;
  }
}

__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc = A (64 x Kp, shared memory, row stride lda) times columns
// [n0, n0 + ncols) of a weight given transposed, Wt (N x Kp, global memory, k
// contiguous).  Kp and ncols are multiples of 16 and 8.  Each warp computes
// its 16 rows; acc[j][e] is row warp*16 + g + 8*(e/2), column
// n0 + 8*j + 2*t + e%2 with g = lane/4, t = lane%4.  Starts with a block
// barrier, so what the caller wrote to shared memory before is visible and
// the staging tile's earlier readers are done.
__device__ void gemm_chunk(float (&acc)[kNC / 8][4], const bf16* A, int lda, int Kp,
                           const bf16* __restrict__ Wt, int n0, int ncols, bf16* wst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kNC / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
  const bf16* a_lo = A + (warp * 16 + g) * lda + 2 * t;
  const bf16* a_hi = a_lo + 8 * lda;
  const int ntiles = ncols >> 3;
  for (int k0 = 0; k0 < Kp; k0 += kKC) {
    const int kc = min(kKC, Kp - k0);
    const int vec = kc >> 3;
    __syncthreads();
    for (int i = threadIdx.x; i < ncols * vec; i += kThreads) {
      const int n = i / vec;
      const int kk = (i - n * vec) << 3;
      *reinterpret_cast<uint4*>(wst + n * kWLd + kk) = *reinterpret_cast<const uint4*>(
          Wt + static_cast<size_t>(n0 + n) * Kp + k0 + kk);
    }
    __syncthreads();
    for (int ks = 0; ks < kc; ks += 16) {
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(a_lo + k0 + ks);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(a_hi + k0 + ks);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(a_lo + k0 + ks + 8);
      const uint32_t a3 = *reinterpret_cast<const uint32_t*>(a_hi + k0 + ks + 8);
#pragma unroll
      for (int j = 0; j < kNC / 8; ++j) {
        if (j < ntiles) {
          const bf16* bp = wst + (j * 8 + g) * kWLd + ks + 2 * t;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 8);
          mma16816(acc[j], a0, a1, a2, a3, b0, b1);
        }
      }
    }
  }
}

// Per-column sums and sums of squares of val (rows of this block's tile,
// invalid rows already zero) -> sum_out[n0 + c], ssq_out[n0 + c] for columns
// below C.  Fixed order: rows within a warp by shuffles, then warps 0..3.
__device__ void stats_chunk(const float (&val)[kNC / 8][4], int n0, int ncols, int C,
                            float* red, float* __restrict__ sum_out,
                            float* __restrict__ ssq_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ntiles = ncols >> 3;
#pragma unroll
  for (int j = 0; j < kNC / 8; ++j) {
    if (j < ntiles) {
      float s0 = val[j][0] + val[j][2];
      float s1 = val[j][1] + val[j][3];
      float q0 = val[j][0] * val[j][0] + val[j][2] * val[j][2];
      float q1 = val[j][1] * val[j][1] + val[j][3] * val[j][3];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s0 += __shfl_xor_sync(PDR_FULL_MASK, s0, off);
        s1 += __shfl_xor_sync(PDR_FULL_MASK, s1, off);
        q0 += __shfl_xor_sync(PDR_FULL_MASK, q0, off);
        q1 += __shfl_xor_sync(PDR_FULL_MASK, q1, off);
      }
      if (g == 0) {
        const int c = j * 8 + 2 * t;
        red[(warp * 2 + 0) * kNC + c] = s0;
        red[(warp * 2 + 0) * kNC + c + 1] = s1;
        red[(warp * 2 + 1) * kNC + c] = q0;
        red[(warp * 2 + 1) * kNC + c + 1] = q1;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * ncols; i += kThreads) {
    const int which = i / ncols;
    const int c = i - which * ncols;
    if (n0 + c < C) {
      float s = red[(0 * 2 + which) * kNC + c];
      s += red[(1 * 2 + which) * kNC + c];
      s += red[(2 * 2 + which) * kNC + c];
      s += red[(3 * 2 + which) * kNC + c];
      (which ? ssq_out : sum_out)[n0 + c] = s;
    }
  }
}

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
  float *kst, *vst, *hst;       // (B, T, 2, c2), (B, T, 2, Co), (B, T, 2, I)
  float* out;                   // (B, M, Co)
};

// MODE 1: statistics of k = relu(g W1 + b1) and v = gfo W4 + b4.
// MODE 2: statistics of h = relu(qp + (kn W2k + b2)).
// MODE 3: the pooled output.
template <int MODE>
__global__ void __launch_bounds__(kThreads) attention_kernel(Args a, Dims d) {
  extern __shared__ uint4 smem_raw[];
  bf16* buf0 = reinterpret_cast<bf16*>(smem_raw);
  bf16* buf1 = buf0 + kRows * d.ld0;
  bf16* wst = buf1 + kRows * d.ld1;
  bf16* aux = wst + kNC * kWLd;
  float* red = reinterpret_cast<float*>(aux);  // MODE 1, 2: (4, 2, kNC)
  bf16* sS = aux;                              // MODE 3: (64, kSLd) scores
  bf16* sV = aux + kRows * kSLd;               // MODE 3: (64, kSLd) values

  const int tile = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = tile * d.MT;
  const int ncent = min(d.MT, d.M - m0);
  const int nrows = ncent * d.K;
  const size_t row0 = static_cast<size_t>(b) * d.M * d.K + static_cast<size_t>(m0) * d.K;
  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;
  float acc[kNC / 8][4];

  load_tile(buf0, d.ld0, a.g + row0 * d.Ck, d.Ck, d.Ckp, nrows);
  if (MODE == 1) load_tile(buf1, d.ld1, a.gfo + row0 * d.Cv, d.Cv, d.Cvp, nrows);

  // ---- k = relu(g W1 + b1); its statistics, or kn = GN0(k) -> buf1
  const float* mulk = a.mulk + static_cast<size_t>(b) * d.c2;
  const float* addk = a.addk + static_cast<size_t>(b) * d.c2;
  for (int n0 = 0; n0 < d.c2p; n0 += kNC) {
    const int ncols = min(kNC, d.c2p - n0);
    gemm_chunk(acc, buf0, d.ld0, d.Ckp, a.w1t, n0, ncols, wst);
#pragma unroll
    for (int j = 0; j < kNC / 8; ++j) {
      if (j * 8 < ncols) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? r_lo : r_hi;
          const int col = n0 + j * 8 + 2 * t + (e & 1);
          const bf16 kd = brelu(badd(rb(acc[j][e]), a.b1[col]));
          if (MODE == 1) {
            acc[j][e] = row < nrows ? bf(kd) : 0.f;
          } else {
            bf16 kn = rb(0.f);
            if (col < d.c2) kn = rb(bf(kd) * mulk[col] + addk[col]);
            buf1[row * d.ld1 + col] = kn;
          }
        }
      }
    }
    if (MODE == 1) {
      float* part = a.kst + (static_cast<size_t>(b) * d.T + tile) * 2 * d.c2;
      stats_chunk(acc, n0, ncols, d.c2, red, part, part + d.c2);
    }
  }

  if (MODE == 1) {
    // ---- v = gfo W4 + b4 and its statistics
    for (int n0 = 0; n0 < d.Cop; n0 += kNC) {
      const int ncols = min(kNC, d.Cop - n0);
      gemm_chunk(acc, buf1, d.ld1, d.Cvp, a.w4t, n0, ncols, wst);
#pragma unroll
      for (int j = 0; j < kNC / 8; ++j) {
        if (j * 8 < ncols) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = e < 2 ? r_lo : r_hi;
            const int col = n0 + j * 8 + 2 * t + (e & 1);
            const bf16 vd = badd(rb(acc[j][e]), a.b4[col]);
            acc[j][e] = row < nrows ? bf(vd) : 0.f;
          }
        }
      }
      float* part = a.vst + (static_cast<size_t>(b) * d.T + tile) * 2 * d.Co;
      stats_chunk(acc, n0, ncols, d.Co, red, part, part + d.Co);
    }
    return;
  }

  // ---- h = relu(qp + (kn W2k + b2)); its statistics, or hn = GN1(h) -> buf0
  const bf16* mu1 = a.mu1 + static_cast<size_t>(b) * d.I;
  const bf16* s1 = a.s1 + static_cast<size_t>(b) * d.I;
  const bf16* bb1 = a.bb1 + static_cast<size_t>(b) * d.I;
  for (int n0 = 0; n0 < d.Ip; n0 += kNC) {
    const int ncols = min(kNC, d.Ip - n0);
    gemm_chunk(acc, buf1, d.ld1, d.c2p, a.w2kt, n0, ncols, wst);
#pragma unroll
    for (int j = 0; j < kNC / 8; ++j) {
      if (j * 8 < ncols) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? r_lo : r_hi;
          const int col = n0 + j * 8 + 2 * t + (e & 1);
          const bool live = row < nrows && col < d.I;
          bf16 h = rb(0.f);
          if (live) {
            const bf16 kp = badd(rb(acc[j][e]), a.b2[col]);
            const size_t m = static_cast<size_t>(b) * d.M + m0 + row / d.K;
            h = brelu(badd(a.qp[m * d.I + col], kp));
          }
          if (MODE == 2) {
            acc[j][e] = bf(h);
          } else {
            bf16 hn = rb(0.f);
            if (live) hn = badd(bmul(bsub(h, mu1[col]), s1[col]), bb1[col]);
            buf0[row * d.ld0 + col] = hn;
          }
        }
      }
    }
    if (MODE == 2) {
      float* part = a.hst + (static_cast<size_t>(b) * d.T + tile) * 2 * d.I;
      stats_chunk(acc, n0, ncols, d.I, red, part, part + d.I);
    }
  }
  if (MODE == 2) return;

  // ---- scores, masked softmax over K, values, weighted sum
  __syncthreads();  // every warp is done reading kn before gfo replaces it
  load_tile(buf1, d.ld1, a.gfo + row0 * d.Cv, d.Cv, d.Cvp, nrows);
  const bf16* mu2 = a.mu2 + static_cast<size_t>(b) * d.Co;
  const bf16* s2 = a.s2 + static_cast<size_t>(b) * d.Co;
  const bf16* bb2 = a.bb2 + static_cast<size_t>(b) * d.Co;
  const bf16 masked = rb(-1e9f);
  int cnt_lo = d.K, cnt_hi = d.K;
  if (a.counts != nullptr) {
    const int* cnt = a.counts + static_cast<size_t>(b) * d.M + m0;
    if (r_lo < nrows) cnt_lo = max(cnt[r_lo / d.K], 1);
    if (r_hi < nrows) cnt_hi = max(cnt[r_hi / d.K], 1);
  }
  const bool keep_lo = (r_lo % d.K) < cnt_lo, keep_hi = (r_hi % d.K) < cnt_hi;
  for (int n0 = 0; n0 < d.Cop; n0 += kNC) {
    const int ncols = min(kNC, d.Cop - n0);
    gemm_chunk(acc, buf0, d.ld0, d.Ip, a.w3t, n0, ncols, wst);
#pragma unroll
    for (int j = 0; j < kNC / 8; ++j) {
      if (j * 8 < ncols) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? r_lo : r_hi;
          const int cc = j * 8 + 2 * t + (e & 1);
          const bf16 sc = badd(rb(acc[j][e]), a.b3[n0 + cc]);
          sS[row * kSLd + cc] = (e < 2 ? keep_lo : keep_hi) ? sc : masked;
        }
      }
    }
    gemm_chunk(acc, buf1, d.ld1, d.Cvp, a.w4t, n0, ncols, wst);
#pragma unroll
    for (int j = 0; j < kNC / 8; ++j) {
      if (j * 8 < ncols) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? r_lo : r_hi;
          const int cc = j * 8 + 2 * t + (e & 1);
          const int col = n0 + cc;
          bf16 vn = rb(0.f);
          if (col < d.Co) {
            const bf16 vd = badd(rb(acc[j][e]), a.b4[col]);
            vn = brelu(badd(bmul(bsub(vd, mu2[col]), s2[col]), bb2[col]));
          }
          sV[row * kSLd + cc] = vn;
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < ncent * ncols; i += kThreads) {
      const int mt = i / ncols;
      const int cc = i - mt * ncols;
      if (n0 + cc < d.Co) {
        const bf16* sp = sS + mt * d.K * kSLd + cc;
        const bf16* vp = sV + mt * d.K * kSLd + cc;
        float mx = bf(sp[0]);
        for (int k = 1; k < d.K; ++k) mx = fmaxf(mx, bf(sp[k * kSLd]));
        float sum = 0.f;
        for (int k = 0; k < d.K; ++k) sum += expf(bf(sp[k * kSLd]) - mx);
        float o = 0.f;
        for (int k = 0; k < d.K; ++k) {
          o += bf(vp[k * kSLd]) * (expf(bf(sp[k * kSLd]) - mx) / sum);
        }
        a.out[(static_cast<size_t>(b) * d.M + m0 + mt) * d.Co + n0 + cc] = o;
      }
    }
    // the next chunk's first barrier (in gemm_chunk) separates these reads
    // from its writes to sS and sV
  }
}

template <int MODE>
int run(const Args& a, Dims d, int B, cudaStream_t stream) {
  if (d.MT < 1 || B < 1 || d.M < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (MODE == 1) {
    d.ld0 = d.Ckp + 8;
    d.ld1 = d.Cvp + 8;
  } else if (MODE == 2) {
    d.ld0 = d.Ckp + 8;
    d.ld1 = d.c2p + 8;
  } else {
    d.ld0 = std::max(d.Ckp, d.Ip) + 8;
    d.ld1 = std::max(d.c2p, d.Cvp) + 8;
  }
  const size_t aux = MODE == 3 ? 2 * kRows * kSLd * sizeof(bf16) : 4 * 2 * kNC * sizeof(float);
  const size_t smem = (static_cast<size_t>(kRows) * (d.ld0 + d.ld1) + kNC * kWLd) * sizeof(bf16) + aux;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(d.T, B);
  attention_kernel<MODE><<<grid, kThreads, smem, stream>>>(a, d);
  PDR_RETURN_LAUNCH_ERROR();
}

template <typename T>
const T* cp(const void* p) { return static_cast<const T*>(p); }

}  // namespace

// Weights are bf16, transposed (out, in) and zero-padded to multiples of 16
// on both axes; biases bf16, zero-padded alike.  K <= 64.  A size whose
// tiles do not fit shared memory returns cudaErrorInvalidValue.

// g (B, M, K, Ck), gfo (B, M, K, Cv) bf16 -> kst (B, T, 2, c2), vst
// (B, T, 2, Co) float32 per-tile partial sums, T = ceil(M / (64 / K)).
extern "C" int pdr_attention_stats(const void* g, const void* gfo, const void* w1t,
                                   const void* b1, const void* w4t, const void* b4,
                                   void* kst, void* vst, int B, int M, int K, int Ck,
                                   int Cv, int c2, int Co, void* stream) {
  Args a = {};
  a.g = cp<bf16>(g); a.gfo = cp<bf16>(gfo);
  a.w1t = cp<bf16>(w1t); a.b1 = cp<bf16>(b1);
  a.w4t = cp<bf16>(w4t); a.b4 = cp<bf16>(b4);
  a.kst = static_cast<float*>(kst); a.vst = static_cast<float*>(vst);
  return run<1>(a, make_dims(M, K, Ck, Cv, c2, 16, Co), B, static_cast<cudaStream_t>(stream));
}

// + qp (B, M, I) bf16, mulk / addk (B, c2) float32 -> hst (B, T, 2, I).
extern "C" int pdr_attention_hstats(const void* g, const void* w1t, const void* b1,
                                    const void* mulk, const void* addk, const void* w2kt,
                                    const void* b2, const void* qp, void* hst, int B, int M,
                                    int K, int Ck, int c2, int I, void* stream) {
  Args a = {};
  a.g = cp<bf16>(g);
  a.w1t = cp<bf16>(w1t); a.b1 = cp<bf16>(b1);
  a.mulk = cp<float>(mulk); a.addk = cp<float>(addk);
  a.w2kt = cp<bf16>(w2kt); a.b2 = cp<bf16>(b2);
  a.qp = cp<bf16>(qp);
  a.hst = static_cast<float*>(hst);
  return run<2>(a, make_dims(M, K, Ck, 16, c2, I, 16), B, static_cast<cudaStream_t>(stream));
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
                                 int K, int Ck, int Cv, int c2, int I, int Co, void* stream) {
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
  return run<3>(a, make_dims(M, K, Ck, Cv, c2, I, Co), B, static_cast<cudaStream_t>(stream));
}
