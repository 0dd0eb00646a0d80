"""The whole AttentionPool forward as three sweeps over the grouped tensors.

Counterpart of the JAX package's ``ops/pallas_attention.py``:
``fused_attention_pool`` has its signature and layout (Dense kernels stored
(in, out)), and the same three sweeps, each a CUDA kernel of
``csrc/attention_pool.cu`` on GPU tensors and a plain PyTorch version
(``*_plain``) on CPU tensors:

  attention_stats   k = relu(grouped W1 + b1), v = gfo W4 + b4: per-channel
                    float32 sums and sums of squares -> (B, 2, c2), (B, 2, c_out)
  attention_hstats  recompute k, first GroupNorm, kp = kn W2k + b2,
                    h = relu(qp + kp): its sums -> (B, 2, inter_c)
  attention_out     recompute h, second GroupNorm, scores = hn W3 + b3, count
                    mask, float32 softmax over K, values relu(GN(gfo W4 + b4)),
                    weighted sum over K -> (B, M, c_out) float32

Between the sweeps the wrapper computes what is per centre or per batch row
in plain tensor code, as the JAX package leaves it to XLA: the query path
``relu(feat W0 + b0)``, its part of the first GroupNorm's statistics,
``qn W2q``, and the (B, C) GroupNorm vectors.

Rounding points are part of the function and both versions keep them: bf16
operands, float32 accumulation rounded to bf16, bf16 bias add; the first
GroupNorm on the k half as a float32 multiply-add rounded to bf16; the other
two in bf16 as ``(x - mu) * s + b``; scores masked with bf16(-1e9); softmax
and the weighted sum in float32 with float32 weights.  Inference only: no
gradient is defined.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import kernels

BF16 = torch.bfloat16
ATTENTION_MAX_K = 64  # a tile of 64 rows holds whole centres
_SMEM_BYTES = 232448  # shared memory one block may use on sm_90


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """Dense in bf16: bf16 operands, float32 accumulation rounded to bf16,
    bf16 bias add.  ``w`` is (in, out)."""
    y = torch.matmul(x, w)
    return y if b is None else y + b


def _group_mul_add(sum_c, ssq_c, scale, bias, cnt: float, num_groups: int):
    """GroupNorm statistics -> per-channel float32 (mul, add) vectors:
    y = x * mul + add == (x - mean) * rsqrt(var + 1e-5) * scale + bias (fast
    variance, eps 1e-5)."""
    B, normed_c = sum_c.shape
    gs = normed_c // num_groups
    mean = sum_c.reshape(B, num_groups, gs).sum(-1) / cnt
    var = (ssq_c.reshape(B, num_groups, gs).sum(-1) / cnt - mean * mean).clamp(min=0.0)
    rstd = torch.rsqrt(var + 1e-5)
    mul = rstd.repeat_interleave(gs, dim=-1) * scale[None]
    add = bias[None] - mean.repeat_interleave(gs, dim=-1) * mul
    return mul, add


def _pgn_mu_s_b(sum_c, ssq_c, scale, bias, cnt: float, num_groups: int, c: int):
    """PartialGroupNorm's float32 (mu, s, b) vectors, with identity lanes over
    the passthrough tail: y = (x - mu) * s + b."""
    B, normed_c = sum_c.shape
    gs = normed_c // num_groups
    mean = sum_c.reshape(B, num_groups, gs).sum(-1) / cnt
    var = (ssq_c.reshape(B, num_groups, gs).sum(-1) / cnt - mean * mean).clamp(min=0.0)
    inv = torch.rsqrt(var + 1e-5)
    mu = mean.repeat_interleave(gs, dim=-1)
    s = inv.repeat_interleave(gs, dim=-1) * scale[None]
    b = bias[None].expand(B, normed_c)
    if normed_c != c:
        pad = c - normed_c
        mu = torch.cat([mu, mu.new_zeros(B, pad)], 1)
        s = torch.cat([s, s.new_ones(B, pad)], 1)
        b = torch.cat([b, b.new_zeros(B, pad)], 1)
    return mu, s, b


def _identity_vectors(B: int, c: int, device):
    return (torch.zeros(B, c, device=device), torch.ones(B, c, device=device),
            torch.zeros(B, c, device=device))


class _Layer(NamedTuple):
    """One Dense of the sweeps: ``w`` (in, out) and ``b`` (out,) in bf16 for
    the plain version; ``wt`` (out, in) and ``bp`` zero-padded to multiples
    of 16 for the kernel (None until a GPU tensor asks for them)."""

    w: torch.Tensor
    b: torch.Tensor
    wt: Optional[torch.Tensor]
    bp: Optional[torch.Tensor]


def _layer(w: torch.Tensor, b: torch.Tensor) -> _Layer:
    wb, bb = w.to(BF16), b.to(BF16)
    if w.device.type != "cuda":
        return _Layer(wb, bb, None, None)
    cin, cout = wb.shape
    wt = wb.new_zeros(_round_up(cout, 16), _round_up(cin, 16))
    wt[:cout, :cin] = wb.t()
    bp = bb.new_zeros(_round_up(cout, 16))
    bp[:cout] = bb
    return _Layer(wb, bb, wt, bp)


class PreparedWeights(NamedTuple):
    """The pool's parameters as the sweeps read them (cast, split, transposed
    and padded once; a caller that keeps its parameters fixed keeps this)."""

    w0: torch.Tensor  # (Cq, c1) bf16
    b0: torch.Tensor
    w2q: torch.Tensor  # (c1, inter_c) bf16
    key: _Layer  # Dense_1
    hidden: _Layer  # the k rows of Dense_2, with its bias
    score: _Layer  # Dense_3
    value: _Layer  # Dense_4
    gn0: Tuple[torch.Tensor, torch.Tensor]
    gn1: Tuple[torch.Tensor, torch.Tensor]
    gn2: Tuple[torch.Tensor, torch.Tensor]


def prepare_attention_weights(w0, b0, w1, b1, gn0_scale, gn0_bias, w2, b2, gn1_scale,
                              gn1_bias, w3, b3, w4, b4, gn2_scale, gn2_bias, *,
                              c1: int) -> PreparedWeights:
    """Dense kernels are (in, out) float32, as the JAX package stores them."""
    with torch.no_grad():
        return PreparedWeights(
            w0.to(BF16), b0.to(BF16), w2[:c1].to(BF16).contiguous(),
            _layer(w1, b1), _layer(w2[c1:], b2), _layer(w3, b3), _layer(w4, b4),
            (gn0_scale.float(), gn0_bias.float()), (gn1_scale.float(), gn1_bias.float()),
            (gn2_scale.float(), gn2_bias.float()),
        )


# ---- the sweeps: plain versions ------------------------------------------
def _sums(x: torch.Tensor) -> torch.Tensor:
    """(B, R, C) bf16 -> (B, 2, C) float32 sums and sums of squares over R."""
    xf = x.to(torch.float32)
    return torch.stack([xf.sum(1), (xf * xf).sum(1)], dim=1)


def _kn_plain(g2, key: _Layer, mul_k, add_k):
    kd = torch.relu(_dense(g2, key.w, key.b))
    kn = kd.to(torch.float32) * mul_k[:, None, :]
    return (kn + add_k[:, None, :]).to(BF16)


def _h_plain(g2, qp, key, hidden, mul_k, add_k, K: int):
    kp = _dense(_kn_plain(g2, key, mul_k, add_k), hidden.w, hidden.b)
    return torch.relu(qp.repeat_interleave(K, dim=1) + kp)


def attention_stats_plain(g2, gfo2, key: _Layer, value: _Layer):
    kd = torch.relu(_dense(g2, key.w, key.b))
    vd = _dense(gfo2, value.w, value.b)
    return _sums(kd), _sums(vd)


def attention_hstats_plain(g2, qp, key, hidden, mul_k, add_k, K: int):
    return _sums(_h_plain(g2, qp, key, hidden, mul_k, add_k, K))


def attention_out_plain(g2, gfo2, qp, counts, key, hidden, score, value, mul_k, add_k,
                        gn1, gn2, K: int):
    B, R, _ = g2.shape
    M = R // K
    mu1, s1, bb1 = (t.to(BF16)[:, None, :] for t in gn1)
    mu2, s2, bb2 = (t.to(BF16)[:, None, :] for t in gn2)
    h = _h_plain(g2, qp, key, hidden, mul_k, add_k, K)
    hn = (h - mu1) * s1 + bb1
    scores = _dense(hn, score.w, score.b)
    c_out = scores.shape[-1]
    if counts is not None:
        slot = torch.arange(K, device=g2.device)
        keep = slot[None, None, :] < counts.clamp(min=1)[:, :, None]  # (B, M, K)
        scores = torch.where(keep.reshape(B, R, 1), scores,
                             torch.tensor(-1e9, dtype=BF16, device=g2.device))
    s3 = scores.to(torch.float32).reshape(B, M, K, c_out)
    e = torch.exp(s3 - s3.amax(dim=2, keepdim=True))
    weight = e / e.sum(dim=2, keepdim=True)
    vd = _dense(gfo2, value.w, value.b)
    vn = torch.relu((vd - mu2) * s2 + bb2)
    v3 = vn.to(torch.float32).reshape(B, M, K, c_out)
    return (v3 * weight).sum(dim=2)


# ---- the sweeps: kernels --------------------------------------------------
def _tiles(M: int, K: int) -> int:
    mt = 64 // K
    return (M + mt - 1) // mt


def _check_site(name: str, K: int, ld0: int, ld1: int, aux: int) -> None:
    """Raise on a site the kernel does not take: more slots than a tile has
    rows, or activation tiles beyond a block's shared memory."""
    if not 1 <= K <= ATTENTION_MAX_K:
        raise ValueError(f"{name}: the kernel needs 1 <= K <= {ATTENTION_MAX_K}, got {K}")
    smem = (64 * (ld0 + ld1 + 16) + 64 * 72) * 2 + aux
    if smem > _SMEM_BYTES:
        raise ValueError(
            f"{name}: a tile of this site needs {smem} bytes of shared memory, "
            f"a block has {_SMEM_BYTES}")


def _check_rows(name: str, g2: torch.Tensor, K: int) -> Tuple[int, int, int]:
    kernels.check(g2, f"{name} rows", BF16, (None, None, None))
    B, R, C = g2.shape
    if R % K:
        raise ValueError(f"{name}: {R} rows are not whole centres of {K} slots")
    return B, R // K, C


def _need(layer: _Layer, name: str) -> _Layer:
    if layer.wt is None:
        raise ValueError(f"{name}: the weights were prepared on the CPU, the rows lie on a GPU")
    return layer


def attention_stats(g2, gfo2, key: _Layer, value: _Layer, K: int):
    """Sweep 1.  g2 (B, M*K, Ck), gfo2 (B, M*K, Cv) bf16 -> kst (B, 2, c2),
    vst (B, 2, c_out) float32."""
    if kernels.use_plain(g2):
        return attention_stats_plain(g2, gfo2, key, value)
    B, M, Ck = _check_rows("attention_stats", g2, K)
    kernels.check(gfo2, "attention_stats values", BF16, (B, M * K, None))
    Cv = gfo2.shape[-1]
    c2, c_out = key.w.shape[1], value.w.shape[1]
    _need(key, "attention_stats"), _need(value, "attention_stats")
    _check_site("attention_stats", K, _round_up(Ck, 16), _round_up(Cv, 16), 2048)
    T = _tiles(M, K)
    kst = torch.empty((B, T, 2, c2), dtype=torch.float32, device=g2.device)
    vst = torch.empty((B, T, 2, c_out), dtype=torch.float32, device=g2.device)
    kernels.launch(
        "attention_stats", g2.data_ptr(), gfo2.data_ptr(), key.wt.data_ptr(),
        key.bp.data_ptr(), value.wt.data_ptr(), value.bp.data_ptr(), kst.data_ptr(),
        vst.data_ptr(), B, M, K, Ck, Cv, c2, c_out,
    )
    # the tiles' partial sums, added in a fixed order
    return kst.sum(1), vst.sum(1)


def attention_hstats(g2, qp, key: _Layer, hidden: _Layer, mul_k, add_k, K: int):
    """Sweep 2.  qp (B, M, inter_c) bf16, mul_k / add_k (B, c2) float32 ->
    hst (B, 2, inter_c) float32."""
    if kernels.use_plain(g2):
        return attention_hstats_plain(g2, qp, key, hidden, mul_k, add_k, K)
    B, M, Ck = _check_rows("attention_hstats", g2, K)
    c2, inter_c = hidden.w.shape
    kernels.check(qp, "attention_hstats qp", BF16, (B, M, inter_c))
    kernels.check(mul_k, "attention_hstats mul_k", torch.float32, (B, c2))
    kernels.check(add_k, "attention_hstats add_k", torch.float32, (B, c2))
    _need(key, "attention_hstats"), _need(hidden, "attention_hstats")
    _check_site("attention_hstats", K, _round_up(Ck, 16), _round_up(c2, 16), 2048)
    hst = torch.empty((B, _tiles(M, K), 2, inter_c), dtype=torch.float32, device=g2.device)
    kernels.launch(
        "attention_hstats", g2.data_ptr(), key.wt.data_ptr(), key.bp.data_ptr(),
        mul_k.data_ptr(), add_k.data_ptr(), hidden.wt.data_ptr(), hidden.bp.data_ptr(),
        qp.data_ptr(), hst.data_ptr(), B, M, K, Ck, c2, inter_c,
    )
    return hst.sum(1)


def attention_out(g2, gfo2, qp, counts, key, hidden, score, value, mul_k, add_k,
                  gn1, gn2, K: int):
    """Sweep 3.  gn1 / gn2: float32 (mu, s, b) of h (B, inter_c) and of v
    (B, c_out); counts (B, M) int32 or None -> (B, M, c_out) float32."""
    if kernels.use_plain(g2):
        return attention_out_plain(g2, gfo2, qp, counts, key, hidden, score, value,
                                   mul_k, add_k, gn1, gn2, K)
    B, M, Ck = _check_rows("attention_out", g2, K)
    kernels.check(gfo2, "attention_out values", BF16, (B, M * K, None))
    Cv = gfo2.shape[-1]
    c2, inter_c = hidden.w.shape
    c_out = score.w.shape[1]
    kernels.check(qp, "attention_out qp", BF16, (B, M, inter_c))
    kernels.check(mul_k, "attention_out mul_k", torch.float32, (B, c2))
    kernels.check(add_k, "attention_out add_k", torch.float32, (B, c2))
    if counts is not None:
        kernels.check(counts, "attention_out counts", torch.int32, (B, M))
    for layer in (key, hidden, score, value):
        _need(layer, "attention_out")
    _check_site("attention_out", K, _round_up(max(Ck, inter_c), 16),
                _round_up(max(c2, Cv), 16), 2 * 64 * 66 * 2)
    vec1 = [t.to(BF16).contiguous() for t in gn1]
    vec2 = [t.to(BF16).contiguous() for t in gn2]
    for t in vec1:
        kernels.check(t, "attention_out gn1", BF16, (B, inter_c))
    for t in vec2:
        kernels.check(t, "attention_out gn2", BF16, (B, c_out))
    out = torch.empty((B, M, c_out), dtype=torch.float32, device=g2.device)
    kernels.launch(
        "attention_out", g2.data_ptr(), gfo2.data_ptr(), key.wt.data_ptr(),
        key.bp.data_ptr(), mul_k.data_ptr(), add_k.data_ptr(), hidden.wt.data_ptr(),
        hidden.bp.data_ptr(), qp.data_ptr(), *(t.data_ptr() for t in vec1),
        score.wt.data_ptr(), score.bp.data_ptr(), value.wt.data_ptr(), value.bp.data_ptr(),
        *(t.data_ptr() for t in vec2),
        counts.data_ptr() if counts is not None else None, out.data_ptr(),
        B, M, K, Ck, Cv, c2, inter_c, c_out,
    )
    return out


# ---- the function ---------------------------------------------------------
def _pool(feat, grouped, gfo, counts, p: PreparedWeights, c1, c2, inter_c, c_out, K,
          sweeps) -> torch.Tensor:
    stats, hstats, out = sweeps
    B, M, _, Ck = grouped.shape
    Cv = gfo.shape[-1]
    g2 = grouped.to(BF16).reshape(B, M * K, Ck).contiguous()
    gfo2 = gfo.to(BF16).reshape(B, M * K, Cv).contiguous()
    ng0 = min(32, c1 + c2)
    normed0 = (c1 + c2) - (c1 + c2) % ng0
    ng1 = min(32, inter_c)
    normed1 = inter_c - inter_c % ng1
    ng2 = min(32, c_out)
    normed2 = c_out - c_out % ng2
    rows = float(M) * float(K)
    dev = grouped.device

    kst, vst = stats(g2, gfo2, p.key, p.value, K)

    # the per-centre q path and the GroupNorm vectors
    qd = torch.relu(_dense(feat.to(BF16), p.w0, p.b0))  # (B, M, c1)
    qf = qd.to(torch.float32)
    q_sum = qf.sum(1) * float(K)
    q_ssq = (qf * qf).sum(1) * float(K)
    sum_c = torch.cat([q_sum, kst[:, 0]], dim=-1)[:, :normed0]
    ssq_c = torch.cat([q_ssq, kst[:, 1]], dim=-1)[:, :normed0]
    mul0, add0 = _group_mul_add(sum_c, ssq_c, *p.gn0, rows * (normed0 // ng0), ng0)
    nq = min(c1, normed0)
    nk = normed0 - nq
    mul_q = torch.cat([mul0[:, :nq], mul0.new_ones(B, c1 - nq)], -1)
    add_q = torch.cat([add0[:, :nq], add0.new_zeros(B, c1 - nq)], -1)
    mul_k = torch.cat([mul0[:, nq:], mul0.new_ones(B, c2 - nk)], -1).contiguous()
    add_k = torch.cat([add0[:, nq:], add0.new_zeros(B, c2 - nk)], -1).contiguous()
    qn = (qf * mul_q[:, None, :] + add_q[:, None, :]).to(BF16)
    qp = torch.matmul(qn, p.w2q).contiguous()  # (B, M, inter_c), no bias

    if normed2:
        gn2 = _pgn_mu_s_b(vst[:, 0, :normed2], vst[:, 1, :normed2], *p.gn2,
                          rows * (normed2 // ng2), ng2, c_out)
    else:
        gn2 = _identity_vectors(B, c_out, dev)

    hst = hstats(g2, qp, p.key, p.hidden, mul_k, add_k, K)
    if normed1:
        gn1 = _pgn_mu_s_b(hst[:, 0, :normed1], hst[:, 1, :normed1], *p.gn1,
                          rows * (normed1 // ng1), ng1, inter_c)
    else:
        gn1 = _identity_vectors(B, inter_c, dev)

    cnt = None if counts is None else counts.to(torch.int32).contiguous()
    return out(g2, gfo2, qp, cnt, p.key, p.hidden, p.score, p.value, mul_k, add_k,
               gn1, gn2, K)


_KERNEL_SWEEPS = (attention_stats, attention_hstats, attention_out)
_PLAIN_SWEEPS = (
    lambda g2, gfo2, key, value, K: attention_stats_plain(g2, gfo2, key, value),
    attention_hstats_plain, attention_out_plain,
)


def fused_attention_pool(
    feat: torch.Tensor,  # (B, M, Cq) feature at the centre points
    grouped: torch.Tensor,  # (B, M, K, Ck) raw grouped features
    gfo: torch.Tensor,  # (B, M, K, Cv) MLP output (values)
    counts: Optional[torch.Tensor],  # (B, M) int32, or None for 'all'
    w0=None, b0=None, w1=None, b1=None,  # Dense_0 (q), Dense_1 (k)
    gn0_scale=None, gn0_bias=None,  # first GroupNorm (normed0,)
    w2=None, b2=None,  # Dense_2 over [q, k] (c1 + c2, inter_c)
    gn1_scale=None, gn1_bias=None,  # second GroupNorm (normed1,)
    w3=None, b3=None,  # Dense_3 (scores)
    w4=None, b4=None,  # Dense_4 (values)
    gn2_scale=None, gn2_bias=None,  # third GroupNorm (normed2,)
    *,
    c1: int, c2: int, inter_c: int, c_out: int, K: int,
    prepared: Optional[PreparedWeights] = None,
) -> torch.Tensor:
    """The AttentionPool forward with ``attention_bn``,
    ``transform_grouped_feat_out`` and ``last_activation`` all true, under
    bf16 compute: (B, M, c_out) float32.  Dense kernels are (in, out).
    ``prepared`` (from ``prepare_attention_weights``) takes the place of the
    sixteen parameter tensors.  On GPU tensors the three sweeps are the CUDA
    kernels; on CPU tensors, or under ``kernels.plain_ops()``, their plain
    versions."""
    if prepared is None:
        prepared = prepare_attention_weights(
            w0, b0, w1, b1, gn0_scale, gn0_bias, w2, b2, gn1_scale, gn1_bias, w3, b3,
            w4, b4, gn2_scale, gn2_bias, c1=c1)
    return _pool(feat, grouped, gfo, counts, prepared, c1, c2, inter_c, c_out, K,
                 _KERNEL_SWEEPS)


def fused_attention_pool_plain(feat, grouped, gfo, counts, *weights, c1: int, c2: int,
                               inter_c: int, c_out: int, K: int,
                               prepared: Optional[PreparedWeights] = None) -> torch.Tensor:
    """Plain version of ``fused_attention_pool``: the same sweeps and glue in
    PyTorch tensor code on any device, with the same rounding points."""
    if prepared is None:
        prepared = prepare_attention_weights(*weights, c1=c1)
    return _pool(feat, grouped, gfo, counts, prepared, c1, c2, inter_c, c_out, K,
                 _PLAIN_SWEEPS)
