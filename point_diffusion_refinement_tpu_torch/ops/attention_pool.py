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

Between the sweeps, on GPU tensors, two finishing kernels turn the sweeps'
partial sums into the GroupNorm vectors (``attention_finish_stats``: the
first GroupNorm over [q, k], with the query rows ``qn``, and the values';
``attention_finish_h``: h's), whose plain counterparts are the JAX
package's ``_group_mul_add`` / ``_pgn_mu_s_b`` glue.  The query path's two
products (``feat W0`` and ``qn W2q``) stay ``torch.matmul``, as the JAX
package leaves them to XLA.

Rounding points are part of the function and both versions keep them: bf16
operands, float32 accumulation rounded to bf16, bf16 bias add; the first
GroupNorm on the k half as a float32 multiply-add rounded to bf16; the other
two in bf16 as ``(x - mu) * s + b``; scores masked with bf16(-1e9); softmax
and the weighted sum in float32 with float32 weights.  Inference only: no
gradient is defined.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import kernels

BF16 = torch.bfloat16


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


# ---- the glue between the sweeps: plain versions ---------------------------
def _norm_widths(c: int) -> Tuple[int, int]:
    """(groups, normed channels) of a GroupNorm over c channels, as the JAX
    package sizes them: min(32, c) groups over the largest multiple."""
    ng = min(32, c)
    return ng, c - c % ng


def _finish_stats_plain(mm, kst, vst, p: PreparedWeights, c1: int, c2: int, c_out: int,
                        K: int):
    """After sweep 1: qd = relu(mm + b0) (mm = feat W0 in bf16), the first
    GroupNorm's (mul, add) over [q, k] -> qn (B, M, c1) bf16 and mul_k /
    add_k (B, c2) float32; the values' GroupNorm (mu, s, b) (B, c_out)
    float32."""
    B, M, _ = mm.shape
    rows = float(M) * float(K)
    ng0, normed0 = _norm_widths(c1 + c2)
    ng2, normed2 = _norm_widths(c_out)
    qf = torch.relu(mm + p.b0).to(torch.float32)
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
    gn2 = _pgn_mu_s_b(vst[:, 0, :normed2], vst[:, 1, :normed2], *p.gn2,
                      rows * (normed2 // ng2), ng2, c_out)
    return qn, mul_k, add_k, gn2


def _finish_h_plain(hst, p: PreparedWeights, inter_c: int, M: int, K: int):
    """After sweep 2: h's GroupNorm (mu, s, b) (B, inter_c) float32."""
    ng1, normed1 = _norm_widths(inter_c)
    return _pgn_mu_s_b(hst[:, 0, :normed1], hst[:, 1, :normed1], *p.gn1,
                       float(M) * float(K) * (normed1 // ng1), ng1, inter_c)


def _bf16_vectors(vectors):
    return tuple(t.to(BF16).contiguous() for t in vectors)


def attention_finish_stats_plain(mm, part, p: PreparedWeights, c1: int, c2: int,
                                 c_out: int, K: int):
    """Plain version of ``attention_finish_stats``: the partial rows added up,
    then ``_group_mul_add`` / ``_pgn_mu_s_b`` as the plain pool runs them."""
    kst, vst = part[:, :, :, :c2].sum(1), part[:, :, :, c2:].sum(1)
    qn, mul_k, add_k, gn2 = _finish_stats_plain(mm, kst, vst, p, c1, c2, c_out, K)
    return qn, mul_k, add_k, _bf16_vectors(gn2)


def attention_finish_h_plain(part, p: PreparedWeights, inter_c: int, M: int, K: int):
    """Plain version of ``attention_finish_h``."""
    return _bf16_vectors(_finish_h_plain(part.sum(1), p, inter_c, M, K))


# ---- the sweeps and the glue: kernels ---------------------------------------
_CHUNK = 64  # output columns of a column chunk
_SWEEPS = ("attention_stats", "attention_hstats", "attention_out")
_ROW_BLOCKS: Dict[Tuple[int, ...], int] = {}


def _row_blocks(sweep: int, B: int, M: int, K: int, Ck: int, Cv: int, c2: int, inter_c: int,
                c_out: int) -> int:
    """Row blocks of sweep 1, 2 or 3 a batch row (row tiles, or units of
    whole centres for the out sweep): the rows of its partial sums, from the
    kernel's own plan, asked once per size."""
    key = (sweep, B, M, K, Ck, Cv, c2, inter_c, c_out)
    if key not in _ROW_BLOCKS:
        _ROW_BLOCKS[key] = kernels.query("attention_row_blocks", *key)
    if _ROW_BLOCKS[key] < 1:
        raise ValueError(f"{_SWEEPS[sweep - 1]}: a 16-row tile of widths Ck={Ck}, Cv={Cv}, "
                         f"c2={c2}, inter_c={inter_c}, c_out={c_out} does not fit a block's "
                         "shared memory")
    return _ROW_BLOCKS[key]


def sweep_row_blocks(B: int, M: int, K: int, Ck: int, Cv: int, c2: int, inter_c: int,
                     c_out: int) -> Dict[str, int]:
    """{sweep: row blocks a batch row} on the card (the grid's first axis;
    column groups and batch rows multiply it)."""
    return {sweep: _row_blocks(s, B, M, K, Ck, Cv, c2, inter_c, c_out)
            for s, sweep in enumerate(_SWEEPS, start=1)}


def _check_rows(name: str, g2: torch.Tensor, K: int) -> Tuple[int, int, int]:
    kernels.check(g2, f"{name} rows", BF16, (None, None, None))
    B, R, C = g2.shape
    if K < 1 or R % K:
        raise ValueError(f"{name}: {R} rows are not whole centres of {K} slots")
    return B, R // K, C


def _need(layer: _Layer, name: str) -> _Layer:
    if layer.wt is None:
        raise ValueError(f"{name}: the weights were prepared on the CPU, the rows lie on a GPU")
    return layer


def _stats_launch(g2, gfo2, key: _Layer, value: _Layer, K: int) -> torch.Tensor:
    B, M, Ck = _check_rows("attention_stats", g2, K)
    kernels.check(gfo2, "attention_stats values", BF16, (B, M * K, None))
    Cv = gfo2.shape[-1]
    c2, c_out = key.w.shape[1], value.w.shape[1]
    _need(key, "attention_stats"), _need(value, "attention_stats")
    P = _row_blocks(1, B, M, K, Ck, Cv, c2, 16, c_out)
    part = torch.empty((B, P, 2, c2 + c_out), dtype=torch.float32, device=g2.device)
    kernels.launch(
        "attention_stats", g2.data_ptr(), gfo2.data_ptr(), key.wt.data_ptr(),
        key.bp.data_ptr(), value.wt.data_ptr(), value.bp.data_ptr(), part.data_ptr(),
        B, M, K, Ck, Cv, c2, c_out, P,
    )
    return part


def _hstats_launch(g2, qp, key: _Layer, hidden: _Layer, mul_k, add_k, K: int) -> torch.Tensor:
    B, M, Ck = _check_rows("attention_hstats", g2, K)
    c2, inter_c = hidden.w.shape
    kernels.check(qp, "attention_hstats qp", BF16, (B, M, inter_c))
    kernels.check(mul_k, "attention_hstats mul_k", torch.float32, (B, c2))
    kernels.check(add_k, "attention_hstats add_k", torch.float32, (B, c2))
    _need(key, "attention_hstats"), _need(hidden, "attention_hstats")
    P = _row_blocks(2, B, M, K, Ck, 16, c2, inter_c, 16)
    part = torch.empty((B, P, 2, inter_c), dtype=torch.float32, device=g2.device)
    kernels.launch(
        "attention_hstats", g2.data_ptr(), key.wt.data_ptr(), key.bp.data_ptr(),
        mul_k.data_ptr(), add_k.data_ptr(), hidden.wt.data_ptr(), hidden.bp.data_ptr(),
        qp.data_ptr(), part.data_ptr(), B, M, K, Ck, c2, inter_c, P,
    )
    return part


def _out_launch(g2, gfo2, qp, counts, key, hidden, score, value, mul_k, add_k, gn1, gn2,
                K: int) -> torch.Tensor:
    """gn1 / gn2: the bf16 (mu, s, b) of h (B, inter_c) and of v (B, c_out)."""
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
    for t in gn1:
        kernels.check(t, "attention_out gn1", BF16, (B, inter_c))
    for t in gn2:
        kernels.check(t, "attention_out gn2", BF16, (B, c_out))
    P = _row_blocks(3, B, M, K, Ck, Cv, c2, inter_c, c_out)
    out = torch.empty((B, M, c_out), dtype=torch.float32, device=g2.device)
    kernels.launch(
        "attention_out", g2.data_ptr(), gfo2.data_ptr(), key.wt.data_ptr(),
        key.bp.data_ptr(), mul_k.data_ptr(), add_k.data_ptr(), hidden.wt.data_ptr(),
        hidden.bp.data_ptr(), qp.data_ptr(), *(t.data_ptr() for t in gn1),
        score.wt.data_ptr(), score.bp.data_ptr(), value.wt.data_ptr(), value.bp.data_ptr(),
        *(t.data_ptr() for t in gn2),
        counts.data_ptr() if counts is not None else None, out.data_ptr(),
        B, M, K, Ck, Cv, c2, inter_c, c_out, P,
    )
    return out


def attention_stats(g2, gfo2, key: _Layer, value: _Layer, K: int):
    """Sweep 1.  g2 (B, M*K, Ck), gfo2 (B, M*K, Cv) bf16 -> kst (B, 2, c2),
    vst (B, 2, c_out) float32 (the kernel's partial rows added up here)."""
    if kernels.use_plain(g2):
        return attention_stats_plain(g2, gfo2, key, value)
    part = _stats_launch(g2, gfo2, key, value, K)
    c2 = key.w.shape[1]
    return part[:, :, :, :c2].sum(1), part[:, :, :, c2:].sum(1)


def attention_hstats(g2, qp, key: _Layer, hidden: _Layer, mul_k, add_k, K: int):
    """Sweep 2.  qp (B, M, inter_c) bf16, mul_k / add_k (B, c2) float32 ->
    hst (B, 2, inter_c) float32."""
    if kernels.use_plain(g2):
        return attention_hstats_plain(g2, qp, key, hidden, mul_k, add_k, K)
    return _hstats_launch(g2, qp, key, hidden, mul_k, add_k, K).sum(1)


def attention_out(g2, gfo2, qp, counts, key, hidden, score, value, mul_k, add_k,
                  gn1, gn2, K: int):
    """Sweep 3.  gn1 / gn2: float32 (mu, s, b) of h (B, inter_c) and of v
    (B, c_out); counts (B, M) int32 or None -> (B, M, c_out) float32."""
    if kernels.use_plain(g2):
        return attention_out_plain(g2, gfo2, qp, counts, key, hidden, score, value,
                                   mul_k, add_k, gn1, gn2, K)
    return _out_launch(g2, gfo2, qp, counts, key, hidden, score, value, mul_k, add_k,
                       _bf16_vectors(gn1), _bf16_vectors(gn2), K)


def attention_finish_stats(mm, part, p: PreparedWeights, c1: int, c2: int, c_out: int,
                           K: int):
    """After sweep 1, on the card: mm (B, M, c1) bf16 = feat W0 (before its
    bias), part (B, P, 2, c2 + c_out) the sweep's partial rows -> qn
    (B, M, c1) bf16, mul_k / add_k (B, c2) float32 and the values'
    GroupNorm (mu, s, b) (B, c_out) bf16."""
    if kernels.use_plain(part):
        return attention_finish_stats_plain(mm, part, p, c1, c2, c_out, K)
    B, M, _ = mm.shape
    kernels.check(mm, "attention_finish_stats mm", BF16, (B, None, c1))
    kernels.check(part, "attention_finish_stats part", torch.float32, (B, None, 2, c2 + c_out))
    dev = mm.device
    qn = torch.empty((B, M, c1), dtype=BF16, device=dev)
    mul_k = torch.empty((B, c2), dtype=torch.float32, device=dev)
    add_k = torch.empty((B, c2), dtype=torch.float32, device=dev)
    gn2 = tuple(torch.empty((B, c_out), dtype=BF16, device=dev) for _ in range(3))
    kernels.launch(
        "attention_finish_stats", mm.data_ptr(), p.b0.data_ptr(), part.data_ptr(),
        p.gn0[0].data_ptr(), p.gn0[1].data_ptr(), p.gn2[0].data_ptr(), p.gn2[1].data_ptr(),
        qn.data_ptr(), mul_k.data_ptr(), add_k.data_ptr(), *(t.data_ptr() for t in gn2),
        B, M, K, part.shape[1], c1, c2, c_out,
    )
    return qn, mul_k, add_k, gn2


def attention_finish_h(part, p: PreparedWeights, inter_c: int, M: int, K: int):
    """After sweep 2, on the card: part (B, P, 2, inter_c) -> h's GroupNorm
    (mu, s, b) (B, inter_c) bf16."""
    if kernels.use_plain(part):
        return attention_finish_h_plain(part, p, inter_c, M, K)
    B = part.shape[0]
    kernels.check(part, "attention_finish_h part", torch.float32, (B, None, 2, inter_c))
    gn1 = tuple(torch.empty((B, inter_c), dtype=BF16, device=part.device) for _ in range(3))
    kernels.launch(
        "attention_finish_h", part.data_ptr(), p.gn1[0].data_ptr(), p.gn1[1].data_ptr(),
        *(t.data_ptr() for t in gn1), B, M, K, part.shape[1], inter_c,
    )
    return gn1


# ---- the function ---------------------------------------------------------
def _rows(grouped, gfo):
    B, M, K, Ck = grouped.shape
    g2 = grouped.to(BF16).reshape(B, M * K, Ck).contiguous()
    gfo2 = gfo.to(BF16).reshape(B, M * K, gfo.shape[-1]).contiguous()
    return g2, gfo2


def _pool_plain(feat, grouped, gfo, counts, p: PreparedWeights, c1, c2, inter_c, c_out,
                K) -> torch.Tensor:
    """The plain sweeps and glue, the rounding points of the kernels."""
    M = grouped.shape[1]
    g2, gfo2 = _rows(grouped, gfo)
    kst, vst = attention_stats_plain(g2, gfo2, p.key, p.value)
    mm = torch.matmul(feat.to(BF16), p.w0)  # (B, M, c1), bias in the glue
    qn, mul_k, add_k, gn2 = _finish_stats_plain(mm, kst, vst, p, c1, c2, c_out, K)
    qp = torch.matmul(qn, p.w2q)  # (B, M, inter_c), no bias
    hst = attention_hstats_plain(g2, qp, p.key, p.hidden, mul_k, add_k, K)
    gn1 = _finish_h_plain(hst, p, inter_c, M, K)
    cnt = None if counts is None else counts.to(torch.int32)
    return attention_out_plain(g2, gfo2, qp, cnt, p.key, p.hidden, p.score, p.value,
                               mul_k, add_k, gn1, gn2, K)


def _pool_kernels(feat, grouped, gfo, counts, p: PreparedWeights, c1, c2, inter_c, c_out,
                  K) -> torch.Tensor:
    """Three sweeps and two finishing kernels; the q path's two products in
    ``torch.matmul`` (the JAX package leaves them to XLA): seven launches
    when the inputs are bf16 and the counts int32 or absent."""
    M = grouped.shape[1]
    g2, gfo2 = _rows(grouped, gfo)
    part1 = _stats_launch(g2, gfo2, p.key, p.value, K)
    mm = torch.matmul(feat.to(BF16), p.w0)
    qn, mul_k, add_k, gn2 = attention_finish_stats(mm, part1, p, c1, c2, c_out, K)
    qp = torch.matmul(qn, p.w2q)
    part2 = _hstats_launch(g2, qp, p.key, p.hidden, mul_k, add_k, K)
    gn1 = attention_finish_h(part2, p, inter_c, M, K)
    cnt = None if counts is None else counts.to(torch.int32).contiguous()
    return _out_launch(g2, gfo2, qp, cnt, p.key, p.hidden, p.score, p.value, mul_k, add_k,
                       gn1, gn2, K)


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
    sixteen parameter tensors.  On GPU tensors the three sweeps and the two
    finishing kernels run on the card (any K, any width whose 16-row tiles
    fit a block's shared memory, a few thousand channels; wider raises); on
    CPU tensors, or under
    ``kernels.plain_ops()``, their plain versions."""
    if prepared is None:
        prepared = prepare_attention_weights(
            w0, b0, w1, b1, gn0_scale, gn0_bias, w2, b2, gn1_scale, gn1_bias, w3, b3,
            w4, b4, gn2_scale, gn2_bias, c1=c1)
    pool = _pool_plain if kernels.use_plain(grouped) else _pool_kernels
    return pool(feat, grouped, gfo, counts, prepared, c1, c2, inter_c, c_out, K)


def fused_attention_pool_plain(feat, grouped, gfo, counts, *weights, c1: int, c2: int,
                               inter_c: int, c_out: int, K: int,
                               prepared: Optional[PreparedWeights] = None) -> torch.Tensor:
    """Plain version of ``fused_attention_pool``: the same sweeps and glue in
    PyTorch tensor code on any device, with the same rounding points."""
    if prepared is None:
        prepared = prepare_attention_weights(*weights, c1=c1)
    return _pool_plain(feat, grouped, gfo, counts, prepared, c1, c2, inter_c, c_out, K)
