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

On GPU tensors the first two sweeps also finish the GroupNorm vectors the
next kernel reads (the JAX package's ``_group_mul_add`` / ``_pgn_mu_s_b``
glue between its sweeps): both run in thread-block clusters of row tiles
that add their blocks' column sums into one row a cluster; sweep 1 sums
q = relu(feat W0 + b0) over the centres beside k and v, and the last
cluster of each batch row adds the rows up and writes the first
GroupNorm's (mul, add) over [q, k] and the values' (mu, s, b); sweep 2's
writes h's.  One elementwise pass, ``attention_qn``, writes the
normalised query rows ``qn`` between them.  The query path's two products
(``feat W0``, now before sweep 1, and ``qn W2q``) stay ``torch.matmul``,
as the JAX package leaves them to XLA.

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

from ..utils.flops import record_pallas_macs
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


def attention_qsums_plain(mm, b0):
    """Float32 per-channel sums and sums of squares of qd = relu(mm + b0)
    (mm = feat W0 in bf16, (B, M, c1)) over the centres -> (B, 2, c1): what
    sweep 1's blocks add up beside k and v."""
    return _sums(torch.relu(mm + b0))


def _stats_vectors_plain(kst, vst, qst, p: PreparedWeights, c1: int, c2: int, c_out: int,
                         M: int, K: int):
    """Sweep 1's finish from the sums of k, v and q: the first GroupNorm's
    (mul, add) over [q, k] (a q channel's sums times K: each q row stands for
    K rows) -> mul_q / add_q (B, c1) and mul_k / add_k (B, c2) float32,
    identity past the normed width; the values' GroupNorm (mu, s, b)
    (B, c_out) float32."""
    B = kst.shape[0]
    rows = float(M) * float(K)
    ng0, normed0 = _norm_widths(c1 + c2)
    ng2, normed2 = _norm_widths(c_out)
    sum_c = torch.cat([qst[:, 0] * float(K), kst[:, 0]], dim=-1)[:, :normed0]
    ssq_c = torch.cat([qst[:, 1] * float(K), kst[:, 1]], dim=-1)[:, :normed0]
    mul0, add0 = _group_mul_add(sum_c, ssq_c, *p.gn0, rows * (normed0 // ng0), ng0)
    nq = min(c1, normed0)
    nk = normed0 - nq
    mul_q = torch.cat([mul0[:, :nq], mul0.new_ones(B, c1 - nq)], -1)
    add_q = torch.cat([add0[:, :nq], add0.new_zeros(B, c1 - nq)], -1)
    mul_k = torch.cat([mul0[:, nq:], mul0.new_ones(B, c2 - nk)], -1).contiguous()
    add_k = torch.cat([add0[:, nq:], add0.new_zeros(B, c2 - nk)], -1).contiguous()
    gn2 = _pgn_mu_s_b(vst[:, 0, :normed2], vst[:, 1, :normed2], *p.gn2,
                      rows * (normed2 // ng2), ng2, c_out)
    return mul_q, add_q, mul_k, add_k, gn2


def attention_qn_plain(mm, b0, mul_q, add_q):
    """Plain version of ``attention_qn``: qn = bf16(qd * mul_q + add_q) in
    float32, qd = relu(mm + b0) in bf16 -> (B, M, c1) bf16."""
    qf = torch.relu(mm + b0).to(torch.float32)
    return (qf * mul_q[:, None, :] + add_q[:, None, :]).to(BF16)


def _finish_stats_plain(mm, kst, vst, p: PreparedWeights, c1: int, c2: int, c_out: int,
                        K: int):
    """After sweep 1: qd = relu(mm + b0) (mm = feat W0 in bf16), the first
    GroupNorm's (mul, add) over [q, k] -> qn (B, M, c1) bf16 and mul_k /
    add_k (B, c2) float32; the values' GroupNorm (mu, s, b) (B, c_out)
    float32."""
    mul_q, add_q, mul_k, add_k, gn2 = _stats_vectors_plain(
        kst, vst, attention_qsums_plain(mm, p.b0), p, c1, c2, c_out, mm.shape[1], K)
    return attention_qn_plain(mm, p.b0, mul_q, add_q), mul_k, add_k, gn2


def _finish_h_plain(hst, p: PreparedWeights, inter_c: int, M: int, K: int):
    """After sweep 2: h's GroupNorm (mu, s, b) (B, inter_c) float32."""
    ng1, normed1 = _norm_widths(inter_c)
    return _pgn_mu_s_b(hst[:, 0, :normed1], hst[:, 1, :normed1], *p.gn1,
                       float(M) * float(K) * (normed1 // ng1), ng1, inter_c)


def _bf16_vectors(vectors):
    return tuple(t.to(BF16).contiguous() for t in vectors)


def attention_finish_stats_plain(mm, part, p: PreparedWeights, c1: int, c2: int,
                                 c_out: int, K: int):
    """The finishing after sweep 1 as one function (the first design's
    kernel F0, now sweep 1's finish and ``attention_qn``): partial rows
    (B, P, 2, c2 + c_out) added up, then ``_group_mul_add`` / ``_pgn_mu_s_b``
    as the plain pool runs them -> qn, mul_k, add_k, gn2 in bf16."""
    kst, vst = part[:, :, :, :c2].sum(1), part[:, :, :, c2:].sum(1)
    qn, mul_k, add_k, gn2 = _finish_stats_plain(mm, kst, vst, p, c1, c2, c_out, K)
    return qn, mul_k, add_k, _bf16_vectors(gn2)


def attention_finish_h_plain(part, p: PreparedWeights, inter_c: int, M: int, K: int):
    """The finishing after sweep 2 (the first design's kernel F1, now sweep
    2's finish): partial rows (B, P, 2, inter_c) -> h's GroupNorm (mu, s, b)
    (B, inter_c) bf16."""
    return _bf16_vectors(_finish_h_plain(part.sum(1), p, inter_c, M, K))


def attention_stats_vectors_plain(mm, g2, gfo2, p: PreparedWeights, c1: int, K: int):
    """Plain version of ``attention_stats`` (sweep 1 and its finish)."""
    kst, vst = attention_stats_plain(g2, gfo2, p.key, p.value)
    c2, c_out = p.key.w.shape[1], p.value.w.shape[1]
    *vectors, gn2 = _stats_vectors_plain(kst, vst, attention_qsums_plain(mm, p.b0), p, c1, c2,
                                         c_out, mm.shape[1], K)
    return (*vectors, _bf16_vectors(gn2))


def attention_hstats_vectors_plain(g2, qp, p: PreparedWeights, mul_k, add_k, K: int):
    """Plain version of ``attention_hstats`` (sweep 2 and its finish)."""
    hst = attention_hstats_plain(g2, qp, p.key, p.hidden, mul_k, add_k, K)
    return attention_finish_h_plain(hst[:, None], p, p.hidden.w.shape[1], g2.shape[1] // K, K)


# ---- the sweeps and the glue: kernels ---------------------------------------
_CHUNK = 64  # output columns of a column chunk
_SWEEPS = ("attention_stats", "attention_hstats", "attention_out")
_ROW_BLOCKS: Dict[Tuple[int, ...], int] = {}
_CLUSTERS: Dict[Tuple[int, ...], int] = {}
# the int32 tickets of sweeps 1 and 2: (device index, batch rows) ->
# (_TICKET_STREAMS, B, 2), and (device index, stream) -> its slot
_TICKET_STREAMS = 16
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}
_TICKET_SLOTS: Dict[Tuple[int, int], int] = {}


def _row_blocks(sweep: int, B: int, M: int, K: int, Ck: int, Cv: int, c2: int, inter_c: int,
                c_out: int) -> int:
    """Row blocks of sweep 1, 2 or 3 a batch row (row tiles, or units of
    whole centres for the out sweep), from the kernel's own plan, asked
    once per size."""
    key = (sweep, B, M, K, Ck, Cv, c2, inter_c, c_out)
    if key not in _ROW_BLOCKS:
        _ROW_BLOCKS[key] = kernels.query("attention_row_blocks", *key)
    if _ROW_BLOCKS[key] < 1:
        raise ValueError(f"{_SWEEPS[sweep - 1]}: a 16-row tile of widths Ck={Ck}, Cv={Cv}, "
                         f"c2={c2}, inter_c={inter_c}, c_out={c_out} does not fit a block's "
                         "shared memory")
    return _ROW_BLOCKS[key]


def _cluster_size(sweep: int, B: int, M: int, K: int, Ck: int, Cv: int, c2: int, inter_c: int,
                  c_out: int) -> int:
    """Row tiles a thread-block cluster of sweep 1 or 2 holds on the card
    (the kernel's rule, from the device's occupancy), asked once per size."""
    key = (sweep, B, M, K, Ck, Cv, c2, inter_c, c_out)
    if key not in _CLUSTERS:
        _row_blocks(*key)
        cs = kernels.query("attention_cluster_size", *key)
        if cs < 1:
            raise RuntimeError(f"{_SWEEPS[sweep - 1]}: the cluster occupancy query failed")
        _CLUSTERS[key] = cs
    return _CLUSTERS[key]


def sweep_row_blocks(B: int, M: int, K: int, Ck: int, Cv: int, c2: int, inter_c: int,
                     c_out: int) -> Dict[str, int]:
    """{sweep: row blocks a batch row} on the card (the grid's first axis;
    column groups and batch rows multiply it)."""
    return {sweep: _row_blocks(s, B, M, K, Ck, Cv, c2, inter_c, c_out)
            for s, sweep in enumerate(_SWEEPS, start=1)}


def sweep_partial_rows(B: int, M: int, K: int, Ck: int, Cv: int, c2: int, inter_c: int,
                       c_out: int) -> Dict[str, int]:
    """{sweep: rows of partial sums a batch row} of sweeps 1 and 2 on the
    card: their row tiles over the cluster size."""
    key = (B, M, K, Ck, Cv, c2, inter_c, c_out)
    return {sweep: _row_blocks(s, *key) // _cluster_size(s, *key)
            for s, sweep in enumerate(_SWEEPS[:2], start=1)}


def _tickets(device: torch.device, B: int) -> torch.Tensor:
    """The (B, 2) int32 tickets by which sweeps 1 and 2 find each batch
    row's last cluster, for the current stream: one slot of a buffer
    allocated with ``torch.zeros`` once per device and batch size, left at
    0 by every launch, so no memset runs a call and a captured graph
    replays.  Launches on one stream run one after another; each stream
    that runs the pool gets a slot of its own (at most _TICKET_STREAMS a
    device), so launches on two streams may overlap.  Raises inside a
    graph capture if the pool never ran at this batch size on this device
    (the zeroing would be captured, not run): warm up first, as
    ``utils/graphs.py::CapturedFunction`` does."""
    stream = torch.cuda.current_stream(device).cuda_stream
    slot = _TICKET_SLOTS.get((device.index, stream))
    if slot is None:
        slot = sum(1 for d, _ in _TICKET_SLOTS if d == device.index)
        if slot >= _TICKET_STREAMS:
            raise RuntimeError(f"fused attention pool: more than {_TICKET_STREAMS} streams "
                               f"ran it on device {device.index}")
        _TICKET_SLOTS[(device.index, stream)] = slot
    tickets = _TICKETS.get((device.index, B))
    if tickets is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"fused attention pool: first call at batch size {B} inside a "
                               "graph capture; call it once before capturing it")
        tickets = _TICKETS[(device.index, B)] = torch.zeros(
            (_TICKET_STREAMS, B, 2), dtype=torch.int32, device=device)
    return tickets[slot]


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


def _partial_sums(B: int, P: int, C: int, device) -> torch.Tensor:
    """Scratch of sweep 1 or 2: P rows of partial sums a batch row (one a
    cluster) and their column totals, each row C sums and C squares padded
    to 16 bytes."""
    return torch.empty((B, P + 1, (2 * C + 3) // 4 * 4), dtype=torch.float32, device=device)


def _sums_view(part: torch.Tensor, C: int) -> torch.Tensor:
    """The partial sums as (B, P + 1, 2, C)."""
    return part[..., :2 * C].unflatten(-1, (2, C))


def _stats_launch(mm, g2, gfo2, p: PreparedWeights, c1: int, K: int):
    """Sweep 1 and its finish on the card -> mul_q, add_q, mul_k, add_k,
    gn2 and the partial sums (B, P + 1, 2, c2 + c_out + c1), whose last row
    holds the column totals of k, v and q."""
    B, M, Ck = _check_rows("attention_stats", g2, K)
    kernels.check(gfo2, "attention_stats values", BF16, (B, M * K, None))
    kernels.check(mm, "attention_stats mm", BF16, (B, M, c1))
    Cv = gfo2.shape[-1]
    c2, c_out = p.key.w.shape[1], p.value.w.shape[1]
    _need(p.key, "attention_stats"), _need(p.value, "attention_stats")
    key = (B, M, K, Ck, Cv, c2, 16, c_out)
    P = _row_blocks(1, *key) // _cluster_size(1, *key)
    dev, f32 = g2.device, torch.float32
    part = _partial_sums(B, P, c2 + c_out + c1, dev)
    mul_q, add_q = (torch.empty((B, c1), dtype=f32, device=dev) for _ in range(2))
    mul_k, add_k = (torch.empty((B, c2), dtype=f32, device=dev) for _ in range(2))
    gn2 = tuple(torch.empty((B, c_out), dtype=BF16, device=dev) for _ in range(3))
    kernels.launch(
        "attention_stats", g2.data_ptr(), gfo2.data_ptr(), p.key.wt.data_ptr(),
        p.key.bp.data_ptr(), p.value.wt.data_ptr(), p.value.bp.data_ptr(), mm.data_ptr(),
        p.b0.data_ptr(), *(t.data_ptr() for t in (*p.gn0, *p.gn2)), part.data_ptr(),
        *(t.data_ptr() for t in (mul_q, add_q, mul_k, add_k, *gn2)),
        _tickets(dev, B).data_ptr(), B, M, K, Ck, Cv, c2, c_out, c1, P,
    )
    return mul_q, add_q, mul_k, add_k, gn2, _sums_view(part, c2 + c_out + c1)


def _hstats_launch(g2, qp, p: PreparedWeights, mul_k, add_k, K: int):
    """Sweep 2 and its finish on the card -> gn1 and the partial sums
    (B, P + 1, 2, inter_c), whose last row holds h's column totals."""
    B, M, Ck = _check_rows("attention_hstats", g2, K)
    c2, inter_c = p.hidden.w.shape
    kernels.check(qp, "attention_hstats qp", BF16, (B, M, inter_c))
    kernels.check(mul_k, "attention_hstats mul_k", torch.float32, (B, c2))
    kernels.check(add_k, "attention_hstats add_k", torch.float32, (B, c2))
    _need(p.key, "attention_hstats"), _need(p.hidden, "attention_hstats")
    key = (B, M, K, Ck, 16, c2, inter_c, 16)
    P = _row_blocks(2, *key) // _cluster_size(2, *key)
    dev = g2.device
    part = _partial_sums(B, P, inter_c, dev)
    gn1 = tuple(torch.empty((B, inter_c), dtype=BF16, device=dev) for _ in range(3))
    kernels.launch(
        "attention_hstats", g2.data_ptr(), p.key.wt.data_ptr(), p.key.bp.data_ptr(),
        mul_k.data_ptr(), add_k.data_ptr(), p.hidden.wt.data_ptr(), p.hidden.bp.data_ptr(),
        qp.data_ptr(), p.gn1[0].data_ptr(), p.gn1[1].data_ptr(), part.data_ptr(),
        *(t.data_ptr() for t in gn1), _tickets(dev, B).data_ptr(), B, M, K, Ck, c2, inter_c, P,
    )
    return gn1, _sums_view(part, inter_c)


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


def attention_stats(mm, g2, gfo2, p: PreparedWeights, c1: int, K: int):
    """Sweep 1 and its finish.  mm (B, M, c1) bf16 = feat W0 (before its
    bias), g2 (B, M*K, Ck), gfo2 (B, M*K, Cv) bf16 -> mul_q, add_q (B, c1)
    and mul_k, add_k (B, c2) float32 (the first GroupNorm over [q, k] as
    per-channel multiply-adds) and the values' GroupNorm (mu, s, b)
    (B, c_out) bf16."""
    if kernels.use_plain(g2):
        return attention_stats_vectors_plain(mm, g2, gfo2, p, c1, K)
    return _stats_launch(mm, g2, gfo2, p, c1, K)[:5]


def attention_qn(mm, b0, mul_q, add_q):
    """The query rows between sweeps 1 and 2: mm (B, M, c1) bf16, b0 (c1)
    bf16, mul_q / add_q (B, c1) float32 -> qn = bf16(relu(mm + b0) * mul_q
    + add_q) (B, M, c1) bf16."""
    if kernels.use_plain(mm):
        return attention_qn_plain(mm, b0, mul_q, add_q)
    B, M, c1 = mm.shape
    kernels.check(mm, "attention_qn mm", BF16, (B, M, c1))
    kernels.check(b0, "attention_qn b0", BF16, (c1,))
    kernels.check(mul_q, "attention_qn mul_q", torch.float32, (B, c1))
    kernels.check(add_q, "attention_qn add_q", torch.float32, (B, c1))
    qn = torch.empty_like(mm)
    kernels.launch("attention_qn", mm.data_ptr(), b0.data_ptr(), mul_q.data_ptr(),
                   add_q.data_ptr(), qn.data_ptr(), B, M, c1)
    return qn


def attention_hstats(g2, qp, p: PreparedWeights, mul_k, add_k, K: int):
    """Sweep 2 and its finish.  qp (B, M, inter_c) bf16, mul_k / add_k
    (B, c2) float32 -> h's GroupNorm (mu, s, b) (B, inter_c) bf16."""
    if kernels.use_plain(g2):
        return attention_hstats_vectors_plain(g2, qp, p, mul_k, add_k, K)
    return _hstats_launch(g2, qp, p, mul_k, add_k, K)[0]


def attention_out(g2, gfo2, qp, counts, key, hidden, score, value, mul_k, add_k,
                  gn1, gn2, K: int):
    """Sweep 3.  gn1 / gn2: (mu, s, b) of h (B, inter_c) and of v (B, c_out),
    rounded to bf16 here; counts (B, M) int32 or None -> (B, M, c_out)
    float32."""
    if kernels.use_plain(g2):
        return attention_out_plain(g2, gfo2, qp, counts, key, hidden, score, value,
                                   mul_k, add_k, gn1, gn2, K)
    return _out_launch(g2, gfo2, qp, counts, key, hidden, score, value, mul_k, add_k,
                       _bf16_vectors(gn1), _bf16_vectors(gn2), K)


# ---- the function ---------------------------------------------------------
def attention_pool_kernel_macs(B: int, M: int, K: int, Ck: int, Cv: int, c2: int,
                               inter_c: int, c_out: int) -> int:
    """The multiply-adds of the products the unfused pool
    (``models/attention.py::AttentionPool``) computes with ``matmul`` over
    its (M, K) slots and the sweeps compute in their bodies: the key Dense,
    the key half of ``Dense_2``, the scores' ``Dense_3`` and the values'
    ``Dense_4``.  The query path's two products are ``torch.matmul`` on both
    routes, and the sweeps' recomputation of k and h is not model work: a
    model FLOP counts once.  ``utils/flops.py`` tallies it."""
    return B * M * K * (Ck * c2 + c2 * inter_c + inter_c * c_out + Cv * c_out)


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
    """``feat W0``, sweep 1 (which finishes the first and the values'
    GroupNorms), the query rows, ``qn W2q``, sweep 2 (which finishes h's
    GroupNorm) and sweep 3: six launches when the inputs
    are bf16 and the counts int32 or absent, the two products in
    ``torch.matmul`` (the JAX package leaves them to XLA).  On CPU tensors
    each step takes its plain version, in this order.  Records the products
    the sweeps take over from the unfused pool for the FLOP count
    (``utils/flops.py``), which cannot see a kernel's body."""
    B, M, _, Ck = grouped.shape
    record_pallas_macs(attention_pool_kernel_macs(B, M, K, Ck, gfo.shape[-1], c2, inter_c,
                                                  c_out))
    g2, gfo2 = _rows(grouped, gfo)
    mm = torch.matmul(feat.to(BF16), p.w0)
    mul_q, add_q, mul_k, add_k, gn2 = attention_stats(mm, g2, gfo2, p, c1, K)
    qp = torch.matmul(attention_qn(mm, p.b0, mul_q, add_q), p.w2q)
    gn1 = attention_hstats(g2, qp, p, mul_k, add_k, K)
    cnt = None if counts is None else counts.to(torch.int32).contiguous()
    return attention_out(g2, gfo2, qp, cnt, p.key, p.hidden, p.score, p.value, mul_k, add_k,
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
    sixteen parameter tensors.  On GPU tensors the three sweeps and the
    query-row pass run on the card (any K, any width whose 16-row tiles fit
    a block's shared memory, a few thousand channels; wider raises); on CPU
    tensors, or under ``kernels.plain_ops()``, the plain sweeps and glue."""
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
