"""Attention pooling over neighbour groups, and global self-attention.

Counterpart of the JAX package's ``models/attention.py``.  ``AttentionPool``
follows its default split-q/k path: the reference broadcasts conv(query) to
every neighbour slot and concatenates before its norm + conv stack; since
the q half is constant over K, the first GroupNorm's statistics factor
across the q/k channel boundary and the following Dense splits into a
per-centre part and a grouped part, so the (B, M, K, C1+C2) concatenation is
never built.  The softmax over K is count-masked.  ``GlobalSelfAttention``
is the module the ``global_attention_setting`` of a config adds after the
coarsest set-abstraction and kNN feature-propagation levels.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.neighbors import count_to_mask
from .common import Dense, PartialGroupNorm, _fp8, _GNParams, _group_affine


class SplitConcatGroupNorm(nn.Module):
    """PartialGroupNorm of ``concat([broadcast_K(q), k], -1)`` computed on the
    halves: q's per-channel sums enter with weight K.  Returns the normalised
    halves ``(qn (B, M, C1), kn (B, M, K, C2))``.  Parameters match a
    PartialGroupNorm of width C1 + C2 (child ``GroupNorm_0``)."""

    def __init__(self, channels: int, num_groups: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_groups = int(num_groups)
        self.normed_c = int(channels) - int(channels) % self.num_groups
        self.dtype = dtype
        if self.normed_c:
            self.GroupNorm_0 = _GNParams(self.normed_c)

    def forward(self, q, k, k_stats=None):
        """``k_stats``: float32 per-channel (sum, sum of squares) of ``k``
        over its (M, K) axes, each (B, C2), computed elsewhere."""
        c1, c2 = q.shape[-1], k.shape[-1]
        nc = self.normed_c
        if nc == 0:
            return q, k
        K = k.shape[-2]
        M = q.shape[1]
        cnt = float(M) * float(K) * (nc // self.num_groups)
        xq = q.to(torch.float32)
        xk = k.to(torch.float32)
        if k_stats is not None:
            sum_k, ssq_k = k_stats
        else:
            sum_k, ssq_k = xk.sum(dim=(1, 2)), (xk * xk).sum(dim=(1, 2))
        sum_c = torch.cat([xq.sum(dim=1) * K, sum_k], dim=-1)[:, :nc]
        ssq_c = torch.cat([(xq * xq).sum(dim=1) * K, ssq_k], dim=-1)[:, :nc]
        mean, rstd, _ = _group_affine(
            sum_c, ssq_c, cnt, self.num_groups,
            torch.ones_like(self.GroupNorm_0.scale), torch.zeros_like(self.GroupNorm_0.bias),
        )
        mul = rstd * self.GroupNorm_0.scale[None]
        add = self.GroupNorm_0.bias[None] - mean * mul
        nq = min(c1, nc)
        nk = nc - nq
        d = self.dtype
        if d is not None and q.dtype == d and k.dtype == d:
            qn = q[..., :nq] * mul[:, None, :nq].to(d) + add[:, None, :nq].to(d)
            kn = k[..., :nk] * mul[:, None, None, nq:].to(d) + add[:, None, None, nq:].to(d)
            src_q, src_k = q, k
        else:
            qn = xq[..., :nq] * mul[:, None, :nq] + add[:, None, :nq]
            kn = xk[..., :nk] * mul[:, None, None, nq:] + add[:, None, None, nq:]
            src_q, src_k = xq, xk
        if nq < c1:
            qn = torch.cat([qn, src_q[..., nq:]], dim=-1)
        if nk < c2:
            kn = torch.cat([kn, src_k[..., nk:]], dim=-1)
        if d is not None and q.dtype == d and k.dtype == d:
            return qn, kn
        out = d or torch.float32
        return qn.to(out), kn.to(out)


class SplitDense(Dense):
    """Dense over ``concat([broadcast_K(q), k], -1)`` without the concat:
    returns ``(q_part (B, M, F), k_part (B, M, K, F))`` with the bias folded
    into the k part; the caller adds them.  Parameters match a Dense over the
    concatenated input."""

    def forward(self, q, k):
        c1 = q.shape[-1]
        if self.fp8:
            w = _fp8(self.weight)
            return (_fp8(F.linear(_fp8(q), w[:, :c1])),
                    _fp8(F.linear(_fp8(k), w[:, c1:]) + self.bias))
        d = self.dtype or torch.float32
        w = self.weight.to(d)
        qp = F.linear(q.to(d), w[:, :c1])
        kp = F.linear(k.to(d), w[:, c1:]) + self.bias.to(d)
        return qp, kp


# called with (pool, feat, grouped_feat, grouped_feat_out) at each site the
# program serves with its fused attention-pool kernels
FUSED_POOL_HOOKS: list = []


class AttentionPool(nn.Module):
    """Per-neighbourhood attention pooling.

    query:   feat             (B, M, Cq)      feature at the centre point
    key:     grouped_feat     (B, M, K, Ck)   raw grouped features
    value:   grouped_feat_out (B, M, K, Cv)   MLP output
    counts:  (B, M) int or 'all'

    Scores are an MLP over [Dense(query) broadcast, Dense(key)]; softmax over
    K with invalid slots set to -1e9; the output is the weighted value sum.

    ``forward(..., fused=True)`` (inference only: no gradient) sends the
    whole pool through ``ops.fused_attention_pool`` and returns float32, as
    the JAX package's fused path does; it is taken only under bf16 compute
    with the three flags true and no ``key_pre``, and with the same
    parameters as the unfused path.
    """

    def __init__(self, query_features: int, key_features: int, value_features: int,
                 out_features: int, attention_bn: bool = True,
                 transform_grouped_feat_out: bool = True, last_activation: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        c1 = max(int(query_features), 32)
        c2 = max(int(key_features), 32)
        c_out = int(out_features)
        inter_c = min(c1 + c2, c_out)
        self.attention_bn = attention_bn
        self.transform_out = transform_grouped_feat_out
        self.last_activation = last_activation
        self.dtype = dtype
        self.widths = dict(c1=c1, c2=c2, inter_c=inter_c, c_out=c_out)
        self.Dense_0 = Dense(query_features, c1, dtype=dtype)
        self.Dense_1 = Dense(key_features, c2, dtype=dtype)
        if attention_bn:
            self.PartialGroupNorm_0 = SplitConcatGroupNorm(c1 + c2, min(32, c1 + c2), dtype)
        self.Dense_2 = SplitDense(c1 + c2, inter_c, dtype=dtype)
        if attention_bn:
            self.PartialGroupNorm_1 = PartialGroupNorm(inter_c, min(32, inter_c), dtype)
        self.Dense_3 = Dense(inter_c, c_out, dtype=dtype)
        if transform_grouped_feat_out:
            self.Dense_4 = Dense(value_features, c_out, dtype=dtype)
            if last_activation and attention_bn:
                self.PartialGroupNorm_2 = PartialGroupNorm(c_out, min(32, c_out), dtype)

    def fused_eligible(self, fused: bool, key_pre) -> bool:
        """The sites the fused kernels serve: the shipped all-flags-true
        shape under bf16 compute, with the key Dense not precomputed."""
        return (
            fused
            and self.dtype == torch.bfloat16
            and self.attention_bn and self.transform_out and self.last_activation
            and key_pre is None
        )

    def forward(self, feat, grouped_feat, grouped_feat_out, counts, fused: bool = False,
                key_pre=None, key_stats=None):
        """``key_pre``: ``Dense_1(grouped_feat)`` computed elsewhere (a merged
        product that reads the grouped tensor once for all its consumers);
        the key Dense is then skipped.  ``key_stats``: float32 (sum, sum of
        squares) of relu(key_pre) over (M, K), for the first GroupNorm."""
        K = grouped_feat.shape[-2]
        if self.fused_eligible(fused, key_pre):
            # the site the program's fused pool serves: recorded, then the
            # unfused pool's math below
            for hook in FUSED_POOL_HOOKS:
                hook(self, feat, grouped_feat, grouped_feat_out)
        q = self.Dense_0(feat)
        k = key_pre if key_pre is not None else self.Dense_1(grouped_feat)
        hq = torch.relu(q)  # ReLU precedes the norm
        hk = torch.relu(k)
        if self.attention_bn:
            hq, hk = self.PartialGroupNorm_0(hq, hk, k_stats=key_stats)
        qp, kp = self.Dense_2(hq, hk)
        h = torch.relu(qp[:, :, None, :] + kp)
        if self.attention_bn:
            h = self.PartialGroupNorm_1(h)
        scores = self.Dense_3(h)
        if not (isinstance(counts, str) and counts == "all"):
            c = counts.clamp(min=1)
            mask = count_to_mask(c, K)[..., None].to(scores.dtype)
            scores = scores * mask + (-1e9) * (1.0 - mask)
        weight = torch.softmax(scores.to(torch.float32), dim=-2)
        v = grouped_feat_out
        if self.transform_out:
            v = self.Dense_4(v)
            if self.last_activation:
                if self.attention_bn:
                    v = self.PartialGroupNorm_2(v)
                v = torch.relu(v)
        if self.dtype is not None and v.dtype == self.dtype:
            # bf16 weights, f32 accumulation of the K-axis sum
            w = weight.to(self.dtype)
            return (v * w).sum(dim=-2, dtype=torch.float32).to(self.dtype)
        return (v * weight).sum(dim=-2)


class GlobalSelfAttention(nn.Module):
    """Full N x N self-attention with pairwise-concat MLP scores (the JAX
    package's ``GlobalSelfAttention``, the reference's GlobalAttentionModule).

    The reference combines ``(value.unsqueeze(-1) * weight).sum(dim=-1)``:
    value is indexed by the query axis and broadcast over the key axis, so
    the softmax-normalised sum is exactly ``value``.  The module's output is
    therefore the value Dense (+ norm / ReLU); the score parameters exist with
    the reference's shapes (so checkpoints carry across) and are not
    computed.  ``true_attention=True`` attends over the keys for real, as the
    JAX package's option of that name does.

    Input feat (B, N, in_features), the trailing channels raw coordinates;
    output (B, N, features) float32 (the module computes in float32, as its
    Flax counterpart, built without a dtype, promotes).  Submodules carry
    Flax's creation-order names: Dense_0 key, Dense_1 query, Dense_2 value,
    then the norms and Dense_3 / Dense_4 of the score MLP.
    """

    def __init__(self, in_features: int, features: int, attention_bn: bool = True,
                 last_activation: bool = True, true_attention: bool = False):
        super().__init__()
        C = int(features)
        self.attention_bn = attention_bn
        self.last_activation = last_activation
        self.true_attention = true_attention
        self.Dense_0 = Dense(in_features, C)
        self.Dense_1 = Dense(in_features, C)
        self.Dense_2 = Dense(in_features, C)
        norms = iter(f"PartialGroupNorm_{i}" for i in range(3))
        self.value_norm = self.pair_norm = self.hidden_norm = None
        if last_activation and attention_bn:
            self.value_norm = next(norms)
            setattr(self, self.value_norm, PartialGroupNorm(C, min(32, C)))
        if attention_bn:
            self.pair_norm = next(norms)
            setattr(self, self.pair_norm, PartialGroupNorm(2 * C, min(32, 2 * C)))
        self.Dense_3 = Dense(2 * C, C)
        if attention_bn:
            self.hidden_norm = next(norms)
            setattr(self, self.hidden_norm, PartialGroupNorm(C, min(32, C)))
        self.Dense_4 = Dense(C, C)

    def forward(self, feat):
        value = self.Dense_2(feat)
        if self.last_activation:
            if self.value_norm is not None:
                value = getattr(self, self.value_norm)(value)
            value = torch.relu(value)
        if not self.true_attention:
            return value
        key, query = self.Dense_0(feat), self.Dense_1(feat)
        B, N, C = value.shape
        h = torch.relu(torch.cat([query[:, :, None, :].expand(B, N, N, C),
                                  key[:, None, :, :].expand(B, N, N, C)], dim=-1))
        if self.pair_norm is not None:
            h = getattr(self, self.pair_norm)(h)
        h = torch.relu(self.Dense_3(h))
        if self.hidden_norm is not None:
            h = getattr(self, self.hidden_norm)(h)
        weight = torch.softmax(self.Dense_4(h), dim=2)  # over the key axis
        return torch.einsum("bnmc,bmc->bnc", weight, value)
