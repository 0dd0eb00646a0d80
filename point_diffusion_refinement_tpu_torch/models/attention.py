"""Attention pooling over neighbour groups.

Counterpart of the JAX package's ``models/attention.py`` on its default
split-q/k path: the reference broadcasts conv(query) to every neighbour slot
and concatenates before its norm + conv stack; since the q half is constant
over K, the first GroupNorm's statistics factor across the q/k channel
boundary and the following Dense splits into a per-centre part and a
grouped part, so the (B, M, K, C1+C2) concatenation is never built.  The
softmax over K is count-masked.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.neighbors import count_to_mask
from .common import Dense, PartialGroupNorm, _GNParams, _group_affine


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

    def forward(self, q, k):
        c1, c2 = q.shape[-1], k.shape[-1]
        nc = self.normed_c
        if nc == 0:
            return q, k
        K = k.shape[-2]
        M = q.shape[1]
        cnt = float(M) * float(K) * (nc // self.num_groups)
        xq = q.to(torch.float32)
        xk = k.to(torch.float32)
        sum_c = torch.cat([xq.sum(dim=1) * K, xk.sum(dim=(1, 2))], dim=-1)[:, :nc]
        ssq_c = torch.cat([(xq * xq).sum(dim=1) * K, (xk * xk).sum(dim=(1, 2))], dim=-1)[:, :nc]
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
        d = self.dtype or torch.float32
        w = self.weight.to(d)
        qp = F.linear(q.to(d), w[:, :c1])
        kp = F.linear(k.to(d), w[:, c1:]) + self.bias.to(d)
        return qp, kp


class AttentionPool(nn.Module):
    """Per-neighbourhood attention pooling.

    query:   feat             (B, M, Cq)      feature at the centre point
    key:     grouped_feat     (B, M, K, Ck)   raw grouped features
    value:   grouped_feat_out (B, M, K, Cv)   MLP output
    counts:  (B, M) int or 'all'

    Scores are an MLP over [Dense(query) broadcast, Dense(key)]; softmax over
    K with invalid slots set to -1e9; the output is the weighted value sum.
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

    def forward(self, feat, grouped_feat, grouped_feat_out, counts):
        K = grouped_feat.shape[-2]
        q = self.Dense_0(feat)
        k = self.Dense_1(grouped_feat)
        hq = torch.relu(q)  # ReLU precedes the norm
        hk = torch.relu(k)
        if self.attention_bn:
            hq, hk = self.PartialGroupNorm_0(hq, hk)
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
