"""Shared building blocks: Dense, partial group norm, the conditioned MLP
block and neighbour pooling.

Counterpart of the JAX package's ``models/common.py``.  Layout is
channels-last (B, M, K, C).  Submodules carry the Flax scope names
(``Dense_0``, ``PartialGroupNorm_0.GroupNorm_0``, ``SharedMLP_1``...) so a
state_dict key is the Flax parameter path joined by dots
(``utils/weights.py``).

The MLP blocks and the pooling run in the span ``pdr.net.mlp``
(``utils/profiling.py``).

Compute dtype: parameters stay float32; a module built with
``dtype=torch.bfloat16`` casts its input and parameters to bf16 at each
Dense, as Flax's ``promote_dtype`` does, so the rounding lands where the JAX
model rounds.  Autocast is not used.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils import profiling


def swish(x):
    return x * torch.sigmoid(x)


ACTIVATIONS = {"relu": torch.relu, "swish": swish}


def lecun_normal_(w: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    """Flax's default Dense kernel init: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / max(fan_in, 1)) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


class Dense(nn.Module):
    """``nn.Dense`` over the last axis: weight (out, in), bias (out,).

    ``dtype=None`` computes in float32 (Flax promotes the bf16 input against
    the f32 kernel); ``torch.bfloat16`` casts input, weight and bias first.
    The bias is added after the product, as Flax does."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.in_features = int(in_features)
        self.features = int(features)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(self.features, self.in_features))
        self.bias = nn.Parameter(torch.zeros(self.features)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        lecun_normal_(self.weight, self.in_features, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        d = self.dtype or torch.float32
        y = F.linear(x.to(d), self.weight.to(d))
        return y + self.bias.to(d) if self.bias is not None else y


class _GNParams(nn.Module):
    """GroupNorm affine parameters (Flax child ``GroupNorm_0``)."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))


class GroupNorm(_GNParams):
    """Flax ``nn.GroupNorm(num_groups, epsilon)`` on a channels-last tensor
    (B, ..., C): float32 statistics over every non-batch axis and one group
    of C / num_groups channels, Flax's fast variance max(E[x^2] - E[x]^2,
    0), a float32 output.  Parameters ``scale`` and ``bias``, as Flax names
    them."""

    def __init__(self, features: int, num_groups: int = 32, epsilon: float = 1e-6):
        super().__init__(features)
        if features % num_groups:
            raise ValueError(f"{features} channels do not split into {num_groups} groups")
        self.num_groups = int(num_groups)
        self.epsilon = float(epsilon)

    def forward(self, x):
        B, C = x.shape[0], x.shape[-1]
        g = self.num_groups
        xg = x.to(torch.float32).reshape(B, -1, g, C // g)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = ((xg * xg).mean(dim=(1, 3), keepdim=True) - mean * mean).clamp(min=0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale.reshape(1, 1, g, C // g)
        y = (xg - mean) * mul + self.bias.reshape(1, 1, g, C // g)
        return y.reshape(x.shape)


def _group_affine(sum_c, ssq_c, cnt, num_groups, scale, bias):
    """Per-(batch, channel) affine (mu, s, b) of a group norm from per-channel
    f32 sums: fast variance max(E[x^2] - E[x]^2, 0), eps 1e-5."""
    B, normed_c = sum_c.shape
    cg = normed_c // num_groups
    mean = sum_c.reshape(B, num_groups, cg).sum(-1) / cnt
    var = (ssq_c.reshape(B, num_groups, cg).sum(-1) / cnt - mean * mean).clamp(min=0.0)
    inv = torch.rsqrt(var + 1e-5)
    mu = mean.repeat_interleave(cg, dim=1)
    s = inv.repeat_interleave(cg, dim=1) * scale[None, :]
    b = bias[None, :].expand(B, normed_c)
    return mu, s, b


class PartialGroupNorm(nn.Module):
    """GroupNorm over the first ``C - C % num_groups`` channels; trailing
    channels pass through untouched, and with C < num_groups nothing is
    normalised (no parameters).  float32 statistics over the group's channels
    and all spatial axes, eps 1e-5.  With ``dtype=bf16`` and a bf16 input the
    affine runs in bf16, else in f32 with the output cast to ``dtype``."""

    def __init__(self, channels: int, num_groups: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.channels = int(channels)
        self.num_groups = int(num_groups)
        self.normed_c = self.channels - self.channels % self.num_groups
        self.dtype = dtype
        if self.normed_c:
            self.GroupNorm_0 = _GNParams(self.normed_c)

    def forward(self, x, stats=None):
        """``stats``: per-channel float32 (sum, sum of squares) over the
        spatial axes, each (B, >= C), computed elsewhere (next to a merged
        first-layer product)."""
        if self.normed_c == 0:
            return x
        c, nc = x.shape[-1], self.normed_c
        B = x.shape[0]
        spatial = tuple(range(1, x.dim() - 1))
        cnt = float(math.prod(x.shape[a] for a in spatial)) * (nc // self.num_groups)
        if stats is not None:
            sum_c, ssq_c = stats[0][:, :nc], stats[1][:, :nc]
        else:
            head = x[..., :nc].to(torch.float32)
            sum_c, ssq_c = head.sum(dim=spatial), (head * head).sum(dim=spatial)
        mu, s, b = _group_affine(
            sum_c, ssq_c, cnt, self.num_groups, self.GroupNorm_0.scale,
            self.GroupNorm_0.bias,
        )
        if nc != c:
            pad = c - nc
            mu = torch.cat([mu, mu.new_zeros(B, pad)], 1)
            s = torch.cat([s, s.new_ones(B, pad)], 1)
            b = torch.cat([b, b.new_zeros(B, pad)], 1)
        shp = (B,) + (1,) * (x.dim() - 2) + (c,)
        if self.dtype is not None and x.dtype == self.dtype:
            d = self.dtype
            return (x - mu.reshape(shp).to(d)) * s.reshape(shp).to(d) + b.reshape(shp).to(d)
        y = (x.to(torch.float32) - mu.reshape(shp)) * s.reshape(shp) + b.reshape(shp)
        return y.to(self.dtype or torch.float32)


class SharedMLP(nn.Module):
    """Stack of Dense(+norm+activation) layers.

    bn_first=True: [GN(in, groups=min(32, in)), act, Dense] per layer.
    bn_first=False: [Dense, GN(out, groups=32), act] per layer.
    ``trim_last`` drops the final layer's norm+act."""

    def __init__(self, in_features: int, features: Sequence[int], bn: bool = True,
                 bn_first: bool = False, bias: bool = False, activation: str = "relu",
                 trim_last: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.features = tuple(int(f) for f in features)
        self.bn, self.bn_first, self.trim_last = bn, bn_first, trim_last
        self.act = ACTIVATIONS[activation]
        self.out_features = self.features[-1]
        width = int(in_features)
        n = len(self.features)
        self._has_norm = []
        for i, f in enumerate(self.features):
            if bn_first:
                norm = bn
                if norm:
                    setattr(self, f"PartialGroupNorm_{i}",
                            PartialGroupNorm(width, min(32, width), dtype))
            else:
                norm = bn and not (trim_last and i == n - 1)
                if norm:
                    setattr(self, f"PartialGroupNorm_{i}", PartialGroupNorm(f, 32, dtype))
            self._has_norm.append(norm)
            setattr(self, f"Dense_{i}", Dense(width, f, use_bias=bias, dtype=dtype))
            width = f

    @profiling.spanned("pdr.net.mlp", device=True)
    def forward(self, x, first_pre: bool = False, first_stats=None):
        """``first_pre=True``: ``x`` is already the first Dense's output
        (from a merged product that reads the grouped tensor once for all
        its consumers); that Dense is skipped.  Dense-first stacks only.
        ``first_stats``: that output's (sum, sum of squares) for its norm."""
        n = len(self.features)
        if first_pre:
            assert not self.bn_first
        for i in range(n):
            if self.bn_first:
                if self._has_norm[i]:
                    x = getattr(self, f"PartialGroupNorm_{i}")(x)
                x = self.act(x)
                x = getattr(self, f"Dense_{i}")(x)
            else:
                if not (first_pre and i == 0):
                    x = getattr(self, f"Dense_{i}")(x)
                if not (self.trim_last and i == n - 1):
                    if self._has_norm[i]:
                        x = getattr(self, f"PartialGroupNorm_{i}")(
                            x, stats=first_stats if (first_pre and i == 0) else None)
                    x = self.act(x)
        return x


class ConditionedMLP(nn.Module):
    """The conditioned block (the reference's Mlp_plus_t_emb).

    On input h (B, M, K, C):
      [first_conv] -> mlp1 -> (+ Dense(t_emb))
                   -> mlp2 -> (+ Dense(condition_emb))
                   -> rest  -> (+ Dense(second_condition_emb))
      + residual(input after first_conv)

    Dense_i are numbered in Flax's construction order: first_conv, t
    projection, condition projection, second condition projection,
    residual projection (each only when present)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 include_t: bool = False, t_features: int = 0,
                 include_condition: bool = False, condition_features: int = 0,
                 include_second_condition: bool = False, second_condition_features: int = 0,
                 bn: bool = True, bn_first: bool = False, bias: bool = False,
                 first_conv_features: Optional[int] = None, res_connect: bool = False,
                 activation: str = "relu", trim_last: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        feats = tuple(int(f) for f in features)
        assert len(feats) >= 2
        if include_second_condition:
            assert len(feats) >= 3
        self.features = feats
        self.out_features = feats[-1]
        self.bn, self.bn_first = bn, bn_first
        self.include_t = include_t
        self.include_condition = include_condition
        self.include_second_condition = include_second_condition
        self.has_rest = len(feats) > 2
        mk = lambda i, fs, trim=False: SharedMLP(
            i, fs, bn=bn, bn_first=bn_first, bias=bias, activation=activation,
            trim_last=trim, dtype=dtype,
        )
        names = iter(f"Dense_{i}" for i in range(8))
        width = int(in_features)
        self.first_conv = None
        if first_conv_features is not None:
            self.first_conv = next(names)
            setattr(self, self.first_conv,
                    Dense(width, first_conv_features, use_bias=bias, dtype=dtype))
            width = int(first_conv_features)
        self.SharedMLP_0 = mk(width, feats[:1])
        self.t_proj = self.cond_proj = self.second_proj = self.res_proj = None
        if include_t:
            self.t_proj = next(names)
            setattr(self, self.t_proj, Dense(t_features, feats[0], dtype=dtype))
        self.SharedMLP_1 = mk(feats[0], feats[1:2], trim=trim_last and not self.has_rest)
        if include_condition:
            self.cond_proj = next(names)
            setattr(self, self.cond_proj, Dense(condition_features, feats[1], dtype=dtype))
        if self.has_rest:
            self.SharedMLP_2 = mk(feats[1], feats[2:], trim=trim_last)
        if include_second_condition:
            self.second_proj = next(names)
            setattr(self, self.second_proj,
                    Dense(second_condition_features, feats[-1], dtype=dtype))
        self.res_connect = res_connect
        self.res_identity = width == feats[-1]
        if res_connect and not self.res_identity:
            self.res_proj = next(names)
            setattr(self, self.res_proj, Dense(width, feats[-1], use_bias=bias, dtype=dtype))

    @profiling.spanned("pdr.net.mlp", device=True)
    def forward(self, feature, t_emb=None, condition_emb=None, second_condition_emb=None,
                first_pre=None, res_pre=None, first_stats=None):
        """``first_pre`` / ``res_pre``: the first Dense's output and the
        residual projection's output computed elsewhere
        (``modules._packed_first_layers``); those layers are then skipped."""
        if self.first_conv is not None:
            assert first_pre is None
            feature = getattr(self, self.first_conv)(feature)
        if first_pre is not None:
            h = self.SharedMLP_0(first_pre, first_pre=True, first_stats=first_stats)
        else:
            h = self.SharedMLP_0(feature)
        if self.include_t:
            assert t_emb is not None
            h = h + getattr(self, self.t_proj)(t_emb)[:, None, None, :]
        else:
            assert t_emb is None
        h = self.SharedMLP_1(h)
        if self.include_condition:
            assert condition_emb is not None
            h = h + getattr(self, self.cond_proj)(condition_emb)[:, None, None, :]
        else:
            assert condition_emb is None
        if self.has_rest:
            h = self.SharedMLP_2(h)
        if self.include_second_condition:
            assert second_condition_emb is not None
            h = h + getattr(self, self.second_proj)(second_condition_emb)[:, None, None, :]
        else:
            assert second_condition_emb is None
        if self.res_connect:
            if res_pre is not None:
                h = h + res_pre
            elif self.res_identity:
                h = h + feature
            else:
                h = h + getattr(self, self.res_proj)(feature)
        return h


@profiling.spanned("pdr.net.mlp", device=True)
def pool_features(feature, counts, pooling: str = "max"):
    """Pool (B, M, K, C) over the neighbour axis K -> (B, M, C): 'max' ignores
    counts (padded slots repeat real neighbours); 'avg' is count-masked;
    'avg_max'/'max_avg' max the first half of the channels and average the
    second half."""
    from ..ops.neighbors import masked_mean

    if pooling == "max":
        return feature.amax(dim=-2)
    if pooling == "avg":
        return masked_mean(feature, counts)
    if "avg" in pooling and "max" in pooling:
        half = feature.shape[-1] // 2
        mx = feature[..., :half].amax(dim=-2)
        av = masked_mean(feature[..., half:], counts)
        return torch.cat([mx, av], dim=-1)
    raise ValueError(f"{pooling} pooling is not supported")
