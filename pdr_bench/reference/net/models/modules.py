"""PointNet++ modules: set abstraction, feature propagation (3-NN and kNN
variants) and the feature-transfer (FT) module.

Counterpart of the JAX package's ``models/modules.py``.  Flax infers input
widths lazily; here every module is built with its input widths, which
``condition_net.py`` derives from the config.

Routing of the fused ball-group kernel (``ops/ball_group.py``) follows the
JAX package's routing of its windowed kernel: inference only (``fused``),
bf16 compute, radius neighbourhoods, the [features, rel, abs(, center)]
layout, a support of >= 1024 points and a query count that is a multiple
of 128.  The JAX package also falls back when its packed table would pass
128 lanes, a TPU layout limit with no counterpart here.

The training step has two opt-in routes, both off by default as in the JAX
package (environment variables there, keyword arguments here):
``fused_sa`` sends the set-abstraction levels that pass
``SetAbstraction.train_fused_eligible`` (the JAX package's
``_train_windowed_eligible``, width limit included) through the
differentiable fused ball group ``ops.ball_group_train``, and
``fused_gather`` sends every other radius grouping through
``grouping.fused_ball_gather``.

Inference has three more opt-in routes, off by default as in the JAX package
(environment variables for fused attention, the windowed kNN and the packed
first layers there, keyword arguments of ``forward`` here):
``fused_attention`` sends an attention pool through the three-sweep kernel
(``ops.fused_attention_pool``) at the sites ``AttentionPool.fused_eligible`` accepts, ``fused_knn`` sends
the kNN grouping of a feature propagation through ``ops.knn_group`` at the
sites ``KnnFeaturePropagation.fused_knn_eligible`` accepts (the JAX
package's size rule, kept so that both packages take the same sites), and
``packed`` merges the products that read a grouped tensor (the MLP's first
Dense, its residual projection and the pool's key Dense) into one
(``_packed_first_layers``).  Where ``packed`` hands a pool its key, that pool
stays unfused: packed wins.

``GlobalSelfAttention`` follows a set abstraction or a kNN feature
propagation at the levels a config's ``global_attention_setting`` names, on
[features, xyz], as in the JAX package.  With ``include_grouper`` a
feature propagation groups its joined features over its own points (ball
query or kNN at the level's radius and nsample), runs its MLP over the
groups and pools them; the fused kNN route stays off there, and under
``fused_gather`` the grouping takes the fused ball query + gather as every
other radius grouping does.

Neighbour statistics: a grouping module built with
``record_neighbor_stats`` records a (nsample + 1,) histogram of its
neighbour counts, clipped to nsample, on every forward inside
``collect_neighbor_stats(model)``, keyed by the Flax path the JAX package's
``neighbor_stats`` collection flattens to (``sa_0/count_hist``).  kNN
groupings record nothing, and outside the context nothing is recorded.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.ball_group import ball_group, ball_group_train
from ..ops.interpolate import inverse_distance_weights, three_interpolate, three_nn
from ..ops.sampling import furthest_point_sample_and_gather, gather_points
from .attention import AttentionPool, GlobalSelfAttention
from .common import ConditionedMLP, pool_features
from .grouping import group_knn_features, grouped_width, query_and_group

# The CUDA kernel takes any size; these gates keep the JAX package's routing
# so that the fused kernel serves exactly the call sites its TPU kernel does.
FUSED_MIN_SUPPORT = 1024
FUSED_QUERY_MULTIPLE = 128
# the TPU kernel's packed table holds 8 position lanes + the features in 128
TRAIN_FUSED_MAX_TABLE = 128
# ... and in 256 for the kNN group of a feature propagation
KNN_FUSED_MAX_TABLE = 256


def _sow_count_hist(mod: nn.Module, counts, nsample: int) -> None:
    """Add this forward's (nsample + 1,) float32 histogram of ``counts``
    (clipped to nsample) to the sink ``collect_neighbor_stats`` armed
    ``mod`` with; nothing without a sink or for kNN counts ("all")."""
    sink = getattr(mod, "_stats_sink", None)
    if sink is None or counts is None or isinstance(counts, str):
        return
    c = counts.clamp(0, nsample).reshape(-1).to(torch.int64)
    # bincount reads its bin count back to the host, which a captured
    # training step cannot do; the bins are known
    hist = torch.zeros(nsample + 1, dtype=torch.int64, device=c.device).index_add_(
        0, c, torch.ones_like(c)).to(torch.float32)
    name = mod._stats_name
    sink[name] = sink[name] + hist if name in sink else hist


@contextlib.contextmanager
def collect_neighbor_stats(model: nn.Module):
    """Within the context, every submodule of ``model`` built with
    ``record_neighbor_stats`` adds its count histogram of each forward to
    the dict this yields, keyed ``<flax path>/count_hist``."""
    stats: Dict[str, torch.Tensor] = {}
    armed = []
    for name, m in model.named_modules():
        if getattr(m, "record_neighbor_stats", False):
            m._stats_sink = stats
            m._stats_name = name.replace(".", "/") + "/count_hist"
            armed.append(m)
    try:
        yield stats
    finally:
        for m in armed:
            m._stats_sink = None


def _cat_all(parts) -> torch.Tensor:
    """``concatenate(parts, -1)`` in the promoted dtype, as jnp does."""
    dt = parts[0].dtype
    for p in parts[1:]:
        dt = torch.promote_types(dt, p.dtype)
    return torch.cat([p.to(dt) for p in parts], dim=-1)


def _packed_first_layers(grouped: torch.Tensor, cm: ConditionedMLP,
                         ap: Optional[AttentionPool], dtype):
    """The products that each read the (B, M, K, C) grouped tensor (the
    conditioned MLP's first Dense, its residual projection and the attention
    pool's key Dense) as one product over the row-wise concatenation of their
    weights, sliced afterwards: the same per-output arithmetic, one read.

    Returns (first_pre, res_pre, key_pre, first_stats, key_stats), the
    layers' outputs with the float32 (sum, sum of squares) their GroupNorms
    need, or None where the configuration does not match (norm-first or
    first-conv stacks, other widths) or there is nothing to merge."""
    if cm.bn_first or cm.first_conv is not None:
        return None
    first = cm.SharedMLP_0.Dense_0
    C = grouped.shape[-1]
    if first.in_features != C:
        return None
    f_last = cm.features[-1]
    layers = [first]
    res_needed = cm.res_connect and C != f_last
    if res_needed:
        res = getattr(cm, cm.res_proj) if cm.res_proj is not None else None
        if res is None or (res.in_features, res.features) != (C, f_last):
            return None
        layers.append(res)
    if ap is not None:
        key = ap.Dense_1
        if (key.in_features, key.features) != (C, max(C, 32)):
            return None
        layers.append(key)
    if len(layers) == 1:
        return None
    d = dtype or torch.float32
    w_cat = torch.cat([m.weight for m in layers], dim=0).to(d)
    b_cat = torch.cat([m.bias if m.bias is not None else m.weight.new_zeros(m.features)
                       for m in layers]).to(d)
    out = F.linear(grouped.to(d), w_cat) + b_cat
    f0 = first.features
    first_pre = out[..., :f0]
    off = f0
    res_pre = None
    if res_needed:
        res_pre = out[..., off:off + f_last]
        off += f_last
    key_pre = out[..., off:] if ap is not None else None

    spatial = tuple(range(1, out.dim() - 1))

    def sums(x):
        x32 = x.to(torch.float32)
        return x32.sum(dim=spatial), (x32 * x32).sum(dim=spatial)

    first_stats = sums(first_pre) if cm.bn and not cm.bn_first else None
    key_stats = sums(torch.relu(key_pre)) if ap is not None and ap.attention_bn else None
    return first_pre, res_pre, key_pre, first_stats, key_stats


def _mlp_and_pool(cm: ConditionedMLP, ap: Optional[AttentionPool], grouped, counts, query,
                  pooling: str, dtype, fused_attention: bool, packed: bool, **emb):
    """The conditioned MLP over a grouped tensor, then the attention pool
    (``ap`` with ``query``) or the max/avg pool, with the two inference
    routes applied where they are eligible."""
    pre = _packed_first_layers(grouped, cm, ap, dtype) if packed else None
    first_pre, res_pre, key_pre, first_stats, key_stats = pre if pre is not None else (None,) * 5
    out = cm(grouped, first_pre=first_pre, res_pre=res_pre, first_stats=first_stats, **emb)
    if ap is None:
        return pool_features(out, counts, pooling)
    return ap(query, grouped, out, counts, fused=fused_attention, key_pre=key_pre,
              key_stats=key_stats)


class SetAbstraction(nn.Module):
    """FPS -> ball-query grouping -> conditioned MLP -> attention pool or
    max/avg pool."""

    def __init__(self, in_features: int, npoint: int, radius: float, nsample: int,
                 mlp: Sequence[int], include_t: bool = False, t_features: int = 0,
                 include_condition: bool = False, condition_features: int = 0,
                 include_second_condition: bool = False,
                 second_condition_features: int = 0, use_xyz: bool = True,
                 include_abs_coordinate: bool = False,
                 include_center_coordinate: bool = False, bn: bool = True,
                 bn_first: bool = False, bias: bool = False, res_connect: bool = False,
                 first_conv_features: Optional[int] = None, neighbor_def: str = "radius",
                 activation: str = "relu", use_attention: bool = False,
                 attention_bn: bool = True, attention_transform_out: bool = True,
                 attention_last_activation: bool = True,
                 use_global_attention: bool = False, global_attention_bn: bool = True,
                 global_attention_last_activation: bool = True,
                 dtype: Optional[torch.dtype] = None, record_neighbor_stats: bool = False):
        super().__init__()
        self.record_neighbor_stats = record_neighbor_stats
        self.npoint, self.radius, self.nsample = int(npoint), float(radius), int(nsample)
        self.in_features = int(in_features)
        self.use_xyz, self.include_abs = use_xyz, include_abs_coordinate
        self.include_center = include_center_coordinate
        self.neighbor_def = neighbor_def
        self.include_t = include_t
        self.include_condition = include_condition
        self.include_second_condition = include_second_condition
        self.use_attention = use_attention
        self.dtype = dtype
        gw = grouped_width(self.in_features, use_xyz, include_abs_coordinate,
                           include_center_coordinate)
        self.ConditionedMLP_0 = ConditionedMLP(
            gw, mlp, include_t=include_t, t_features=t_features,
            include_condition=include_condition, condition_features=condition_features,
            include_second_condition=include_second_condition,
            second_condition_features=second_condition_features, bn=bn,
            bn_first=bn_first, bias=bias, first_conv_features=first_conv_features,
            res_connect=res_connect, activation=activation, dtype=dtype,
        )
        if use_attention:
            self.AttentionPool_0 = AttentionPool(
                self.in_features, gw, mlp[-1], mlp[-1], attention_bn=attention_bn,
                transform_grouped_feat_out=attention_transform_out,
                last_activation=attention_last_activation, dtype=dtype,
            )
        self.use_global_attention = use_global_attention
        if use_global_attention:
            self.GlobalSelfAttention_0 = GlobalSelfAttention(
                mlp[-1] + 3, mlp[-1], attention_bn=global_attention_bn,
                last_activation=global_attention_last_activation,
            )

    def fused_eligible(self, xyz, features, fused: bool) -> bool:
        return (
            fused
            and self.dtype is not None
            and features is not None
            and xyz.shape[1] >= FUSED_MIN_SUPPORT
            and self.neighbor_def == "radius"
            and self.use_xyz and self.include_abs
            and self.npoint % FUSED_QUERY_MULTIPLE == 0
        )

    def train_fused_eligible(self, xyz, features, fused_sa: bool) -> bool:
        """The levels the training step's ``fused_sa`` route serves."""
        return (
            fused_sa
            and self.neighbor_def == "radius"
            and features is not None
            and 8 + features.shape[-1] <= TRAIN_FUSED_MAX_TABLE
            and self.use_xyz and self.include_abs
            and self.dtype is not None
            and xyz.shape[1] >= FUSED_MIN_SUPPORT
            and self.npoint % FUSED_QUERY_MULTIPLE == 0
        )

    def forward(self, xyz, features, t_emb=None, condition_emb=None,
                second_condition_emb=None, pooling: str = "max", fused: bool = False,
                fps_ordered: bool = False, fused_gather: bool = False,
                fused_sa: bool = False, fused_attention: bool = False,
                packed: bool = False):
        if fps_ordered:
            # the input is the previous level's FPS output in selection order,
            # and greedy FPS is prefix-stable: FPS here is the identity prefix
            fps_idx = None
            new_xyz = xyz[:, : self.npoint]
        else:
            fps_idx, new_xyz = furthest_point_sample_and_gather(xyz, self.npoint)

        if not fused and self.train_fused_eligible(xyz, features, fused_sa):
            grouped, counts, _ = ball_group_train(
                xyz, features, new_xyz, self.radius, self.nsample,
                include_center=self.include_center, empty_mode="row0",
            )
        elif self.fused_eligible(xyz, features, fused):
            (grouped,), counts = ball_group(
                xyz, [features], new_xyz, self.radius, self.nsample,
                include_center=self.include_center, empty_mode="row0",
            )
        else:
            grouped, counts = query_and_group(
                xyz, new_xyz, features, radius=self.radius, nsample=self.nsample,
                neighbor_def=self.neighbor_def, use_xyz=self.use_xyz,
                include_abs_coordinate=self.include_abs,
                include_center_coordinate=self.include_center, subset=True,
                fused_gather=fused_gather,
            )
        _sow_count_hist(self, counts, self.nsample)
        query = None
        if self.use_attention:
            query = (features[:, : self.npoint] if fps_ordered
                     else gather_points(features, fps_idx))
        new_features = _mlp_and_pool(
            self.ConditionedMLP_0, self.AttentionPool_0 if self.use_attention else None,
            grouped, counts, query, pooling, self.dtype, fused_attention, packed,
            t_emb=t_emb if self.include_t else None,
            condition_emb=condition_emb if self.include_condition else None,
            second_condition_emb=(
                second_condition_emb if self.include_second_condition else None
            ),
        )
        if self.use_global_attention:
            new_features = self.GlobalSelfAttention_0(_cat_all([new_features, new_xyz]))
        # new_xyz stays in FPS selection order: the next level's
        # fps_ordered=True relies on it
        return new_xyz, new_features


class _Grouper:
    """The grouper of a feature propagation: ``query_and_group`` of the
    joined features over the propagation's own points."""

    def _init_grouper(self, include_grouper: bool, radius: float, nsample: int,
                      use_xyz: bool, include_abs_coordinate: bool,
                      include_center_coordinate: bool, neighbor_def: str,
                      record_neighbor_stats: bool) -> None:
        self.include_grouper = include_grouper
        self.radius, self.nsample = float(radius), int(nsample)
        self.use_xyz, self.include_abs = use_xyz, include_abs_coordinate
        self.include_center = include_center_coordinate
        self.neighbor_def = neighbor_def
        self.record_neighbor_stats = record_neighbor_stats

    def _mlp_in(self, joined: int) -> int:
        """The MLP's input width over ``joined`` feature channels."""
        if not self.include_grouper:
            return joined
        return grouped_width(joined, self.use_xyz, self.include_abs, self.include_center)

    def _group(self, unknown, new_features, fused_gather: bool):
        grouped, counts = query_and_group(
            unknown, unknown, new_features, radius=self.radius, nsample=self.nsample,
            neighbor_def=self.neighbor_def, use_xyz=self.use_xyz,
            include_abs_coordinate=self.include_abs,
            include_center_coordinate=self.include_center, subset=True,
            fused_gather=fused_gather,
        )
        _sow_count_hist(self, counts, self.nsample)
        return grouped, counts


class FeaturePropagation(_Grouper, nn.Module):
    """3-NN inverse-distance interpolation + skip concat + conditioned MLP
    (over the groups of the grouper, then pooled, with ``include_grouper``)."""

    def __init__(self, unknown_features: int, known_features: int, mlp: Sequence[int],
                 include_t: bool = False, t_features: int = 0,
                 include_condition: bool = False, condition_features: int = 0,
                 include_second_condition: bool = False,
                 second_condition_features: int = 0, bn: bool = True,
                 bn_first: bool = False, bias: bool = False, res_connect: bool = False,
                 first_conv_features: Optional[int] = None, include_grouper: bool = False,
                 radius: float = 0.0, nsample: int = 32, use_xyz: bool = True,
                 include_abs_coordinate: bool = True,
                 include_center_coordinate: bool = False, neighbor_def: str = "radius",
                 activation: str = "relu", dtype: Optional[torch.dtype] = None,
                 record_neighbor_stats: bool = False):
        super().__init__()
        self._init_grouper(include_grouper, radius, nsample, use_xyz, include_abs_coordinate,
                           include_center_coordinate, neighbor_def, record_neighbor_stats)
        self.include_t = include_t
        self.include_condition = include_condition
        self.include_second_condition = include_second_condition
        self.ConditionedMLP_0 = ConditionedMLP(
            self._mlp_in(int(known_features) + int(unknown_features)), mlp, include_t=include_t,
            t_features=t_features, include_condition=include_condition,
            condition_features=condition_features,
            include_second_condition=include_second_condition,
            second_condition_features=second_condition_features, bn=bn,
            bn_first=bn_first, bias=bias, first_conv_features=first_conv_features,
            res_connect=res_connect, activation=activation, dtype=dtype,
        )

    def forward(self, unknown, known, unknown_feats, known_feats, t_emb=None,
                condition_emb=None, second_condition_emb=None, pooling: str = "max",
                fused_gather: bool = False):
        if known is not None:
            dist, idx = three_nn(unknown, known)
            interpolated = three_interpolate(known_feats, idx, inverse_distance_weights(dist))
        else:
            interpolated = known_feats.expand(
                known_feats.shape[0], unknown.shape[1], known_feats.shape[-1]
            )
        new_features = (
            torch.cat([interpolated, unknown_feats], dim=-1)
            if unknown_feats is not None else interpolated
        )
        if self.include_grouper:
            h, counts = self._group(unknown, new_features, fused_gather)
        else:
            h = new_features[:, :, None, :]  # K = 1
        h = self.ConditionedMLP_0(
            h,
            t_emb=t_emb if self.include_t else None,
            condition_emb=condition_emb if self.include_condition else None,
            second_condition_emb=(
                second_condition_emb if self.include_second_condition else None
            ),
        )
        if self.include_grouper:
            return pool_features(h, counts, pooling)
        return h[:, :, 0, :]


class KnnFeaturePropagation(_Grouper, nn.Module):
    """kNN feature propagation (the shipped configs' use_knn_FP, K=8):
    group_knn (+11 position/distance channels) -> mlp1 (+class condition) ->
    attention (query = skip features) or pool -> concat skip + xyz ->
    mlp2 (+t, +global condition).  With ``include_grouper`` the concat of
    interpolated and skip features is grouped over the unknown points
    instead of taking xyz, and mlp2's output is pooled."""

    def __init__(self, unknown_features: int, known_features: int,
                 mlp1: Sequence[int], mlp2: Sequence[int], k: int,
                 include_t: bool = False, t_features: int = 0,
                 include_condition: bool = False, condition_features: int = 0,
                 include_second_condition: bool = False,
                 second_condition_features: int = 0, bn: bool = True,
                 bn_first: bool = False, bias: bool = False, res_connect: bool = False,
                 include_grouper: bool = False, radius: float = 0.0, nsample: int = 32,
                 use_xyz: bool = True, include_abs_coordinate: bool = True,
                 include_center_coordinate: bool = False, neighbor_def: str = "radius",
                 activation: str = "relu",
                 use_attention: bool = False, attention_bn: bool = True,
                 attention_transform_out: bool = True,
                 attention_last_activation: bool = True,
                 use_global_attention: bool = False, global_attention_bn: bool = True,
                 global_attention_last_activation: bool = True,
                 dtype: Optional[torch.dtype] = None, record_neighbor_stats: bool = False):
        super().__init__()
        if use_global_attention and include_grouper:
            raise ValueError("global attention after a feature propagation needs "
                             "include_grouper off")
        self._init_grouper(include_grouper, radius, nsample, use_xyz, include_abs_coordinate,
                           include_center_coordinate, neighbor_def, record_neighbor_stats)
        self.k = int(k)
        self.include_t = include_t
        self.include_condition = include_condition
        self.include_second_condition = include_second_condition
        self.use_attention = use_attention
        self.dtype = dtype
        uw, kw = int(unknown_features), int(known_features)
        common = dict(bn=bn, bn_first=bn_first, bias=bias, res_connect=res_connect,
                      activation=activation, dtype=dtype)
        self.ConditionedMLP_0 = ConditionedMLP(
            kw + 11, mlp1, include_condition=include_second_condition,
            condition_features=second_condition_features, **common,
        )
        if use_attention:
            self.AttentionPool_0 = AttentionPool(
                uw, kw + 11, mlp1[-1], mlp1[-1], attention_bn=attention_bn,
                transform_grouped_feat_out=attention_transform_out,
                last_activation=attention_last_activation, dtype=dtype,
            )
        # [interpolated, skip] grouped, or with xyz attached
        mlp2_in = self._mlp_in(int(mlp1[-1]) + uw) + (0 if include_grouper else 3)
        self.ConditionedMLP_1 = ConditionedMLP(
            mlp2_in, mlp2, include_t=include_t, t_features=t_features,
            include_condition=include_condition, condition_features=condition_features,
            **common,
        )
        self.use_global_attention = use_global_attention
        if use_global_attention:
            self.GlobalSelfAttention_0 = GlobalSelfAttention(
                mlp2[-1] + 3, mlp2[-1], attention_bn=global_attention_bn,
                last_activation=global_attention_last_activation,
            )

    def fused_knn_eligible(self, unknown, known, known_feats, fused_knn: bool) -> bool:
        """The sites the fused kNN group serves (the JAX package's rule for
        its windowed kernel, table width included)."""
        return (
            fused_knn
            and not self.include_grouper
            and known is not None
            and known_feats is not None
            and self.dtype is not None
            and known.shape[1] >= FUSED_MIN_SUPPORT
            and unknown.shape[1] % FUSED_QUERY_MULTIPLE == 0
            and self.k <= known.shape[1]
            and 8 + known_feats.shape[-1] <= KNN_FUSED_MAX_TABLE
        )

    def forward(self, unknown, known, unknown_feats, known_feats, t_emb=None,
                condition_emb=None, second_condition_emb=None, pooling: str = "max",
                fused_attention: bool = False, fused_knn: bool = False,
                packed: bool = False, fused_gather: bool = False):
        if known is not None:
            grouped = group_knn_features(
                unknown, known, known_feats, min(self.k, known.shape[1]),
                lossy_features=self.dtype is not None,
                fused=self.fused_knn_eligible(unknown, known, known_feats, fused_knn),
            )
            interpolated = _mlp_and_pool(
                self.ConditionedMLP_0, self.AttentionPool_0 if self.use_attention else None,
                grouped, "all", unknown_feats, pooling, self.dtype, fused_attention, packed,
                condition_emb=(
                    second_condition_emb if self.include_second_condition else None
                ),
            )
        else:
            interpolated = known_feats.expand(
                known_feats.shape[0], unknown.shape[1], known_feats.shape[-1]
            )
        pos = unknown
        if self.dtype is not None:
            # mlp2 computes in bf16 anyway: concatenating bf16 parts keeps the
            # skip concat in bf16 with identical values
            interpolated = interpolated.to(self.dtype)
            if unknown_feats is not None:
                unknown_feats = unknown_feats.to(self.dtype)
            pos = unknown.to(self.dtype)
        parts = [interpolated] + ([unknown_feats] if unknown_feats is not None else [])
        if self.include_grouper:
            h, counts = self._group(unknown, _cat_all(parts), fused_gather)
        else:
            h = _cat_all(parts + [pos])[:, :, None, :]
        h = self.ConditionedMLP_1(
            h,
            t_emb=t_emb if self.include_t else None,
            condition_emb=condition_emb if self.include_condition else None,
        )
        if self.include_grouper:
            return pool_features(h, counts, pooling)
        h = h[:, :, 0, :]
        if self.use_global_attention:
            h = self.GlobalSelfAttention_0(_cat_all([h, unknown]))
        return h


class FeatureTransfer(nn.Module):
    """Feature Transfer (FT): map condition-branch features onto the noisy
    branch's positions: QueryAndGroup with subset=False -> MLP -> attention
    pool with query = the features already at the target points.
    ``pregrouped = (grouped, counts)`` takes a grouping computed elsewhere
    (the fused kernel serves an encoder/decoder FT pair with one launch)."""

    def __init__(self, support_features: int, query_features: int, mlp: Sequence[int],
                 radius: float, k: int, use_xyz: bool = True,
                 include_abs_coordinate: bool = True,
                 include_center_coordinate: bool = False, bn: bool = True,
                 bn_first: bool = True, bias: bool = True, res_connect: bool = True,
                 first_conv_features: Optional[int] = None, neighbor_def: str = "radius",
                 activation: str = "relu", use_attention: bool = False,
                 attention_bn: bool = True, attention_transform_out: bool = True,
                 attention_last_activation: bool = True,
                 dtype: Optional[torch.dtype] = None, record_neighbor_stats: bool = False):
        super().__init__()
        self.record_neighbor_stats = record_neighbor_stats
        self.radius, self.k = float(radius), int(k)
        self.use_xyz, self.include_abs = use_xyz, include_abs_coordinate
        self.include_center = include_center_coordinate
        self.neighbor_def = neighbor_def
        self.use_attention = use_attention
        self.dtype = dtype
        gw = grouped_width(int(support_features), use_xyz, include_abs_coordinate,
                           include_center_coordinate)
        self.ConditionedMLP_0 = ConditionedMLP(
            gw, mlp, bn=bn, bn_first=bn_first, bias=bias,
            first_conv_features=first_conv_features, res_connect=res_connect,
            activation=activation, dtype=dtype,
        )
        if use_attention:
            self.AttentionPool_0 = AttentionPool(
                int(query_features), gw, mlp[-1], mlp[-1], attention_bn=attention_bn,
                transform_grouped_feat_out=attention_transform_out,
                last_activation=attention_last_activation, dtype=dtype,
            )

    def forward(self, xyz, features, new_xyz, query_feats=None, subset: bool = False,
                pooling: str = "max", pregrouped=None, fused_gather: bool = False,
                fused_attention: bool = False, packed: bool = False):
        if pregrouped is not None:
            grouped, counts = pregrouped
        else:
            grouped, counts = query_and_group(
                xyz, new_xyz, features, radius=self.radius, nsample=self.k,
                neighbor_def=self.neighbor_def, use_xyz=self.use_xyz,
                include_abs_coordinate=self.include_abs,
                include_center_coordinate=self.include_center, subset=subset,
                fused_gather=fused_gather,
            )
        _sow_count_hist(self, counts, self.k)
        if self.use_attention:
            assert query_feats is not None
        return _mlp_and_pool(
            self.ConditionedMLP_0, self.AttentionPool_0 if self.use_attention else None,
            grouped, counts, query_feats, pooling, self.dtype, fused_attention, packed)
