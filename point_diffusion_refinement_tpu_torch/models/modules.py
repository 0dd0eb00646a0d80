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
``grouping.fused_ball_gather``.  The global
self-attention option, the merged first-layer matmuls and the grouper
inside feature propagation are not ported (all off in the shipped
configs); asking for them raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..ops.ball_group import ball_group, ball_group_train
from ..ops.interpolate import inverse_distance_weights, three_interpolate, three_nn
from ..ops.sampling import furthest_point_sample_and_gather, gather_points
from .attention import AttentionPool
from .common import ConditionedMLP, pool_features
from .grouping import group_knn_features, grouped_width, query_and_group

# The CUDA kernel takes any size; these gates keep the JAX package's routing
# so that the fused kernel serves exactly the call sites its TPU kernel does.
FUSED_MIN_SUPPORT = 1024
FUSED_QUERY_MULTIPLE = 128
# the TPU kernel's packed table holds 8 position lanes + the features in 128
TRAIN_FUSED_MAX_TABLE = 128


def _unsupported(flag: bool, what: str) -> None:
    if flag:
        raise NotImplementedError(f"{what} is not ported yet")


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
                 use_global_attention: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        _unsupported(use_global_attention, "GlobalSelfAttention")
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
                fused_sa: bool = False):
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
        out = self.ConditionedMLP_0(
            grouped,
            t_emb=t_emb if self.include_t else None,
            condition_emb=condition_emb if self.include_condition else None,
            second_condition_emb=(
                second_condition_emb if self.include_second_condition else None
            ),
        )
        if self.use_attention:
            query = (features[:, : self.npoint] if fps_ordered
                     else gather_points(features, fps_idx))
            new_features = self.AttentionPool_0(query, grouped, out, counts)
        else:
            new_features = pool_features(out, counts, pooling)
        # new_xyz stays in FPS selection order: the next level's
        # fps_ordered=True relies on it
        return new_xyz, new_features


class FeaturePropagation(nn.Module):
    """3-NN inverse-distance interpolation + skip concat + conditioned MLP."""

    def __init__(self, unknown_features: int, known_features: int, mlp: Sequence[int],
                 include_t: bool = False, t_features: int = 0,
                 include_condition: bool = False, condition_features: int = 0,
                 include_second_condition: bool = False,
                 second_condition_features: int = 0, bn: bool = True,
                 bn_first: bool = False, bias: bool = False, res_connect: bool = False,
                 first_conv_features: Optional[int] = None, include_grouper: bool = False,
                 activation: str = "relu", dtype: Optional[torch.dtype] = None):
        super().__init__()
        _unsupported(include_grouper, "the feature-propagation grouper")
        self.include_t = include_t
        self.include_condition = include_condition
        self.include_second_condition = include_second_condition
        self.ConditionedMLP_0 = ConditionedMLP(
            int(known_features) + int(unknown_features), mlp, include_t=include_t,
            t_features=t_features, include_condition=include_condition,
            condition_features=condition_features,
            include_second_condition=include_second_condition,
            second_condition_features=second_condition_features, bn=bn,
            bn_first=bn_first, bias=bias, first_conv_features=first_conv_features,
            res_connect=res_connect, activation=activation, dtype=dtype,
        )

    def forward(self, unknown, known, unknown_feats, known_feats, t_emb=None,
                condition_emb=None, second_condition_emb=None, pooling: str = "max"):
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
        h = self.ConditionedMLP_0(
            new_features[:, :, None, :],
            t_emb=t_emb if self.include_t else None,
            condition_emb=condition_emb if self.include_condition else None,
            second_condition_emb=(
                second_condition_emb if self.include_second_condition else None
            ),
        )
        return h[:, :, 0, :]


class KnnFeaturePropagation(nn.Module):
    """kNN feature propagation (the shipped configs' use_knn_FP, K=8):
    group_knn (+11 position/distance channels) -> mlp1 (+class condition) ->
    attention (query = skip features) or pool -> concat skip + xyz ->
    mlp2 (+t, +global condition)."""

    def __init__(self, unknown_features: int, known_features: int,
                 mlp1: Sequence[int], mlp2: Sequence[int], k: int,
                 include_t: bool = False, t_features: int = 0,
                 include_condition: bool = False, condition_features: int = 0,
                 include_second_condition: bool = False,
                 second_condition_features: int = 0, bn: bool = True,
                 bn_first: bool = False, bias: bool = False, res_connect: bool = False,
                 include_grouper: bool = False, activation: str = "relu",
                 use_attention: bool = False, attention_bn: bool = True,
                 attention_transform_out: bool = True,
                 attention_last_activation: bool = True,
                 use_global_attention: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        _unsupported(include_grouper, "the feature-propagation grouper")
        _unsupported(use_global_attention, "GlobalSelfAttention")
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
        self.ConditionedMLP_1 = ConditionedMLP(
            int(mlp1[-1]) + uw + 3, mlp2, include_t=include_t, t_features=t_features,
            include_condition=include_condition, condition_features=condition_features,
            **common,
        )

    def forward(self, unknown, known, unknown_feats, known_feats, t_emb=None,
                condition_emb=None, second_condition_emb=None, pooling: str = "max"):
        if known is not None:
            grouped = group_knn_features(
                unknown, known, known_feats, min(self.k, known.shape[1]),
                lossy_features=self.dtype is not None,
            )
            out1 = self.ConditionedMLP_0(
                grouped,
                condition_emb=(
                    second_condition_emb if self.include_second_condition else None
                ),
            )
            if self.use_attention:
                interpolated = self.AttentionPool_0(unknown_feats, grouped, out1, "all")
            else:
                interpolated = pool_features(out1, "all", pooling)
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
        parts.append(pos)
        dt = parts[0].dtype
        for p in parts[1:]:
            dt = torch.promote_types(dt, p.dtype)
        h = torch.cat([p.to(dt) for p in parts], dim=-1)[:, :, None, :]
        h = self.ConditionedMLP_1(
            h,
            t_emb=t_emb if self.include_t else None,
            condition_emb=condition_emb if self.include_condition else None,
        )
        return h[:, :, 0, :]


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
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
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
                pooling: str = "max", pregrouped=None, fused_gather: bool = False):
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
        out = self.ConditionedMLP_0(grouped)
        if self.use_attention:
            assert query_feats is not None
            return self.AttentionPool_0(query_feats, grouped, out, counts)
        return pool_features(out, counts, pooling)
