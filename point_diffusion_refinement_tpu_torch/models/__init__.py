from .attention import AttentionPool, GlobalSelfAttention
from .common import (
    ConditionedMLP,
    Dense,
    GroupNorm,
    PartialGroupNorm,
    SharedMLP,
    pool_features,
    swish,
)
from .condition_net import CondFeatures, PointNet2CloudCondition
from .grouping import group_all, group_knn_features, query_and_group
from .modules import (
    FeaturePropagation,
    FeatureTransfer,
    KnnFeaturePropagation,
    SetAbstraction,
    collect_neighbor_stats,
)
from .pnet import Pnet2Stage
from .pointwise_net import ConcatSquashLinear, PointwiseNet
from .pvcnn import PVCNN2Base, PVCNN2Completion
from .upsample import point_upsample

__all__ = [
    "AttentionPool",
    "ConcatSquashLinear",
    "CondFeatures",
    "ConditionedMLP",
    "Dense",
    "FeaturePropagation",
    "FeatureTransfer",
    "GlobalSelfAttention",
    "GroupNorm",
    "KnnFeaturePropagation",
    "PVCNN2Base",
    "PVCNN2Completion",
    "PartialGroupNorm",
    "Pnet2Stage",
    "PointNet2CloudCondition",
    "PointwiseNet",
    "SetAbstraction",
    "SharedMLP",
    "collect_neighbor_stats",
    "group_all",
    "group_knn_features",
    "point_upsample",
    "pool_features",
    "query_and_group",
    "swish",
]
