from .attention import AttentionPool
from .common import ConditionedMLP, Dense, PartialGroupNorm, SharedMLP, pool_features, swish
from .condition_net import CondFeatures, PointNet2CloudCondition
from .grouping import group_all, group_knn_features, query_and_group
from .modules import FeaturePropagation, FeatureTransfer, KnnFeaturePropagation, SetAbstraction
from .pnet import Pnet2Stage

__all__ = [
    "AttentionPool",
    "CondFeatures",
    "ConditionedMLP",
    "Dense",
    "FeaturePropagation",
    "FeatureTransfer",
    "KnnFeaturePropagation",
    "PartialGroupNorm",
    "Pnet2Stage",
    "PointNet2CloudCondition",
    "SetAbstraction",
    "SharedMLP",
    "group_all",
    "group_knn_features",
    "pool_features",
    "query_and_group",
    "swish",
]
