from .attention_pool import (
    fused_attention_pool,
    fused_attention_pool_plain,
    prepare_attention_weights,
)
from .ball_group import ball_group, ball_group_plain, ball_group_train
from .interpolate import inverse_distance_weights, three_interpolate, three_nn
from .kernels import launch_counts, plain_ops, reset_launch_counts
from .neighbors import (
    ball_query,
    ball_query_group,
    ball_query_group_plain,
    ball_query_plain,
    count_to_mask,
    knn,
    knn_group,
    knn_group_plain,
    knn_plain,
    masked_mean,
    pairwise_sqdist,
)
from .scatter import group_scatter_add, group_scatter_add_plain
from .sampling import (
    furthest_point_sample,
    furthest_point_sample_and_gather,
    furthest_point_sample_and_gather_plain,
    furthest_point_sample_plain,
    gather_points,
    group_points,
)

__all__ = [
    "ball_group",
    "ball_group_plain",
    "ball_group_train",
    "ball_query",
    "ball_query_group",
    "ball_query_group_plain",
    "ball_query_plain",
    "count_to_mask",
    "furthest_point_sample",
    "fused_attention_pool",
    "fused_attention_pool_plain",
    "furthest_point_sample_and_gather",
    "furthest_point_sample_and_gather_plain",
    "furthest_point_sample_plain",
    "gather_points",
    "group_points",
    "group_scatter_add",
    "group_scatter_add_plain",
    "inverse_distance_weights",
    "knn",
    "knn_group",
    "knn_group_plain",
    "knn_plain",
    "launch_counts",
    "masked_mean",
    "pairwise_sqdist",
    "plain_ops",
    "prepare_attention_weights",
    "reset_launch_counts",
    "three_interpolate",
    "three_nn",
]
