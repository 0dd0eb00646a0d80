from .ball_group import ball_group, ball_group_plain
from .interpolate import inverse_distance_weights, three_interpolate, three_nn
from .kernels import launch_counts, plain_ops, reset_launch_counts
from .neighbors import (
    ball_query,
    ball_query_plain,
    count_to_mask,
    knn,
    knn_plain,
    masked_mean,
    pairwise_sqdist,
)
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
    "ball_query",
    "ball_query_plain",
    "count_to_mask",
    "furthest_point_sample",
    "furthest_point_sample_and_gather",
    "furthest_point_sample_and_gather_plain",
    "furthest_point_sample_plain",
    "gather_points",
    "group_points",
    "inverse_distance_weights",
    "knn",
    "knn_plain",
    "launch_counts",
    "masked_mean",
    "pairwise_sqdist",
    "plain_ops",
    "reset_launch_counts",
    "three_interpolate",
    "three_nn",
]
