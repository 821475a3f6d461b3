"""Point-cloud primitives (counterpart: `slide_tpu/ops/`), channels-last."""

from slide_tpu_torch.ops.chamfer import calc_cd, chamfer_parts, fscore
from slide_tpu_torch.ops.fps import (
    append_points_to_keypoints,
    fps_subsample,
    furthest_point_sample,
    sample_keypoints,
)
from slide_tpu_torch.ops.grouping import (
    count_to_mask,
    gather_points,
    group_points,
    interp_weights_from_dists,
    masked_avg_pool,
    masked_max_pool,
    pool_features,
    three_interpolate,
)
from slide_tpu_torch.ops.neighbors import (
    ball_query,
    knn_points,
    pairwise_sqdist,
    three_nn,
)

__all__ = [
    "furthest_point_sample", "sample_keypoints", "append_points_to_keypoints",
    "fps_subsample", "count_to_mask",
    "gather_points", "group_points", "interp_weights_from_dists",
    "masked_avg_pool", "masked_max_pool", "pool_features", "three_interpolate",
    "ball_query", "knn_points", "pairwise_sqdist", "three_nn",
    "calc_cd", "chamfer_parts", "fscore",
]
