"""Tensor ops: 8-D distances, moments, normals, reductions, samplers and
scans."""

from icp_tpu_torch.ops.distance import (
    metric_weights,
    nearest_neighbor_brute,
    pairwise_sq_dists,
    point_sq_dists,
)
from icp_tpu_torch.ops.moments import (
    centroid_partials,
    centroids,
    compute_weights,
    deviations,
    masked_weight_sum,
    s_matrix,
)
from icp_tpu_torch.ops.normals import grid_normals, normals_for
from icp_tpu_torch.ops.reduce import reduce_max, reduce_min, reduce_sum, reduce_sum_fd
from icp_tpu_torch.ops.sampling import (
    get_landmarks,
    get_representatives,
    sample_representative_indices,
    sample_representatives,
)
from icp_tpu_torch.ops.scan import exclusive_scan, inclusive_scan

__all__ = [
    "metric_weights", "nearest_neighbor_brute", "pairwise_sq_dists",
    "point_sq_dists", "centroid_partials", "centroids", "compute_weights",
    "deviations", "masked_weight_sum", "s_matrix", "grid_normals",
    "normals_for", "reduce_max", "reduce_min", "reduce_sum", "reduce_sum_fd",
    "get_landmarks", "get_representatives", "sample_representative_indices",
    "sample_representatives", "exclusive_scan", "inclusive_scan",
]

