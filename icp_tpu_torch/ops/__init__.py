"""Tensor ops: 8-D distances, moments, reductions and samplers.
(The JAX package's ``ops/scan.py`` only wraps a cumulative sum: the port
calls ``torch.cumsum``. The normal estimators, which launch kernels, are
imported from ``icp_tpu_torch.ops.normals``.)"""

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
from icp_tpu_torch.ops.reduce import reduce_max, reduce_min, reduce_sum, reduce_sum_fd
from icp_tpu_torch.ops.sampling import (
    get_landmarks,
    get_representatives,
    sample_representative_indices,
    sample_representatives,
)

__all__ = [
    "metric_weights", "nearest_neighbor_brute", "pairwise_sq_dists",
    "point_sq_dists", "centroid_partials", "centroids", "compute_weights",
    "deviations", "masked_weight_sum", "s_matrix", "reduce_max", "reduce_min",
    "reduce_sum", "reduce_sum_fd", "get_landmarks", "get_representatives", "sample_representative_indices",
    "sample_representatives",
]

