"""Hand-written CUDA kernels (csrc/) with their plain PyTorch twins.

The package exports the counterparts of ``icp_tpu.kernels``' entry points:
K5 ``bin_search``, K6 ``brute_nn`` and its nearest-neighbour route
``nearest_neighbor_brute``, K3 ``bin_point_moments`` and K1′ ``rep_assign``.
"""

from icp_tpu_torch.kernels.bin_search import bin_search
from icp_tpu_torch.kernels.brute_nn import brute_nn
from icp_tpu_torch.kernels.fused_step import bin_point_moments, rep_assign
from icp_tpu_torch.ops.distance import nearest_neighbor_brute
