"""Distributed execution over ``torch.distributed``: process meshes, the
sharded registration, multi-host initialization, failure detection and
bounded retries."""

from icp_tpu_torch.parallel.mesh import DP_AXIS, MP_AXIS, make_mesh
from icp_tpu_torch.parallel.sharded import make_sharded_register
from icp_tpu_torch.parallel.distributed import initialize_multihost, make_global_mesh
from icp_tpu_torch.parallel.resilience import device_healthy, with_retries
