"""Task functions that the tests hand the ranks of a world
(``icp_tpu_torch.parallel.dryrun``'s ``call`` tasks): each takes (task,
mesh) and returns a dict of tensors. It holds no test. The ranks import
this module as ``tests.test_torch_rank_tasks``, so it imports nothing of
JAX."""

from icp_tpu_torch.kernels import native
from icp_tpu_torch.ops.moments import masked_median_sharded
from icp_tpu_torch.parallel.distributed import local_shard
from icp_tpu_torch.parallel.mesh import DP_AXIS, MP_AXIS, shard_points


def median(task, mesh) -> dict:
    """``masked_median_sharded`` of the rank's dp slice of ``x`` (and
    ``mask``) over the whole mesh."""
    x = shard_points(mesh, task["x"])
    mask = None if task.get("mask") is None else shard_points(mesh, task["mask"])
    return {"median": masked_median_sharded(x, mask, (DP_AXIS, MP_AXIS), mesh)}


def shard(task, mesh) -> dict:
    """The rank's rows of ``x`` by ``local_shard`` and by ``shard_points``."""
    return {"local_shard": local_shard(task["x"], mesh),
            "shard_points": shard_points(mesh, task["x"])}


def load_kernels(task, mesh) -> dict:
    """``kernels.native.load_library()``, which in a rank loads the built
    library or raises."""
    native.load_library()
    return {}
