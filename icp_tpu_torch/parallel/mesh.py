"""Process meshes and their collectives (port of ``icp_tpu.parallel.mesh``).

The JAX package runs one ``shard_map`` over a (dp, mp) device mesh from one
controller. Here every rank is one process on one device (SPMD): each rank
calls the same entry point with the same full inputs, takes its rows and its
bins from its mesh coordinates, and ends with the same replicated result.
Rank r sits at (dp, mp) = divmod(r, n_mp), the row-major reshape of the JAX
mesh. Axes:

  * ``dp``: data parallel over points (queries, residuals, edges,
    landmarks);
  * ``mp``: model parallel over the search structure (representatives and
    their bins).

``psum`` is ``all_reduce(SUM)`` and ``pmin`` / ``pmax`` are
``all_reduce(MIN / MAX)`` over the ``dp`` group, the ``mp`` group or the
whole mesh. An all-reduce hands every rank the same bits, so the replicated
computation that follows it stays bit for bit the same on every rank: the
sharded loops' accept / reject and convergence flags depend on that.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.utils._pytree import tree_flatten, tree_unflatten

DP_AXIS = "dp"
MP_AXIS = "mp"


def _axes(axis_name) -> tuple[str, ...]:
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    for name in names:
        if name not in (DP_AXIS, MP_AXIS):
            raise ValueError(f"unknown mesh axis {name!r}")
    return names


class Mesh:
    """A (dp, mp) mesh over every rank of the initialized default process
    group, with this rank's coordinates and device.

    Attributes:
      shape: {"dp": n_dp, "mp": n_mp}.
      dp_index, mp_index: this rank's coordinates.
      device: the device this rank computes on.
    """

    def __init__(self, n_dp: int, n_mp: int, device):
        self.device = torch.device(device)
        self.shape = {DP_AXIS: n_dp, MP_AXIS: n_mp}
        self.device_mesh = init_device_mesh(self.device.type, (n_dp, n_mp),
                                            mesh_dim_names=(DP_AXIS, MP_AXIS))
        self.dp_index, self.mp_index = divmod(dist.get_rank(), n_mp)
        if tuple(self.device_mesh.get_coordinate()) != (self.dp_index, self.mp_index):
            raise RuntimeError(f"rank {dist.get_rank()} sits at "
                               f"{self.device_mesh.get_coordinate()} of the device mesh, "
                               f"not at {(self.dp_index, self.mp_index)}")

    def size(self, axis_name) -> int:
        n = 1
        for name in _axes(axis_name):
            n *= self.shape[name]
        return n

    def group(self, axis_name):
        """The process group of ``axis_name`` (a name or a tuple of names)."""
        names = set(_axes(axis_name))
        if names == {DP_AXIS, MP_AXIS}:
            return dist.group.WORLD
        return self.device_mesh.get_group(names.pop())

    def _reduce(self, x: torch.Tensor, axis_name, op) -> torch.Tensor:
        if self.size(axis_name) == 1:
            return x
        y = x.clone()
        dist.all_reduce(y, op=op, group=self.group(axis_name))
        return y

    def psum(self, x: torch.Tensor, axis_name) -> torch.Tensor:
        return self._reduce(x, axis_name, dist.ReduceOp.SUM)

    def pmin(self, x: torch.Tensor, axis_name) -> torch.Tensor:
        return self._reduce(x, axis_name, dist.ReduceOp.MIN)

    def pmax(self, x: torch.Tensor, axis_name) -> torch.Tensor:
        return self._reduce(x, axis_name, dist.ReduceOp.MAX)


def make_mesh(n_dp: int, n_mp: int = 1, device="cuda") -> Mesh:
    """A (dp, mp) mesh over the initialized process group: every rank calls
    it. The mesh holds every rank, one device each, so the world size must
    be n_dp * n_mp."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.distributed."
                           "initialize_multihost first")
    need, have = n_dp * n_mp, dist.get_world_size()
    if have < need:
        raise ValueError(f"need {need} devices, have {have}")
    if have > need:
        raise ValueError(f"the mesh ({n_dp}, {n_mp}) must hold every one of "
                         f"the {have} ranks")
    return Mesh(n_dp, n_mp, device)


def replicated(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` whole on this rank's device (every rank holds all of it)."""
    return x.to(mesh.device)


def shard_points(mesh: Mesh, points: torch.Tensor) -> torch.Tensor:
    """This rank's dp slice of (n, ...) rows (replicated over mp)."""
    n_dp = mesh.shape[DP_AXIS]
    if points.shape[0] % n_dp != 0:
        raise ValueError(f"{points.shape[0]} rows must divide evenly over dp={n_dp}")
    per = points.shape[0] // n_dp
    return points[mesh.dp_index * per:(mesh.dp_index + 1) * per].to(mesh.device)


def psum_pytree(tree, axis_name, mesh: Mesh):
    """psum every tensor leaf of a pytree over the named axis (or axes), as
    one all-reduce of the leaves laid end to end (one dtype)."""
    leaves, spec = tree_flatten(tree)
    if mesh.size(axis_name) == 1 or not leaves:
        return tree
    flat = mesh.psum(torch.cat([x.reshape(-1) for x in leaves]), axis_name)
    out, at = [], 0
    for x in leaves:
        out.append(flat[at:at + x.numel()].reshape(x.shape))
        at += x.numel()
    return tree_unflatten(out, spec)
