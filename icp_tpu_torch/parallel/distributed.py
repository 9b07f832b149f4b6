"""Process-group initialization and the global mesh (port of
``icp_tpu.parallel.distributed``).

One process per device. :func:`initialize_multihost` joins this process to
the ``torch.distributed`` world once; :func:`make_global_mesh` lays every
rank of it out as a (dp, mp) mesh, rank-major, so consecutive ranks (the
devices of one host) share a dp row and only the dp collectives (the
per-iteration psum of a few dozen floats) cross hosts.
"""

from __future__ import annotations

import datetime
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from icp_tpu_torch.parallel.mesh import DP_AXIS, Mesh, make_mesh


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, *,
                         backend: str | None = None,
                         timeout_s: float | None = None) -> None:
    """Join this process to the process group (idempotent).

    The address, world size and rank come from the arguments first, then
    from torchrun's environment (``MASTER_ADDR`` and ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``). ``backend`` defaults to NCCL where CUDA is
    available, gloo otherwise. ``timeout_s`` bounds the rendezvous and every
    collective (the torch default when None).

    With neither arguments nor environment it warns and goes on as a world
    of one process, as the JAX package does off a TPU pod. With either, any
    failure raises.
    """
    if dist.is_initialized():
        return
    env = os.environ
    address = coordinator_address
    if address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    if address is None:
        if num_processes is not None or process_id is not None:
            raise ValueError("num_processes / process_id given without a "
                             "coordinator address or MASTER_ADDR / MASTER_PORT")
        logging.getLogger("icp_tpu_torch.distributed").warning(
            "no coordinator address given and none in the environment; continuing "
            "single-process. If this is a multi-host run, pass one or set "
            "MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK.")
        # A world of one in this process's memory: no port, no network.
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                **kwargs)
        return
    try:
        world = int(num_processes if num_processes is not None else env["WORLD_SIZE"])
        # "or" would send rank 0 (falsy) to the environment.
        rank = int(process_id if process_id is not None else env["RANK"])
    except KeyError as e:
        raise ValueError(f"a coordinator address is given but {e.args[0]} is neither "
                         "passed nor set in the environment") from None
    dist.init_process_group(backend, init_method=_init_method(address),
                            world_size=world, rank=rank, **kwargs)


def make_global_mesh(n_dp: int | None = None, n_mp: int = 1,
                     device="cuda") -> Mesh:
    """The (dp, mp) mesh over every rank of the world; ``n_dp`` defaults
    to world / n_mp. Rank r sits at divmod(r, n_mp): the ranks of one host
    (consecutive under torchrun) fill a dp row, so mp stays on the host."""
    total = dist.get_world_size() if dist.is_initialized() else 1
    if n_dp is None:
        if total % n_mp != 0:
            raise ValueError(f"{total} devices not divisible by mp={n_mp}")
        n_dp = total // n_mp
    if n_dp * n_mp > total:
        raise ValueError(f"need {n_dp * n_mp} devices, have {total}")
    return make_mesh(n_dp, n_mp, device)


def local_shard(array, mesh: Mesh, axis: int = 0):
    """This rank's dp slice of a host-level array (numpy or torch) along
    ``axis``, for feeding per-rank data without every rank holding all of
    it on its device."""
    n_dp = mesh.shape[DP_AXIS]
    if array.shape[axis] % n_dp != 0:
        raise ValueError(f"axis {axis} (size {array.shape[axis]}) must divide evenly "
                         f"over dp={n_dp}")
    per = array.shape[axis] // n_dp
    sl = [slice(None)] * array.ndim
    sl[axis] = slice(mesh.dp_index * per, (mesh.dp_index + 1) * per)
    out = array[tuple(sl)]
    return np.ascontiguousarray(out) if isinstance(out, np.ndarray) else out
