"""Multi-card / multi-host registration demo (port of
``examples/multichip.py``).

One process per rank. Builds a (dp, mp) mesh over the world's ranks (one
card each) and runs the sharded registration on the synthetic flagship
pair; rank 0 prints the report. Under torchrun the rendezvous, world size
and rank come from its environment; dp spans hosts, mp stays on a host::

    torchrun --nproc-per-node 4 -m icp_tpu_torch.examples.multichip --dp 2 --mp 2

With no launcher it runs as a world of one. ``--cpu`` computes on the CPU
over gloo, which needs no card::

    torchrun --nproc-per-node 2 -m icp_tpu_torch.examples.multichip --dp 2 --cpu

:func:`rank_task` runs it as a ``call`` task of
``icp_tpu_torch.parallel.dryrun.launch_world``.
"""

from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist


def main(argv=None):
    """Run the demo on this rank; returns the registration's ICPState
    (every rank holds the same)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dp", type=int, default=0, help="0 = all devices / mp")
    ap.add_argument("--mp", type=int, default=1)
    ap.add_argument("--m", type=int, default=16384)
    ap.add_argument("--n-r", type=int, default=256)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from icp_tpu_torch import ICPConfig, ICPParams
    from icp_tpu_torch.parallel.distributed import initialize_multihost, make_global_mesh
    from icp_tpu_torch.parallel.sharded import make_sharded_register
    from icp_tpu_torch.runtime.timing import CPUTimer, block_until_ready
    from icp_tpu_torch.sensors.synthetic import synthetic_pair

    owns_group = not dist.is_initialized()
    initialize_multihost(backend="gloo" if args.cpu else None)
    rank, world = dist.get_rank(), dist.get_world_size()
    device = torch.device("cpu")
    if not args.cpu:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    try:
        mesh = make_global_mesh(args.dp or None, args.mp, device=device)
        n_dp = mesh.shape["dp"]
        if rank == 0:
            print(f"mesh: dp={n_dp} mp={args.mp} over {world} devices, "
                  f"{world} process(es)")

        config = ICPConfig(m=args.m, n_r=args.n_r, estimate_scale=False)
        params = ICPParams(alpha=2e2)
        fixed_np, moving_np = synthetic_pair(args.m)

        run = make_sharded_register(mesh, config)
        with CPUTimer() as t:
            state = block_until_ready(run(torch.from_numpy(fixed_np).to(device),
                                          torch.from_numpy(moving_np).to(device), params))
        if rank == 0:
            print(f"registered in k={int(state.k)} iterations, {t.span_ms:.1f} ms "
                  f"(incl. compile on first run)")
            print("T =", state.T.cpu().numpy())
        return state
    finally:
        if owns_group:
            dist.destroy_process_group()


def rank_task(task: dict, mesh) -> dict:
    """``main(task["argv"])`` as a ``call`` task of
    :func:`icp_tpu_torch.parallel.dryrun.launch_world`: the state's fields."""
    st = main(task["argv"])
    return {f: getattr(st, f) for f in ("q", "t", "s", "qk", "tk", "sk", "k")}


if __name__ == "__main__":
    main()
