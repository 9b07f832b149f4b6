"""The per-rank entry of the sharded paths and the launcher of a world of
ranks (the port's counterpart of ``__graft_entry__.dryrun_multichip``).

A world is one process per rank. :func:`launch_world` writes a job (a mesh
shape, a device and a list of tasks) to a directory, starts every rank as
``python -m icp_tpu_torch.parallel.dryrun`` with torchrun's variables
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) and waits for
all of them within one deadline, killing the world if it passes. Each rank
joins the process group
(:func:`~icp_tpu_torch.parallel.distributed.initialize_multihost`, with its
own rendezvous and collective timeout), builds the mesh, runs every task
and saves what it computed, with its kernel launches and walls, to
``rank<r>.pt``. A rank that raises exits non-zero, and the launcher raises
with the failed ranks' logs.

Tasks (dicts; ``name`` keys the result):
  * ``register``: ``make_sharded_register(mesh, config)(fixed, moving,
    params)``; the result holds the state's fields.
  * ``optimize`` / ``optimize_pcg``: the sharded pose-graph solvers on
    ``graph`` with ``kwargs``; the result holds q and t.
  * ``ba``: ``make_sharded_ba`` on ``problem`` (laid out by
    :func:`ba_shards`) with ``n_cams`` and ``kwargs``; the result holds the
    poses and points.
  * ``call``: ``fn(task, mesh)``, a function the rank can import (pickled by
    reference), returning a dict of tensors.

The ranks never compile the CUDA kernels: they load the library that the
launching process built (``kernels.native.forbid_build``), so no two
compilers write into one build directory at once.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from icp_tpu_torch.kernels import native
from icp_tpu_torch.parallel.distributed import initialize_multihost
from icp_tpu_torch.parallel.mesh import make_mesh
from icp_tpu_torch.parallel.sharded import make_sharded_register
from icp_tpu_torch.slam import bundle_adjustment as ba
from icp_tpu_torch.slam import pose_graph as pg

ROOT = Path(__file__).resolve().parent.parent.parent


def _run_task(task: dict, mesh) -> dict:
    kind = task["kind"]
    if kind == "register":
        st = make_sharded_register(mesh, task["config"])(task["fixed"], task["moving"],
                                                         task["params"])
        return {f: getattr(st, f) for f in ("q", "t", "s", "qk", "tk", "sk", "k")}
    if kind in ("optimize", "optimize_pcg"):
        make = (pg.make_sharded_optimize if kind == "optimize"
                else pg.make_sharded_optimize_pcg)
        graph = task["graph"]
        out = make(mesh, graph.q.shape[0], **task.get("kwargs", {}))(graph)
        return {"q": out.q, "t": out.t}
    if kind == "ba":
        out = ba.make_sharded_ba(mesh, task["n_cams"], **task.get("kwargs", {}))(
            task["problem"])
        return {"pose_q": out.pose_q, "pose_t": out.pose_t, "points": out.points}
    if kind == "call":
        return task["fn"](task, mesh)
    raise ValueError(f"unknown task kind {kind!r}")


def rank_main(argv=None) -> None:
    """One rank: join the world, build the mesh, run the job's tasks, save
    the results."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--job", required=True, help="job file written by launch_world")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--timeout", type=float, default=60.0,
                    help="rendezvous and collective timeout, seconds")
    args = ap.parse_args(argv)

    native.forbid_build()
    torch.set_num_threads(1)  # ranks share their host's cores
    job = torch.load(args.job, weights_only=False)
    # The rendezvous, world size and rank come from torchrun's variables.
    initialize_multihost(backend=args.backend, timeout_s=args.timeout)
    rank = dist.get_rank()
    device = torch.device(job["device"])
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    mesh = make_mesh(*job["mesh"], device)
    results = {}
    for task in job["tasks"]:
        before = native.launches()
        t0 = time.perf_counter()
        out = _run_task(task, mesh)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        results[task["name"]] = {
            "out": {k: v.cpu() for k, v in out.items()}, "wall": wall,
            "launches": native.launches() - before}
    out_dir = Path(args.job).parent
    torch.save({"rank": rank, "coords": (mesh.dp_index, mesh.mp_index),
                "device": str(device), "tasks": results}, out_dir / f"rank{rank}.pt")
    dist.destroy_process_group()


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_world(job: dict, world: int, out_dir, *, backend: str = "gloo",
                 timeout: float = 120.0, init_timeout: float = 60.0) -> list[dict]:
    """Run ``job`` on a world of ``world`` ranks and return each rank's
    results (a list indexed by rank).

    ``job``: {"mesh": (n_dp, n_mp), "device": "cpu" | "cuda", "tasks":
    [...]}. The ranks start together and must all end within ``timeout``
    seconds, else all are killed and TimeoutError is raised;
    ``init_timeout`` bounds each rank's rendezvous and collectives. Each
    rank finds the rendezvous in torchrun's variables and computes with
    one torch thread. Logs are ``out_dir/rank<r>.log``.
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in out_dir.glob("rank*.pt"):
        old.unlink()
    job_path = out_dir / "job.pt"
    torch.save(job, job_path)
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT)] + [
                   p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs = []
    try:
        for r in range(world):
            cmd = [sys.executable, "-m", "icp_tpu_torch.parallel.dryrun", "--job",
                   str(job_path), "--backend", backend, "--timeout", str(init_timeout)]
            rank_env = dict(env, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                            WORLD_SIZE=str(world), RANK=str(r))
            log = open(out_dir / f"rank{r}.log", "w")
            procs.append((subprocess.Popen(cmd, cwd=ROOT, env=rank_env, stdout=log,
                                           stderr=subprocess.STDOUT), log))
        deadline = time.monotonic() + timeout
        for p, _ in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.0))
            except subprocess.TimeoutExpired:
                raise TimeoutError(f"a world of {world} ranks missed its {timeout} s "
                                   f"deadline:\n{_logs(out_dir, range(world))}") from None
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    failed = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"ranks {failed} of a world of {world} failed:\n"
                           f"{_logs(out_dir, failed)}")
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(world)]


def ba_shards(problem, n_dp: int, max_degree: int):
    """``problem`` laid out by ``make_sharded_ba``'s contract over ``n_dp``
    ranks: the points in n_dp equal blocks, each block's observations in
    one run with block-local point indices, every run padded to the same
    length with zero-weight observations (they add nothing to any sum) of
    the block's least-observed points, none past ``max_degree``."""
    L = problem.points.shape[0]
    if L % n_dp:
        raise ValueError(f"{L} points must divide evenly over dp={n_dp}")
    lp = L // n_dp
    pt = problem.obs_point.cpu().numpy()
    order = np.argsort(pt, kind="stable")
    runs = [order[pt[order] // lp == b] for b in range(n_dp)]
    per = max(len(run) for run in runs)
    obs = [x.cpu().numpy() for x in (problem.obs_cam, problem.obs_z, problem.obs_w)]
    cam, point, z, w = [], [], [], []
    for b, run in enumerate(runs):
        local = pt[run] - b * lp
        degree = np.bincount(local, minlength=lp)
        fill = []
        for _ in range(per - len(run)):
            p = int(np.argmin(degree))
            if degree[p] >= max_degree:
                raise ValueError(f"block {b}: no point below max_degree={max_degree} "
                                 "left to pad with")
            fill.append(p)
            degree[p] += 1
        pad = len(fill)
        cam.append(np.concatenate([obs[0][run], np.zeros(pad, obs[0].dtype)]))
        point.append(np.concatenate([local, np.asarray(fill, local.dtype)]))
        z.append(np.concatenate([obs[1][run], np.zeros((pad, 3), obs[1].dtype)]))
        w.append(np.concatenate([obs[2][run], np.zeros(pad, obs[2].dtype)]))
    return ba.BAProblem(problem.pose_q, problem.pose_t, problem.points,
                     *(torch.from_numpy(np.concatenate(x)).to(problem.points.device)
                       for x in (cam, point, z, w)))


def _logs(out_dir: Path, ranks) -> str:
    return "\n".join(f"--- rank {r}\n" + (out_dir / f"rank{r}.log").read_text()[-4000:]
                     for r in ranks)


if __name__ == "__main__":
    rank_main()
