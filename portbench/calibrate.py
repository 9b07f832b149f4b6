#!/usr/bin/env python3
"""The readings that the correctness limits are set from, on one GPU.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 ... [--control]
        [--stop-after N]

For each seed: the frame pool that a run of that seed makes, one cycle of
the cell's own calls to the port (the timed path, at the timed sizes), and
the compared numbers of ``check.py`` over the seed's sample (the lower
readings). With ``--stop-after N`` the port runs a planted fault instead:
it stops every registration after N iterations (as a convergence test too
loose, or a stop after the first chunk, would). With ``--control`` also the
control: the plain reference computed with TF32 matrix products put in the
program's place, compared with the reference in full float32 over the same
registrations (the upper readings). One JSON line a pool; the benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)


def cycle_window(system, traffic):
    """One pool cycle of calls, as the window makes them."""
    from portbench.drive import Window

    calls = []
    for n in range(traffic["pool_frames"] // traffic["batch"]):
        t0 = time.perf_counter()
        rows = system.call(n)
        calls.append((t0, time.perf_counter(), system.pairs(n), rows))
    return Window(calls=calls, seconds=calls[-1][1] - calls[0][0])


def control(frames, window, config: dict, seed: int, size: int, root=None) -> dict:
    """The compared numbers with the TF32 reference in the program's place."""
    from portbench import check, spec

    reference = spec.reference(config, root or spec.ROOT)
    icp = config["icp"]
    worst: dict = {}
    cache32, cache_tf32 = {}, {}
    rows = window.rows
    for idx in check.sample(window, seed, size):
        pair, _ = rows[idx]
        ctrl = reference(frames, pair, icp, 0, cache_tf32, True)
        k = ctrl["k"]
        q, t, s = ctrl["poses"][k - 1]
        row = [*q.tolist(), *t.tolist(), s, k]
        ref = reference(frames, pair, icp, k, cache32, False)
        for name, v in check.pose_gaps(row, ref).items():
            worst[name] = max(worst.get(name, 0.0), math.inf if math.isnan(v) else v)
    return worst


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", default=[])
    parser.add_argument("--stop-after", type=int, default=0)
    parser.add_argument("--control", action="store_true")
    args = parser.parse_args(argv)

    import torch

    from portbench import check, scene, spec
    from portbench.drive import System

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    config, traffic = cell["config"], cell["traffic"]
    size = traffic["check_sample"]
    for seed in args.seeds:
        with torch.no_grad():
            pool = scene.make_pool(seed, config, traffic["pool_frames"], "cuda")
            system = System(config, traffic, pool["frames"])
            if args.stop_after:
                system.cfg = dataclasses.replace(system.cfg, max_iterations=args.stop_after)
            window = cycle_window(system, traffic)
            del system
            t0 = time.perf_counter()
            out = {"seed": seed, "ks": window.ks,
                   "program": check.compare(pool["frames"], window, config, seed, size),
                   "reference_s": time.perf_counter() - t0}
            if args.control:
                out["control"] = control(pool["frames"], window, config, seed, size)
        print(json.dumps(out), flush=True)
        del pool
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
