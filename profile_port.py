#!/usr/bin/env python3
"""Where the time goes: icp_tpu_torch registrations under torch.profiler on
one NVIDIA GPU.

    python3 profile_port.py [--out build/profile.json]

For each cell, ``register`` runs twice to warm up, then once with
``max_iterations=8`` and thresholds 0 under ``torch.profiler`` (CPU and CUDA
activities), ending in ``torch.cuda.synchronize()``. Per cell it prints the
host wall time of the profiled call, the device time (the sum of the
durations of the device events: kernels, copies and fills, which run one at
a time on the one stream), their count, the idle share 1 - device / wall,
and the largest device operations by name. The estimator
``knn_normals_rbc`` at 262144 points is profiled alone too (one call).
Needs a GPU; there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent


def _profile(call, warmup: int = 2) -> dict:
    """Profile one call of ``call`` after ``warmup`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = defaultdict(float)
    n_events = 0
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            n_events += 1
            by_name[evt.name] += evt.time_range.elapsed_us() / 1e3
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_ms": device_ms, "device_events": n_events,
            "idle_share": 1.0 - device_ms / wall_ms,
            "top": [{"name": name[:90], "ms": ms} for name, ms in top]}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="build/profile.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_port: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    from __graft_entry__ import _synthetic_pair
    from chip_smoke import ALPHA, _rendered_pair
    from icp_tpu_torch import Correspondence, ICPConfig, ICPParams, Objective, register
    from icp_tpu_torch.ops.normals import knn_normals_rbc
    from icp_tpu_torch.sensors.synthetic import wavy_surface_pair

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    fast = ICPParams(alpha=ALPHA, angle_threshold_deg=0.0, translation_threshold=0.0)

    def on_card(*arrays):
        return [torch.as_tensor(a).to(dev) for a in arrays]

    flag = on_card(*_synthetic_pair(16384, seed=0))
    la, lb, _ = _rendered_pair()
    rendered = on_card(la, lb)
    wavy16 = on_card(*wavy_surface_pair(262144)[:2])
    wavy4 = on_card(*wavy_surface_pair(65536)[:2])
    cells = {
        "POINT 16384x256": (flag, ICPConfig()),
        "BRUTE POINT 16384": (flag, ICPConfig(correspondence=Correspondence.BRUTE)),
        "PLANE 16384x256 rendered": (rendered, ICPConfig(objective=Objective.PLANE,
                                                         estimate_scale=False)),
        "POINT 65536x1024": (wavy4, ICPConfig(m=65536, n_r=1024)),
        "POINT 262144x2048": (wavy16, ICPConfig(m=262144, n_r=2048)),
        "LiDAR PLANE 262144x2048 knn": (wavy16, ICPConfig(
            m=262144, n_r=2048, objective=Objective.PLANE, normal_mode="knn",
            estimate_scale=False)),
    }
    results = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "cells": {}}
    for name, ((fixed, moving), config) in cells.items():
        config = dataclasses.replace(config, max_iterations=8)
        res = _profile(lambda: register(fixed, moving, fast, config))
        results["cells"][name] = res
        print(f"{name}: wall {res['wall_ms']} ms, device {res['device_ms']} ms in "
              f"{res['device_events']} events, idle share {res['idle_share']}", flush=True)
        for row in res["top"]:
            print(f"    {row['ms']:.4f} ms  {row['name']}", flush=True)
    res = _profile(lambda: knn_normals_rbc(wavy16[0]))
    results["cells"]["knn_normals_rbc 262144"] = res
    print(f"knn_normals_rbc 262144: wall {res['wall_ms']} ms, device {res['device_ms']} ms "
          f"in {res['device_events']} events, idle share {res['idle_share']}", flush=True)
    for row in res["top"]:
        print(f"    {row['ms']:.4f} ms  {row['name']}", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(smi, flush=True)


if __name__ == "__main__":
    main()
