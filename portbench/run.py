#!/usr/bin/env python3
"""One run of one benchmark cell of icp_tpu_torch on one NVIDIA GPU.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The run imports the port, loads its
kernels (building them into the checkout's ``build/`` on the first run
there), makes the cell's frame pool on the card from the seed
(``scene.py``), warms the cell's own call up, and then calls the port in a
closed loop for ``--seconds`` (``drive.py``), from a place in the pool's
cycle that the seed draws. With ``--trace 1`` the window's first calls (the
traffic mix's ``trace_pairs``) run under ``torch.profiler`` and the run
reports the per-layer metrics; otherwise the end-to-end ones. After the
window it checks a sample of the window's registrations against the plain
reference (``check.py``).

Standard output: a line ``portbench host {...}`` (CPU, load, the card's
clocks and power, the compile cache, sample counts, p50 and p95, and in a traced
run the traced calls' wall against the same calls' untraced), then the
result: one JSON object, the last line. Standard error ends with the compared
numbers and their limits. Exits non-zero with no result when no card (or
fewer than the cell asks for) is there, or when jax, jaxlib, flax or
icp_tpu was loaded.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    # Run as a script, the harness's own directory comes first on the path;
    # the checkout's root must, for ``portbench`` and ``icp_tpu_torch``.
    sys.path[0] = str(ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "icp_tpu")
WARM_CALLS = 2


def loaded_forbidden(modules=None) -> list[str]:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (``icp_tpu_torch`` is not ``icp_tpu``)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def cpu_times() -> tuple[float, list[int]]:
    """(this process's CPU seconds, the machine's /proc/stat "cpu" ticks:
    user nice system idle iowait irq softirq steal)."""
    with open("/proc/stat") as f:
        ticks = [int(x) for x in f.readline().split()[1:9]]
    return time.process_time(), ticks


def cpu_share(before, after, wall_s: float) -> dict:
    """The window's CPU use: this process's CPU seconds over the wall, and
    the machine's steal and idle shares of its ticks."""
    d = [b - a for a, b in zip(before[1], after[1])]
    total = max(sum(d), 1)
    return {"process_cpu_per_wall": (after[0] - before[0]) / wall_s,
            "steal_share": d[7] / total, "idle_share": d[3] / total}


def host_record(torch) -> dict:
    """The host and the card, read beside the window."""
    rec = {"loadavg": list(os.getloadavg()), "cpu": None, "torch": torch.__version__,
           "cuda": torch.version.cuda}
    try:
        with open("/proc/cpuinfo") as f:
            rec["cpu"] = next((ln.split(":", 1)[1].strip() for ln in f
                               if ln.startswith("model name")), None)
    except OSError:
        pass
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,power.draw,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        rec["nvidia_smi"] = out.stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as exc:
        rec["nvidia_smi"] = f"unavailable: {exc}"
    return rec


def load_kernels() -> dict:
    """Load the port's kernels: a cache hit loads the library built by an
    earlier run in this checkout, a miss builds it here."""
    from icp_tpu_torch.kernels import native

    lib = native.BUILD_ROOT / native.source_digest()[:16] / "libicp_tpu_torch.so"
    hit = lib.exists()
    t0 = time.perf_counter()
    native.load_library()
    return {"cache": "hit" if hit else "miss", "load_s": time.perf_counter() - t0}


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: str,
             process_start: float = PROCESS_START) -> dict:
    """One run of a cell on ``device``: {"result": the result object without
    ``checks``, "checks": {name: {value, limit}}, "host": {...}}."""
    import torch

    from portbench import check, devtrace, scene
    from portbench.drive import System, first_call, run_window, trace_overhead
    from portbench.spec import metric_reader
    from portbench.stats import percentile

    root = cell["root"]
    config, traffic = cell["config"], cell["traffic"]
    host = {}
    phases = {}  # seconds since the process started, at the end of each
    torch.set_num_threads(2)
    if device == "cuda":
        host.update(load_kernels())
    phases["kernels"] = time.perf_counter() - process_start
    with torch.no_grad():
        pool = scene.make_pool(seed, config, traffic["pool_frames"], device)
        system = System(config, traffic, pool["frames"], first_call(traffic, seed), root)
        if device == "cuda":
            torch.cuda.synchronize()
        phases["pool"] = time.perf_counter() - process_start
        for n in range(WARM_CALLS):
            system.call(n)
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - process_start
        phases["warm"] = setup_s
        trace_calls = traffic["trace_pairs"] // traffic["batch"] if trace else 0
        before = cpu_times()
        window, prof = run_window(system, seconds, trace_calls)
        host["window_cpu"] = cpu_share(before, cpu_times(), window.seconds)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        host.update(host_record(torch) if device == "cuda" else {})
        window.setup_s = setup_s
        window.config, window.traffic = config, traffic
        window.trace = devtrace.read(prof) if prof is not None else None
        host.update(trace_overhead(window, traffic["pool_frames"] // traffic["batch"]))
        del system
        worst = check.compare(pool["frames"], window, config, seed, traffic["check_sample"],
                              root)
    correct, checks = check.judge(worst, cell["limits"])
    rows = window.rows
    failed = sum(1 for _, r in rows if not all(math.isfinite(x) for x in r.tolist()))
    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        value = metric_reader(m["name"], root)(window)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name() if device == "cuda" else device,
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct and failed == 0, "attempted": len(rows),
              "failed": failed, "metrics": metrics, "device": dev}
    if window.trace is not None:
        dev["busy_s"] = window.trace.busy_s
        dev["window_s"] = window.trace.window_s
        result["breakdown"] = {"device_ops": window.trace.top_device_ops(),
                               "idle_gaps": window.trace.idle_gaps()}
    host.update(calls=len(window.calls), pairs=len(rows), window_s=window.seconds,
                setup_phases=phases,
                latency_p50_ms=statistics.median(window.latencies_s) * 1e3,
                latency_p95_ms=percentile(window.latencies_s, 95) * 1e3,
                iterations=sum(window.ks))
    return {"result": result, "checks": checks, "host": host}


def result_line(out: dict) -> str:
    """The last line of standard output: the result object, its compared
    numbers and their limits last."""
    return json.dumps({**out["result"], "checks": out["checks"]})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from portbench import spec

    cell = spec.cell(args.workload)
    import torch

    import icp_tpu_torch  # noqa: F401  (its import is set-up, timed apart)

    imported_s = time.perf_counter() - PROCESS_START

    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    out["host"]["setup_phases"]["imports"] = imported_s
    found = loaded_forbidden()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    print("portbench host " + json.dumps(out["host"]), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(result_line(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
