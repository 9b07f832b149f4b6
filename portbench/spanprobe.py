#!/usr/bin/env python3
"""The program's spans over one cell's window, on one NVIDIA GPU.

    python3 portbench/spanprobe.py --workload <cell> --seed <n> --seconds <s>
                                   [--rounds 3] [--cost-seconds 10]

Sets the cell up as ``run.py`` does (the kernels, the seed's frame pool,
the warm-up calls), then:

1. the spans' cost: ``--rounds`` pairs of untraced windows of
   ``--cost-seconds`` each, one with spans off and one with spans on (the
   order alternates), each from the window's first call: pairs/s of each;
2. a window of ``--seconds`` with spans on, ``spantrace.run_window``'s,
   whose calls from the middle on (the traffic mix's ``trace_pairs``) run
   under the profiler: the span clock's skew, ``spantrace``'s readings, the
   device idle share and device operations an iteration over the same
   profiled calls;
3. ``--rounds`` untraced windows with spans on after the profiler has
   stopped, and the median call latency of each window and of the traced
   window's calls before and after the profiled ones: what the profiler
   leaves behind;
4. the host's cost of one span, off and on, and of one counter add.

Prints one JSON line. Checks no registration against the reference.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)


def span_cost_ns(n: int = 100_000) -> dict:
    """Least ns per span (off, on) and per counter add over 3 rounds of n."""
    import timeit

    from icp_tpu_torch.runtime import timing

    def one():
        with timing.span("probe"):
            pass

    out = {}
    for on in (False, True):
        timing.record_spans(on)
        key = "span_on" if on else "span_off"
        out[key] = min(timeit.repeat(one, number=n, repeat=3)) / n * 1e9
        timing.record_spans(False)
        timing.take_spans()
    out["count"] = min(timeit.repeat(lambda: timing.count("probe"), number=n, repeat=3)) / n * 1e9
    return out


def probe(cell: dict, seed: int, seconds: float, rounds: int, cost_seconds: float) -> dict:
    import torch

    from icp_tpu_torch.runtime import timing
    from portbench import devtrace, scene, spantrace
    from portbench.drive import System, first_call, run_window
    from portbench.run import WARM_CALLS, load_kernels

    config, traffic = cell["config"], cell["traffic"]
    torch.set_num_threads(2)
    out = {"workload": cell["workload"]["name"], "seed": seed, **load_kernels()}
    with torch.no_grad():
        pool = scene.make_pool(seed, config, traffic["pool_frames"], "cuda")
        system = System(config, traffic, pool["frames"], first_call(traffic, seed))
        for n in range(WARM_CALLS):
            system.call(n)
        torch.cuda.synchronize()
        cost = {"off": [], "on": [], "on_after_profiler": []}
        p50 = {"before_profiler": [], "after_profiler": []}

        def untraced(on: bool, key: str):
            timing.record_spans(on)
            w, _ = run_window(system, cost_seconds)
            timing.record_spans(False)
            timing.take_spans()
            cost[key].append(len(w.rows) / w.seconds)
            return statistics.median(w.latencies_s) * 1e3

        for r in range(rounds):
            for on in ((False, True) if r % 2 == 0 else (True, False)):
                p50["before_profiler"].append(untraced(on, "on" if on else "off"))
        trace_calls = traffic["trace_pairs"] // traffic["batch"]
        t0 = time.perf_counter()
        w, prof = spantrace.run_window(system, seconds, trace_calls)
        wall = time.perf_counter() - t0
        w.trace = devtrace.read(prof)
        del prof
        calls = w.spans.profiled_calls
        lat = w.latencies_s
        p50.update(window_before_profiled=statistics.median(lat[:calls.start]) * 1e3,
                   window_after_profiled=statistics.median(lat[calls.stop:]) * 1e3)
        for _ in range(rounds):
            p50["after_profiler"].append(untraced(True, "on_after_profiler"))
        out.update(pairs_per_s_spans=cost, call_p50_ms=p50, span_cost_ns=span_cost_ns())
    rec = w.spans
    traced_k = sum(int(r[8]) for c in w.calls[calls.start:calls.stop] for r in c[3])
    out.update(
        pairs_per_s=len(w.rows) / w.seconds,
        window_wall_s=wall,
        span_clock_skew_us=(None if spantrace.clock_skew_ns(rec) is None
                            else spantrace.clock_skew_ns(rec) / 1e3),
        span_clock_bracket_us=(rec.anchor_ns[1] - rec.anchor_ns[0]) / 1e3,
        counters_before=rec.before, counters_profiled=rec.profiled,
        counters_total=rec.total, profiled_calls=[calls.start, calls.stop],
        spans=len(rec.spans), registrations=len(w.calls), traced_calls=trace_calls,
        iterations=sum(w.ks), traced_iterations=traced_k,
        device_idle_share=100.0 * (1.0 - w.trace.busy_s / w.trace.window_s),
        device_events_per_iteration=len(w.trace.device) / traced_k,
        idle_gaps=w.trace.idle_gaps(),
        **{read.__name__: read(w) for read in (
            spantrace.step_host_ms, spantrace.launches_per_step,
            spantrace.chunk_tail_share, spantrace.host_read_wait_ms,
            spantrace.index_ms, spantrace.idle_by_span)},
        device=torch.cuda.get_device_name())
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--cost-seconds", type=float, default=10.0)
    args = parser.parse_args(argv)

    import torch

    from portbench import spec

    if not torch.cuda.is_available():
        print("spanprobe: needs a CUDA device", file=sys.stderr)
        return 2
    out = probe(spec.cell(args.workload), args.seed, args.seconds, args.rounds,
                args.cost_seconds)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
