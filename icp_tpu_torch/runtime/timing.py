"""Timing and profiling (port of ``icp_tpu.runtime.timing``).

* :class:`CPUTimer`: a wall-clock span timer.
* :func:`device_time`: best-of-N wall time of a call, each ending in a
  synchronization of the device its output lies on.
* :func:`marginal_time`: the per-unit cost from two workload sizes, which
  removes the fixed cost of a call.
* :class:`ProfilingInfo`: named-phase aggregation with the reference's
  summary text.
* :func:`trace`: a ``torch.profiler`` trace of a block, written as a Chrome
  trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List

import torch


class CPUTimer:
    """Wall-clock span timer (reference ``clutils::CPUTimer``)."""

    def __init__(self):
        self._t0 = 0.0
        self.span_ms = 0.0

    def start(self) -> "CPUTimer":
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> float:
        self.span_ms = (time.perf_counter() - self._t0) * 1e3
        return self.span_ms

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if dataclasses.is_dataclass(x):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    elif isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _tensors(y)]
    return []


def block_until_ready(out):
    """Wait for the work that produces ``out`` (tensors, possibly nested in
    tuples, lists, dicts or dataclasses): synchronize each CUDA device its
    tensors lie on; CPU tensors are ready when the call returns."""
    for dev in {t.device for t in _tensors(out) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return out


def device_time(fn: Callable, *args, reps: int = 10, warmup: int = 1) -> float:
    """Best-of-``reps`` wall time (ms) of ``fn(*args)``, each ending in
    :func:`block_until_ready` of its output."""
    for _ in range(warmup):
        block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def marginal_time(fn_of_n: Callable[[int], Callable], n_hi: int, n_lo: int,
                  *args, reps: int = 5) -> float:
    """Per-unit marginal cost (ms) by differencing two workload sizes."""
    t_hi = device_time(fn_of_n(n_hi), *args, reps=reps)
    t_lo = device_time(fn_of_n(n_lo), *args, reps=reps)
    return (t_hi - t_lo) / (n_hi - n_lo)


@dataclass
class ProfilingInfo:
    """Named-phase latency aggregation (reference ``ProfilingInfo<N>``)."""

    label: str = "profile"
    phases: Dict[str, List[float]] = field(default_factory=dict)

    def record(self, phase: str, ms: float) -> None:
        self.phases.setdefault(phase, []).append(ms)

    @contextlib.contextmanager
    def span(self, phase: str):
        t = CPUTimer().start()
        try:
            yield
        finally:
            self.record(phase, t.stop())

    def total(self, phase: str) -> float:
        return sum(self.phases.get(phase, []))

    def mean(self, phase: str) -> float:
        xs = self.phases.get(phase, [])
        return sum(xs) / len(xs) if xs else 0.0

    def summary(self) -> str:
        lines = [f"=== {self.label} ==="]
        grand = 0.0
        for phase, xs in self.phases.items():
            tot = sum(xs)
            grand += tot
            lines.append(
                f"  {phase:28s} n={len(xs):4d}  mean={tot/len(xs):9.3f} ms"
                f"  total={tot:9.2f} ms"
            )
        lines.append(f"  {'TOTAL':28s} {'':10s} total={grand:9.2f} ms")
        return "\n".join(lines)

    def print(self) -> None:  # noqa: A003 - mirrors reference naming
        print(self.summary())


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the enclosed block with ``torch.profiler`` (the CPU, and the
    card where there is one) and write a Chrome trace (open it in
    chrome://tracing or Perfetto) as ``trace.json`` under ``log_dir``, by
    default a directory in the temporary directory. Yields ``log_dir``."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "icp_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
