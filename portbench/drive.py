"""Driving the system under test, ``icp_tpu_torch``, through one of its
entry points, in a closed loop over the cell's frame pool.

The traffic mix's ``entry`` names ``entries/<entry>.py``, whose ``Entry``
(a subclass of :class:`Entry`) is set up once and then called. Call n of a
traffic mix registers ``batch`` frame pairs (i, i + 1), i = n * batch +
lane, modulo the pool (frame i fixed, frame i + 1 moving): through
``register`` one pair a call, through ``register_batch`` ``batch`` pairs a
call. A call ends when its poses (q, t, s) and iteration counts k are on the
host; the next call starts then. The window's first call is drawn from the
run's seed (:func:`first_call`): every seed makes the same calls, from
another place in the cycle.
"""

from __future__ import annotations

import dataclasses
import enum
import time

import numpy as np
import torch

from portbench import spec

# Keys of a configuration's ``icp`` section that are not a field's name:
# the field each sets, and the field's value from the key's.
ALIASES = {
    "weighted": ("weighting", lambda on: "weighted" if on else "regular"),
    "translation_threshold_mm": ("translation_threshold", lambda mm: mm),
}


def port_settings(config: dict):
    """(ICPParams, ICPConfig) of the configuration: ``points`` is ``m``, and
    each key of its ``icp`` section sets the field of ``ICPConfig`` or
    ``ICPParams`` of its name (an enum by its value) or is one of
    :data:`ALIASES`; a field that no key sets keeps the port's default.
    Raises ValueError naming a key that sets no field, or a field set
    already."""
    import icp_tpu_torch as port

    classes = (port.ICPConfig, port.ICPParams)
    fields = {cls: {f.name: f for f in dataclasses.fields(cls)} for cls in classes}
    kwargs = {port.ICPConfig: {"m": config["points"]}, port.ICPParams: {}}
    for key, value in config["icp"].items():
        name, value = (ALIASES[key][0], ALIASES[key][1](value)) if key in ALIASES \
            else (key, value)
        cls = next((c for c in classes if name in fields[c]), None)
        if cls is None:
            raise ValueError(f"icp key {key!r} sets no field of ICPConfig or ICPParams")
        if name in kwargs[cls]:
            raise ValueError(f"icp key {key!r} sets {name}, which the configuration's "
                             "points or another key sets already")
        default = fields[cls][name].default
        if isinstance(default, enum.Enum):
            try:
                value = type(default)(value)
            except ValueError as exc:
                raise ValueError(f"icp key {key!r}: {exc}") from None
        elif cls is port.ICPConfig and type(value) is not type(default):
            raise ValueError(f"icp key {key!r} is a {type(default).__name__}, "
                             f"got {value!r}")
        kwargs[cls][name] = value
    return port.ICPParams(**kwargs[port.ICPParams]), port.ICPConfig(**kwargs[port.ICPConfig])


def first_call(traffic: dict, seed: int) -> int:
    """The call of the pool's cycle the window starts at."""
    return int(np.random.default_rng([seed, 3]).integers(
        traffic["pool_frames"] // traffic["batch"]))


def call_pairs(traffic: dict, n: int) -> list[tuple[int, int]]:
    """The (fixed, moving) frame pairs of call n."""
    pool, batch = traffic["pool_frames"], traffic["batch"]
    return [((n * batch + b) % pool, (n * batch + b + 1) % pool) for b in range(batch)]


@dataclasses.dataclass
class Window:
    """What the measured window did.

    calls: (start s, end s, pairs, rows) per call, rows (batch, 9) float64
      on the host: q (4), t (3), s, k.
    seconds: from the first call's start to the last call's end.
    traced_calls: the calls that ran under the profiler (the first ones).
    counters, traced_counters: the increments of every counter of the
      program (``icp_tpu_torch.runtime.timing.counters()``) over the window
      and over the traced calls ({} where none were traced).
    traced_spans: the program's spans (``timing.Span``) of the traced
      calls, recorded only around them ([] where none were traced).
    setup_s, config, traffic, trace: the run's set-up seconds, the cell's
      configuration and traffic mix, and the traced window
      (``devtrace.Trace``) or None; the metric readers take them from here.
    """

    calls: list
    seconds: float
    traced_calls: int = 0
    counters: dict = dataclasses.field(default_factory=dict)
    traced_counters: dict = dataclasses.field(default_factory=dict)
    traced_spans: list = dataclasses.field(default_factory=list)
    setup_s: float = 0.0
    config: dict = dataclasses.field(default_factory=dict)
    traffic: dict = dataclasses.field(default_factory=dict)
    trace: object = None

    @property
    def rows(self):
        return [(pair, row) for _, _, pairs, rows in self.calls
                for pair, row in zip(pairs, rows)]

    @property
    def ks(self) -> list[int]:
        return [int(row[8]) for _, row in self.rows]

    @property
    def latencies_s(self) -> list[float]:
        return [end - start for start, end, _, _ in self.calls]

    @property
    def traced_pairs(self) -> int:
        return sum(len(c[2]) for c in self.calls[:self.traced_calls])

    @property
    def traced_iterations(self) -> int:
        return sum(int(r[8]) for c in self.calls[:self.traced_calls] for r in c[3])


class Entry:
    """The port set up for one cell, driven through one of its entry
    points: ``entries/<entry>.py`` defines a subclass ``Entry`` whose
    ``call(n)`` runs the window's call n, call ``start + n`` of the cycle,
    and returns its (batch, 9) rows on the host. Set-up (the settings, and
    whatever the entry makes once) happens here, never in a call."""

    def __init__(self, config: dict, traffic: dict, frames: torch.Tensor,
                 start: int = 0):
        self.params, self.cfg = port_settings(config)
        self.traffic = traffic
        self.frames = frames
        self.start = start

    def pairs(self, n: int) -> list[tuple[int, int]]:
        return call_pairs(self.traffic, self.start + n)

    def call(self, n: int) -> torch.Tensor:
        raise NotImplementedError


def System(config: dict, traffic: dict, frames: torch.Tensor, start: int = 0,
           root=spec.ROOT) -> Entry:
    """The port set up for one cell through the entry its traffic mix
    names (``entries/<entry>.py`` of the checkout at ``root``)."""
    return spec.entry(traffic["entry"], root)(config, traffic, frames, start)


def counter_increments(before: dict, after: dict) -> dict:
    """Each program counter's increment from ``before`` to ``after``
    (``timing.counters()`` read at both)."""
    return {k: after.get(k, 0) - before.get(k, 0) for k in before.keys() | after.keys()}


def run_window(system: Entry, seconds: float, trace_calls: int = 0):
    """Calls from 0 on until ``seconds`` have passed since the first began;
    the first ``trace_calls`` under ``torch.profiler``, which records the
    device's operations (and the CUDA API calls that launched them) and no
    host operators, so that the traced calls run at nearly their own speed,
    and with the program's spans recorded. The traced calls are bracketed
    by two marker operations on the drained device (``devtrace.read`` takes
    the window between them). Returns (Window, the stopped profiler or
    None)."""
    from icp_tpu_torch.runtime.timing import counters, record_spans, take_spans

    prof = mark = None
    traced_counters, traced_spans = {}, []
    if trace_calls:
        mark = torch.zeros(1, device=system.frames.device)
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        torch.cuda.synchronize()
        mark.fill_(1.0)
        take_spans()
        record_spans(True)
    before = counters()
    calls, n = [], 0
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        rows = system.call(n)
        t1 = time.perf_counter()
        calls.append((t0, t1, system.pairs(n), rows))
        n += 1
        if prof is not None and n == trace_calls:
            record_spans(False)
            traced_counters = counter_increments(before, counters())
            torch.cuda.synchronize()
            mark.fill_(2.0)
            torch.cuda.synchronize()
            prof.stop()
            traced_spans = take_spans()
        if t1 - start >= seconds and n >= trace_calls:
            break
    window = Window(calls=calls, seconds=calls[-1][1] - start, traced_calls=trace_calls,
                    counters=counter_increments(before, counters()),
                    traced_counters=traced_counters, traced_spans=traced_spans)
    return window, prof


def trace_overhead(window, per_cycle: int) -> dict:
    """The traced calls' host wall against the wall of the same calls one
    pool cycle later, untraced (None where the window did not reach them)."""
    n = window.traced_calls
    if not n:
        return {}
    wall = lambda cs: cs[-1][1] - cs[0][0]
    traced = wall(window.calls[:n])
    later = window.calls[per_cycle:per_cycle + n]
    untraced = wall(later) if len(later) == n and per_cycle >= n else None
    return {"traced_calls_wall_s": traced, "same_calls_untraced_wall_s": untraced,
            "trace_overhead": traced / untraced - 1.0 if untraced else None}
