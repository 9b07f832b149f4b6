"""Driving the system under test, ``icp_tpu_torch``, through its entry
points, in a closed loop over the cell's frame pool.

Call n of a traffic mix registers ``batch`` frame pairs (i, i + 1), i = n *
batch + lane, modulo the pool (frame i fixed, frame i + 1 moving): with
``register`` one pair a call, with ``register_batch`` ``batch`` pairs a
call. A call ends when its poses (q, t, s) and iteration counts k are on the
host; the next call starts then. The window's first call is drawn from the
run's seed (:func:`first_call`): every seed makes the same calls, from
another place in the cycle.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

ENTRIES = ("register", "register_batch")


def port_settings(config: dict):
    """(ICPParams, ICPConfig) of the configuration file's ``icp`` section."""
    import icp_tpu_torch as port

    icp = config["icp"]
    cfg = port.ICPConfig(
        m=config["points"], n_r=icp["n_r"],
        rotation=port.RotationMode(icp["rotation"]),
        weighting=port.Weighting("weighted" if icp["weighted"] else "regular"),
        objective=port.Objective(icp["objective"]),
        normal_mode=icp["normal_mode"], estimate_scale=icp["estimate_scale"],
        max_iterations=icp["max_iterations"])
    params = port.ICPParams(alpha=icp["alpha"], c=icp["c"],
                            angle_threshold_deg=icp["angle_threshold_deg"],
                            translation_threshold=icp["translation_threshold_mm"])
    return params, cfg


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
    setup_s, config, traffic, trace: the run's set-up seconds, the cell's
      configuration and traffic mix, and the traced window
      (``devtrace.Trace``) or None; the metric readers take them from here.
    """

    calls: list
    seconds: float
    traced_calls: int = 0
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


class System:
    """The port, set up for one cell: ``call(n)`` runs the window's call n,
    call ``start + n`` of the cycle, and returns its (batch, 9) rows on the
    host."""

    def __init__(self, config: dict, traffic: dict, frames: torch.Tensor,
                 start: int = 0):
        import icp_tpu_torch as port

        if traffic["entry"] not in ENTRIES:
            raise ValueError(f"entry must be one of {ENTRIES}, got {traffic['entry']!r}")
        self.params, self.cfg = port_settings(config)
        self.traffic = traffic
        self.frames = frames
        self.start = start
        self.batched = traffic["entry"] == "register_batch"
        self.entry = port.register_batch if self.batched else port.register
        # The index tensors of every distinct batch, made once: indexing
        # with a host list would copy it to the device inside the window.
        per_cycle = traffic["pool_frames"] // traffic["batch"]
        self.index = [tuple(torch.tensor(col, device=frames.device)
                            for col in zip(*call_pairs(traffic, n)))
                      for n in range(per_cycle)] if self.batched else None

    def pairs(self, n: int) -> list[tuple[int, int]]:
        return call_pairs(self.traffic, self.start + n)

    def call(self, n: int):
        if self.batched:
            fi, mi = self.index[(self.start + n) % len(self.index)]
            st = self.entry(self.frames[fi], self.frames[mi], self.params, self.cfg)
            out = torch.cat([st.q, st.t, st.s[:, None],
                             st.k.to(torch.float32)[:, None]], dim=1)
        else:
            (i, j), = self.pairs(n)
            st = self.entry(self.frames[i], self.frames[j], self.params, self.cfg)
            out = torch.cat([st.q, st.t, st.s.reshape(1),
                             st.k.to(torch.float32).reshape(1)])[None]
        return out.cpu().double()


def run_window(system: System, seconds: float, trace_calls: int = 0):
    """Calls from 0 on until ``seconds`` have passed since the first began;
    the first ``trace_calls`` under ``torch.profiler``, which records the
    device's operations (and the CUDA API calls that launched them) and no
    host operators, so that the traced calls run at nearly their own speed.
    The traced calls are bracketed by two marker operations on the drained
    device (``devtrace.read`` takes the window between them). Returns
    (Window, the stopped profiler or None)."""
    prof = mark = None
    if trace_calls:
        mark = torch.zeros(1, device=system.frames.device)
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        torch.cuda.synchronize()
        mark.fill_(1.0)
    calls, n = [], 0
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        rows = system.call(n)
        t1 = time.perf_counter()
        calls.append((t0, t1, system.pairs(n), rows))
        n += 1
        if prof is not None and n == trace_calls:
            torch.cuda.synchronize()
            mark.fill_(2.0)
            torch.cuda.synchronize()
            prof.stop()
        if t1 - start >= seconds and n >= trace_calls:
            break
    return Window(calls=calls, seconds=calls[-1][1] - start, traced_calls=trace_calls), prof


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
