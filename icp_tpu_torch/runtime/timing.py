"""Timing and profiling (port of ``icp_tpu.runtime.timing``).

* :class:`CPUTimer`: a wall-clock span timer.
* :class:`ProfilingInfo`: named-phase aggregation with the reference's
  summary text, and the port's span recorder: each span it records keeps
  its start and end, its parent span and its registration.
* :func:`span`, :func:`count`, :func:`record_spans`, :func:`take_spans`,
  :func:`counters`: the process's recorder (:data:`RECORDER`), which the
  register path opens spans in and counts its work with. Spans are recorded
  only between ``record_spans(True)`` and ``record_spans(False)``;
  counters always count.
* :func:`trace`: a ``torch.profiler`` trace of a block, written as a Chrome
  trace with the spans recorded during the block.

Spans are stamped with ``time.time_ns()``, the clock of the profiler's
host records, so that a span and the CUDA API calls made inside it can be
compared in one clock. The recorder is single-threaded: one registration
at a time per process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

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


class Span(NamedTuple):
    """One recorded span: start and end in ``time.time_ns()`` nanoseconds,
    its own id, the id of the span it opened inside (None at the top) and
    the id of the registration it belongs to (None outside one)."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    registration: Optional[int]


class _OpenSpan:
    __slots__ = ("info", "name", "opens", "id", "parent", "registration", "start")

    def __init__(self, info: "ProfilingInfo", name: str, opens: bool):
        self.info, self.name, self.opens = info, name, opens

    def __enter__(self):
        info = self.info
        top = info._open[-1] if info._open else None
        self.id = next(info._ids)
        self.parent = top.id if top else None
        self.registration = (next(info._registrations) if self.opens
                             else top.registration if top else None)
        info._open.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        info = self.info
        info._open.pop()
        info.spans.append(Span(self.name, self.start, end, self.id, self.parent,
                               self.registration))
        info.record(self.name, (end - self.start) * 1e-6)


@dataclass
class ProfilingInfo:
    """Named-phase latency aggregation (reference ``ProfilingInfo<N>``) and
    span recorder.

    ``record(phase, ms)`` adds a duration; ``span(phase)`` records one
    around a block as a :class:`Span` as well, nested under the span open
    around it; ``span(phase, registration=True)`` opens a new registration
    id, which the spans inside it carry. ``count(name, n)`` adds to an
    integer counter. ``take()`` returns the spans and forgets them and the
    phases."""

    label: str = "profile"
    phases: Dict[str, List[float]] = field(default_factory=dict)
    spans: List[Span] = field(default_factory=list)
    counters: Dict[str, int] = field(default_factory=dict)
    _open: list = field(default_factory=list, repr=False)
    _ids: itertools.count = field(default_factory=itertools.count, repr=False)
    _registrations: itertools.count = field(default_factory=itertools.count, repr=False)

    def record(self, phase: str, ms: float) -> None:
        self.phases.setdefault(phase, []).append(ms)

    def span(self, phase: str, registration: bool = False) -> _OpenSpan:
        return _OpenSpan(self, phase, registration)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def take(self) -> List[Span]:
        spans, self.spans, self.phases = self.spans, [], {}
        return spans

    def total(self, phase: str) -> float:
        return sum(self.phases.get(phase, []))

    def mean(self, phase: str) -> float:
        xs = self.phases.get(phase, [])
        return sum(xs) / len(xs) if xs else 0.0

    def self_ms(self) -> Dict[str, float]:
        """Each recorded span name's self time (ms): its spans' durations
        less the parts their child spans cover."""
        child_ns: Dict[int, int] = {}
        for s in self.spans:
            if s.parent is not None:
                child_ns[s.parent] = child_ns.get(s.parent, 0) + s.end_ns - s.start_ns
        out: Dict[str, float] = {}
        for s in self.spans:
            own = s.end_ns - s.start_ns - child_ns.get(s.id, 0)
            out[s.name] = out.get(s.name, 0.0) + own * 1e-6
        return out

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
        own = self.self_ms()
        if own:
            lines.append("  self time (less child spans):")
            lines.extend(f"  {name:28s} self={ms:9.2f} ms" for name, ms in own.items())
        return "\n".join(lines)

    def print(self) -> None:  # noqa: A003 - mirrors reference naming
        print(self.summary())


RECORDER = ProfilingInfo(label="icp_tpu_torch spans")
_OFF = contextlib.nullcontext()
_recording = False


def record_spans(on: bool = True) -> None:
    """Switch the recording of :func:`span` on or off (off at import)."""
    global _recording
    _recording = bool(on)


def span(name: str, registration: bool = False):
    """A span of :data:`RECORDER` around a block while recording is on;
    otherwise a context that records nothing."""
    if not _recording:
        return _OFF
    return RECORDER.span(name, registration)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the process's counter ``name`` (always counted)."""
    RECORDER.count(name, n)


def counters() -> Dict[str, int]:
    """A copy of the process's counters, totals since the process began."""
    return dict(RECORDER.counters)


def take_spans() -> List[Span]:
    """The spans recorded since the last call, in the order they ended."""
    return RECORDER.take()


def _write_spans(path: str, spans: List[Span]) -> None:
    """Append ``spans`` to the Chrome trace at ``path`` as complete events
    on the trace's clock (its ``baseTimeNanoseconds``, where it has one)."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
                   "args": {"name": "icp_tpu_torch spans"}})
    events.extend({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
                   "tid": 0, "ts": (s.start_ns - base) / 1e3,
                   "dur": (s.end_ns - s.start_ns) / 1e3,
                   "args": {"id": s.id, "parent": s.parent,
                            "registration": s.registration}}
                  for s in spans)
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the enclosed block with ``torch.profiler`` (the CPU, and the
    card where there is one) and write a Chrome trace (open it in
    chrome://tracing or Perfetto) as ``trace.json`` under ``log_dir``, by
    default a directory in the temporary directory, with the spans of
    :data:`RECORDER` that began in the block, where spans are recorded.
    Yields ``log_dir``."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "icp_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    began = time.time_ns()
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(path)
        spans = [s for s in RECORDER.spans if s.start_ns >= began]
        if spans:
            _write_spans(path, spans)
