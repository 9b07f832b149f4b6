"""The program's spans and counters over a window, joined to the
profiler's trace of some of its calls.

``icp_tpu_torch.runtime.timing`` records spans on the register path
(``icp.register`` > ``icp.build_target`` > ``icp.normals``; ``icp.register``
> ``icp.run`` > ``icp.chunk``, ``icp.host_read``) in ``time.time_ns()``
nanoseconds, and counts its work (``timing.counters()``:
``icp.steps_enqueued``, the chunk graph's captures and replays, the eager
chunks). :func:`run_window` runs a closed-loop window as
``drive.run_window`` does, with spans on, and profiles calls from the
middle of the window on: a stopped profiler leaves every later call
slower (its CUDA API callbacks stay subscribed unless kineto tears them
down), so only the calls before the profiler are free of its cost.
It keeps the spans, every counter's increments over the calls before the
profiler, over the profiled calls and over the window, every profiler
record with its correlation id (which links a device operation to the CUDA
API call that launched it) and the span clock read on both sides of the
first marker's launch. The readers take a ``drive.Window`` that carries
that record as ``spans`` and give None where it has none (a window run
by ``drive.run_window``, or an untraced window for the joined readings):

- host-only readings (:func:`step_host_ms`, :func:`host_read_wait_ms`)
  read the calls before the profiler;
- :func:`chunk_tail_share` reads the counters over the whole window;
- joined readings (:func:`launches_per_step`, :func:`index_ms`,
  :func:`idle_by_span`) read the profiled calls, and only where the
  marker's launch lies within :data:`SKEW_LIMIT_NS` of the span clock's
  reads around it (:func:`clock_skew_ns`).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import sys
import time

from portbench import devtrace, stats
from portbench.drive import Window, counter_increments

# CUDA API calls that enqueue work on the device.
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemsetAsync", "cudaMemcpyAsync",
            "cudaGraphLaunch")
SKEW_LIMIT_NS = 50_000
OUTSIDE = "outside"


@dataclasses.dataclass
class Event:
    """A profiler record: a device operation or a CUDA API call on the
    host, in the profiler's nanoseconds."""

    name: str
    on_device: bool
    start_ns: int
    end_ns: int
    correlation: int


@dataclasses.dataclass
class SpanRecord:
    """What the program recorded over a window.

    spans: ``timing.Span`` of every call, in ``time.time_ns()`` ns.
    before, profiled, total: the counters' increments over the calls
      before the profiler, over the profiled calls and over the window.
    profiled_ns: the span clock when the profiler started and stopped (a
      registration whose ``icp.register`` begins between them ran
      profiled, one that begins before them ran before the profiler), or
      None where nothing ran profiled.
    profiled_calls: the window's indices of the profiled calls (a range).
    events: every record of the profiler (``Event``).
    anchor_ns: the span clock just before and just after the launch of the
      window's first marker, or None.
    """

    spans: list
    before: dict
    profiled: dict
    total: dict
    profiled_ns: tuple | None = None
    profiled_calls: range = range(0)
    events: list = dataclasses.field(default_factory=list)
    anchor_ns: tuple | None = None


def events_of(prof) -> list[Event]:
    """Every record of a stopped ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    return [Event(e.name(), e.device_type() == DeviceType.CUDA, e.start_ns(), e.end_ns(),
                  e.correlation_id())
            for e in prof.profiler.kineto_results.events()]


def run_window(system, seconds: float, trace_calls: int = 0):
    """Calls from 0 on until ``seconds`` have passed since the first began,
    with the program's spans recorded; with ``trace_calls``, the calls from
    the first that begins once half the window has passed run under
    ``torch.profiler`` (device operations and CUDA API calls), between two
    marker operations on the drained device as in ``drive.run_window``.
    Returns (Window with ``spans`` set to a :class:`SpanRecord`; the
    stopped profiler or None)."""
    import torch

    from icp_tpu_torch.runtime.timing import counters, record_spans, take_spans

    take_spans()
    record_spans(True)
    c0 = c1 = c2 = counters()
    prof = mark = anchor = profiled_ns = None
    started_ns = first = None
    calls, n = [], 0
    start = time.perf_counter()
    while True:
        if trace_calls and first is None and time.perf_counter() - start >= seconds / 2:
            c1 = counters()
            mark = torch.zeros(1, device=system.frames.device)
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            torch.cuda.synchronize()
            started_ns = time.time_ns()
            mark.fill_(1.0)
            anchor, first = (started_ns, time.time_ns()), n
        t0 = time.perf_counter()
        rows = system.call(n)
        t1 = time.perf_counter()
        calls.append((t0, t1, system.pairs(n), rows))
        n += 1
        if first is not None and n - first == trace_calls:
            torch.cuda.synchronize()
            mark.fill_(2.0)
            torch.cuda.synchronize()
            prof.stop()
            profiled_ns, c2 = (started_ns, time.time_ns()), counters()
        if t1 - start >= seconds and (not trace_calls or (first is not None
                                                          and n - first >= trace_calls)):
            break
    window = Window(calls=calls, seconds=calls[-1][1] - start)
    record_spans(False)
    c3 = counters()
    traced = first is not None
    window.spans = SpanRecord(
        spans=take_spans(), before=counter_increments(c0, c1 if traced else c3),
        profiled=counter_increments(c1, c2 if traced else c1),
        total=counter_increments(c0, c3),
        profiled_ns=profiled_ns,
        profiled_calls=range(first, first + trace_calls) if traced else range(0),
        events=events_of(prof) if traced else [], anchor_ns=anchor)
    return window, prof


def _record(window) -> SpanRecord | None:
    rec = getattr(window, "spans", None)
    return rec if rec is not None and rec.spans else None


def _named(rec: SpanRecord, name: str, part: str) -> list:
    """The spans ``name`` of the registrations that ran ``part``:
    "before" the profiler or "profiled"."""
    lo, hi = rec.profiled_ns or (float("inf"), float("inf"))
    ids = {s.registration for s in rec.spans if s.name == "icp.register"
           and (s.start_ns < lo if part == "before" else lo <= s.start_ns < hi)}
    return [s for s in rec.spans if s.name == name and s.registration in ids]


def clock_skew_ns(rec: SpanRecord) -> int | None:
    """How far the CUDA API call that launched the window's first marker
    (the first device operation) lies outside the span clock's reads around
    it: 0 where it lies between them; None where there is no marker or no
    call linked to it."""
    if rec.anchor_ns is None:
        return None
    device = [e for e in rec.events if e.on_device]
    if not device:
        return None
    marker = min(device, key=lambda e: e.start_ns)
    api = [e for e in rec.events if not e.on_device and e.correlation == marker.correlation]
    if not api:
        return None
    before, after = rec.anchor_ns
    return max(0, before - api[0].start_ns, api[0].end_ns - after)


def _aligned(rec: SpanRecord | None) -> bool:
    """True where the joined readings may join spans to the trace."""
    if rec is None or not rec.events:
        return False
    skew = clock_skew_ns(rec)
    if skew is None or skew > SKEW_LIMIT_NS:
        print(f"spantrace: span clock skew {skew} ns against a limit of {SKEW_LIMIT_NS} ns; "
              "no reading joins the spans to the trace", file=sys.stderr)
        return False
    return True


def _inside(intervals: list, t: int) -> bool:
    """Whether t lies in one of the sorted, disjoint [start, end]
    intervals, its edges included."""
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and t <= intervals[i][1]


def step_host_ms(window) -> float | None:
    """Host ms inside ``icp.chunk`` spans per step enqueued in them, over
    the calls before the profiler: the launch path's cost per step."""
    rec = _record(window)
    if rec is None:
        return None
    chunks = _named(rec, "icp.chunk", "before")
    steps = rec.before.get("icp.steps_enqueued", 0)
    if not chunks or not steps:
        return None
    return sum(s.end_ns - s.start_ns for s in chunks) * 1e-6 / steps


def launches_per_step(window) -> float | None:
    """CUDA API launch calls (:data:`LAUNCHES`) that begin inside an
    ``icp.chunk`` span of the profiled calls, per step enqueued there."""
    rec = _record(window)
    if not _aligned(rec):
        return None
    chunks = sorted((s.start_ns, s.end_ns) for s in _named(rec, "icp.chunk", "profiled"))
    steps = rec.profiled.get("icp.steps_enqueued", 0)
    if not chunks or not steps:
        return None
    launches = sum(1 for e in rec.events
                   if not e.on_device and e.name.startswith(LAUNCHES)
                   and _inside(chunks, e.start_ns))
    return launches / steps


def chunk_tail_share(window) -> float | None:
    """100 x (1 - the window's sum of k / the steps enqueued in it), %: the
    steps computed and then frozen away by the chunk's tail."""
    rec = getattr(window, "spans", None)
    if rec is None:
        return None
    steps = rec.total.get("icp.steps_enqueued", 0)
    if not steps:
        return None
    return 100.0 * (1.0 - sum(window.ks) / steps)


def host_read_wait_ms(window) -> float | None:
    """Ms per registration inside ``icp.host_read`` spans, over the calls
    before the profiler: the host waiting on the device."""
    rec = _record(window)
    if rec is None:
        return None
    regs = _named(rec, "icp.register", "before")
    if not regs:
        return None
    reads = _named(rec, "icp.host_read", "before")
    return sum(s.end_ns - s.start_ns for s in reads) * 1e-6 / len(regs)


def index_ms(window) -> float | None:
    """Per profiled registration, ms from the start of its first
    ``icp.build_target`` span to the end of the last device operation
    launched inside one of its ``icp.build_target`` spans: the index
    build's critical path, normals included; the mean over the
    registrations."""
    rec = _record(window)
    if not _aligned(rec):
        return None
    targets = collections.defaultdict(list)
    for s in _named(rec, "icp.build_target", "profiled"):
        targets[s.registration].append((s.start_ns, s.end_ns))
    api = sorted((e.start_ns, e.correlation) for e in rec.events if not e.on_device)
    ends = collections.defaultdict(list)
    for e in rec.events:
        if e.on_device:
            ends[e.correlation].append(e.end_ns)
    api_starts = [t for t, _ in api]
    out = []
    for spans in targets.values():
        spans.sort()
        lo = bisect.bisect_left(api_starts, spans[0][0])
        hi = bisect.bisect_right(api_starts, spans[-1][1])
        last = [end for t, corr in api[lo:hi] if _inside(spans, t)
                for end in ends.get(corr, ())]
        if last:
            out.append(max(last) - spans[0][0])
    return sum(out) * 1e-6 / len(out) if out else None


def idle_by_span(window) -> list | None:
    """Device idle seconds of the profiled window (between its two
    markers) by the innermost program span open on the host at each gap's
    middle (``outside`` where none is) and the innermost CUDA API call
    running then (``devtrace.HOST`` where none is): [["span/call",
    seconds], ...], largest first."""
    rec = _record(window)
    if not _aligned(rec):
        return None
    device = sorted((e for e in rec.events if e.on_device), key=lambda e: e.start_ns)
    if len(device) < 2:
        return None
    first, last = device[0], max(device, key=lambda e: e.end_ns)
    work = [(e.start_ns, e.end_ns) for e in device if e is not first and e is not last]
    api = sorted((e.start_ns, e.end_ns, e.name) for e in rec.events if not e.on_device)
    spans = sorted((s.start_ns, s.end_ns, s.name) for s in rec.spans)

    def innermost(ivs, starts, t, none):
        # The latest-starting interval that still covers t.
        i = bisect.bisect_right(starts, t)
        for _, e, name in reversed(ivs[max(0, i - 64):i]):
            if e >= t:
                return name
        return none

    api_starts, span_starts = [a[0] for a in api], [s[0] for s in spans]
    by = collections.defaultdict(float)
    for s, e in stats.gaps(work, first.start_ns, last.end_ns):
        mid = 0.5 * (s + e)
        label = (innermost(spans, span_starts, mid, OUTSIDE) + "/"
                 + innermost(api, api_starts, mid, devtrace.HOST))
        by[label] += (e - s) * 1e-9
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])]
