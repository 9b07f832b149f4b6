"""Reading a ``torch.profiler`` trace of the traced window.

The profiler records the device's operations (kernels, copies, fills) and
the CUDA API calls on the host that launched them; the traced calls lie
between two marker operations on the device, the trace's first and last.
The events are read straight from the profiler's event list, in the
profiler's own clock, without building its operator tree.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

from portbench import stats

HOST = "host_no_cuda_call"

@dataclasses.dataclass
class Trace:
    """Events of the traced window, times in seconds of the profiler clock.

    device: (name, start, end) of every device operation in the window.
    host: (name, start, end) of every host operator span in the window.
    start, end: the window's span.
    """

    device: list
    host: list
    start: float
    end: float

    @property
    def window_s(self) -> float:
        return self.end - self.start

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return stats.covered(stats.clip([(s, e) for _, s, e in self.device],
                                        self.start, self.end))

    def device_seconds(self, names) -> float:
        """Device seconds of the operations whose names contain one of
        ``names``."""
        return sum(e - s for n, s, e in self.device if any(k in n for k in names))

    def device_count(self, names) -> int:
        return sum(1 for n, _, _ in self.device if any(k in n for k in names))

    def top_device_ops(self, n: int = 10) -> list:
        by = collections.defaultdict(float)
        for name, s, e in self.device:
            by[name] += e - s
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """Device idle seconds by the innermost CUDA API call running on the
        host at the middle of each gap (``HOST`` where none ran: Python and
        the port's host code), largest first."""
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        by = collections.defaultdict(float)
        for s, e in stats.gaps([(a, b) for _, a, b in self.device], self.start, self.end):
            mid = 0.5 * (s + e)
            label = HOST
            i = bisect.bisect_right(starts, mid)
            # The innermost span: the latest-starting one that still covers mid.
            for name, _, he in reversed(host[max(0, i - 64):i]):
                if he >= mid:
                    label = name
                    break
            by[label] += e - s
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def read(prof) -> Trace:
    """The traced window of a stopped ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    base = min((evt.start_ns() for evt in events), default=0)  # keeps ns digits
    return from_events([(evt.name(), evt.device_type() == DeviceType.CUDA,
                         (evt.start_ns() - base) * 1e-9, (evt.end_ns() - base) * 1e-9)
                        for evt in events])


def from_events(events) -> Trace:
    """The window of (name, on the device, start s, end s) events: from the
    start of the first device operation to the end of the last, which are the
    window's two markers and are not counted as work."""
    device = sorted(((n, s, e) for n, on_dev, s, e in events if on_dev),
                    key=lambda d: d[1])
    first = device[0] if device else None
    last = max(device, key=lambda d: d[2]) if device else None
    if first is last:
        raise RuntimeError("the trace holds no marked window: fewer than two device "
                           "operations")
    lo, hi = first[1], last[2]
    host = [(n, s, e) for n, on_dev, s, e in events if not on_dev and s < hi and e > lo]
    return Trace(device=[d for d in device if d is not first and d is not last],
                 host=host, start=lo, end=hi)
