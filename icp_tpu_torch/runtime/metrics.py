"""Metrics / observability (port of ``icp_tpu.runtime.metrics``).

The reference reports to stdout only: the per-iteration report
(src/ocl_icp_sbs.cpp:202-217) and the registration summary (iterations +
latency). :class:`MetricsSink` keeps named values in process and dumps them
as JSON lines, with the JAX package's fields.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np
import torch


def _scalar(value) -> float:
    """A Python float of a number, a 0-d array or a one-element tensor on
    any device (a CUDA tensor is read with ``.item()``)."""
    if isinstance(value, torch.Tensor):
        return float(value.item())
    return float(np.asarray(value))


@dataclass
class MetricsSink:
    """Accumulates structured metrics; not thread-safe (one per engine or
    run)."""

    run_id: str = "default"
    records: List[Dict[str, Any]] = field(default_factory=list)

    def log(self, name: str, value, **tags) -> None:
        rec = {"ts": time.time(), "run": self.run_id, "metric": name,
               "value": _scalar(value)}
        rec.update(tags)
        self.records.append(rec)

    def log_registration(self, state, latency_ms: float, **tags) -> None:
        """Log the reference's registration summary quantities."""
        from icp_tpu_torch.icp.quaternion import qangle_deg

        self.log("icp.iterations", int(state.k.item()), **tags)
        self.log("icp.latency_ms", latency_ms, **tags)
        self.log("icp.angle_deg", qangle_deg(state.q).item(), **tags)
        self.log("icp.translation_mm",
                 float(np.linalg.norm(state.t.cpu().numpy())), **tags)
        self.log("icp.scale", state.s.item(), **tags)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-metric mean / min / max / count."""
        out: Dict[str, Dict[str, float]] = {}
        for rec in self.records:
            s = out.setdefault(rec["metric"], {"count": 0, "sum": 0.0,
                                               "min": float("inf"), "max": float("-inf")})
            v = rec["value"]
            s["count"] += 1
            s["sum"] += v
            s["min"] = min(s["min"], v)
            s["max"] = max(s["max"], v)
        for s in out.values():
            s["mean"] = s["sum"] / s["count"]
        return out

    def dump_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for rec in self.records:
                f.write(json.dumps(rec) + "\n")

    @staticmethod
    def load_jsonl(path: str) -> "MetricsSink":
        sink = MetricsSink()
        with open(path) as f:
            for line in f:
                if line.strip():
                    sink.records.append(json.loads(line))
        return sink
