"""Whether the timed path was right: a sample of the window's registrations,
drawn from the seed and holding the one with the most iterations, each
registered again by the plain reference from the same frames.

Numbers compared, each the largest over the sample:

* ``t_gap_mm``: |t - t_ref| of the translation, mm, with the reference's
  pose after as many iterations as the program reported (k), running on
  past its own stop where the program ran longer;
* ``angle_gap_deg``: the angle of q q_ref^-1 there, degrees;
* ``scale_gap``: |s - s_ref| there;
* ``stop_t_gap_mm``: |t - t_ref| with each side's pose where it stopped by
  its own test: the convergence test and k, at the pose they give.

The iteration counts themselves are not compared: the increments of the
POINT configuration's last iterations are at its float32 noise, near the
0.01 mm threshold, so where a registration stops swings by several
iterations between two sound computations. Where it stops is held by
``stop_t_gap_mm`` instead: a registration that stops early (a convergence
test too loose, too few iterations, a stop after the first chunk) leaves
its pose millimetres from where the reference's own test stops. Which
numbers a configuration compares, and their limits, are in
``limits/<config>.json``; which reference registers the sample, in its
``reference`` (``spec.reference``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import spec
from portbench.reference import icp as ref_icp


def sample(window, seed: int, size: int) -> list[int]:
    """Indices into ``window.rows``: ``size`` drawn from the seed, and the
    first row with the largest k."""
    rows = window.rows
    rng = np.random.default_rng([seed, 2])
    picked = set(rng.choice(len(rows), size=min(size, len(rows)), replace=False).tolist())
    ks = window.ks
    picked.add(ks.index(max(ks)))
    return sorted(picked)


def pose_gaps(row, ref: dict) -> dict:
    """The compared numbers of one registration: ``row`` the program's
    (q, t, s, k), ``ref`` the reference's run (``spec.reference``'s, run
    to at least the program's k)."""
    k = int(row[8])
    if k < 1:
        return {name: math.inf for name in
                ("t_gap_mm", "angle_gap_deg", "scale_gap", "stop_t_gap_mm")}
    q = torch.as_tensor(row[:4], dtype=torch.float64)
    t = torch.as_tensor(row[4:7], dtype=torch.float64)
    qr, tr, sr = ref["poses"][k - 1]
    qd = ref_icp.quat_mul(q / q.norm(), torch.cat([-qr[:3], qr[3:]]) / qr.norm())
    return {
        "t_gap_mm": float(torch.linalg.vector_norm(t - tr)),
        "angle_gap_deg": math.degrees(2.0 * math.atan2(float(qd[:3].norm()),
                                                       abs(float(qd[3])))),
        "scale_gap": abs(float(row[7]) - sr),
        "stop_t_gap_mm": float(torch.linalg.vector_norm(t - ref["poses"][ref["k"] - 1][1])),
    }


def compare(frames: torch.Tensor, window, config: dict, seed: int, size: int,
            root=spec.ROOT) -> dict:
    """The largest of each compared number over the sample, against the
    reference that the configuration names."""
    reference = spec.reference(config, root)
    worst: dict = {}
    cache: dict = {}
    rows = window.rows
    for idx in sample(window, seed, size):
        pair, row = rows[idx]
        k = int(row[8])
        ref = reference(frames, pair, config["icp"], k, cache, False)
        for name, v in pose_gaps(row, ref).items():
            worst[name] = max(worst.get(name, 0.0), math.inf if math.isnan(v) else v)
    return worst


def judge(worst: dict, limits: dict) -> tuple[bool, dict]:
    """(every compared number finite and within its limit, {name: {value,
    limit}}) over the numbers that ``limits`` names."""
    out = {name: {"value": worst[name], "limit": lim} for name, lim in limits.items()}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in out.values())
    return ok, out
