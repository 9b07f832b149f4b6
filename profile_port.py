#!/usr/bin/env python3
"""Where the time goes: icp_tpu_torch registrations under torch.profiler on
one NVIDIA GPU.

    python3 profile_port.py [--out build/profile.json]
                            [--gate16x | --knn-tables | --search-kernels
                             | --odometry]

For each cell, ``register`` runs twice to warm up, then once with
``max_iterations=8`` and thresholds 0 under ``torch.profiler`` (CPU and CUDA
activities), ending in ``torch.cuda.synchronize()``. Per cell it prints the
host wall time of the profiled call, the device time (the sum of the
durations of the device events: kernels, copies and fills, which run one at
a time on the one stream), their count, the idle share 1 - device / wall,
and the largest device operations by name. The cells: flagship POINT and
BRUTE POINT, PLANE and robust-adaptive PLANE (K4 and the device median) on
the rendered pair, POINT at 4x and 16x, LiDAR PLANE, and
``register_batch`` of four flagship POINT pairs (8 steps each). The
estimator ``knn_normals_rbc`` at 262144 points is profiled alone too (one
call).
With ``--gate16x`` it only times the 16x POINT registration (262144 x
2048, ``chip_smoke.py``'s ``icp_16x`` gate) to convergence, once with K3
and once with K3's plain twin in its place: k, the errors against the
ground truth and the least wall time of 5 calls for each. With
``--knn-tables`` it times K8 on the arguments the estimator hands it at
262144 and 16384 points, the estimator's ms per call at 262144 points, and
the grouping's table gather at the flagship and 16x layouts (d 8 and 11:
K2 through the order, or, in a tree whose ``bin_table`` takes no order,
torch.cat and index_select then K2), K2 alone on the sorted rows, and the
whole ``group_rows_by_bin``;
with ``--search-kernels`` it times K9 on the estimator's arguments at
262144 and 16384 points, and K5 on the unfused step's at the flagship (V 8),
on the rendered PLANE pair (V 12) and over 16 bins (cq 1536, cb 2048),
and K3 and K7, which share K5's bin staging, on the fused steps' arguments.
With ``--odometry`` it profiles one ``odometry_chain_device`` call over the
first 10 frames of the bench's real-terrain arc (GICP, 8 iterations,
thresholds 0; the frames rendered by ``chip_smoke.py``'s process pool)
and prints the device events and wrapper launches per frame pair.
Copy the script into an unpacked parent tree to A/B it. Needs a GPU; there
is no CPU fallback.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import torch


def _profile(call, warmup: int = 2) -> dict:
    """Profile one call of ``call`` after ``warmup`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = defaultdict(float)
    n_events = 0
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            n_events += 1
            by_name[evt.name] += evt.time_range.elapsed_us() / 1e3
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_ms": device_ms, "device_events": n_events,
            "idle_share": 1.0 - device_ms / wall_ms,
            "top": [{"name": name[:90], "ms": ms} for name, ms in top]}


def _gate16x(dev, rounds: int = 5) -> dict:
    """k, errors and least wall ms of the 16x POINT registration with K3
    and with K3's twin (the ``rbc.search`` module's reference swapped)."""
    from chip_smoke import ALPHA, _errors
    from icp_tpu_torch import ICPConfig, ICPParams, register
    from icp_tpu_torch.icp import chunk_graph
    from icp_tpu_torch.kernels import fused_step as fs
    from icp_tpu_torch.rbc import search
    from icp_tpu_torch.sensors.synthetic import wavy_surface_pair

    f, m, q_gt, t_gt = wavy_surface_pair(262144)
    fixed, moving = torch.from_numpy(f).to(dev), torch.from_numpy(m).to(dev)
    params, cfg = ICPParams(alpha=ALPHA), ICPConfig(m=262144, n_r=2048)
    kernel = search.bin_point_moments
    out = {}
    for name, k3 in (("K3", kernel), ("K3 twin", fs.bin_point_moments_ref)):
        search.bin_point_moments = k3
        chunk_graph.clear()  # a replay would run the kernel captured before
        try:
            walls = []
            for _ in range(rounds):
                t0 = time.perf_counter()
                st = register(fixed, moving, params, cfg)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
        finally:
            search.bin_point_moments = kernel
        t_err, a_err = _errors(st, q_gt, t_gt)
        out[name] = {"k": int(st.k), "t_err_mm": t_err, "a_err_deg": a_err,
                     "wall_ms": min(walls)}
        print(f"icp_16x with {name}: k {int(st.k)}, t_err {t_err} mm, a_err {a_err} deg, "
              f"least wall of {rounds} {min(walls)} ms", flush=True)
    return out


def _knn_tables(dev, rounds: int = 3) -> dict:
    """Device ms (CUDA events, the least of ``rounds``) of K8 and of the
    table gather, and the estimator's host ms per call, in this tree."""
    import inspect

    from chip_smoke import ALPHA, _cuda_ms
    from icp_tpu_torch import ICPConfig
    from icp_tpu_torch.icp.state import identity_state
    from icp_tpu_torch.kernels import fused_step as fs
    from icp_tpu_torch.kernels import knn_moments as km
    from icp_tpu_torch.kernels import table_build as tb
    from icp_tpu_torch.ops import normals as nm
    from icp_tpu_torch.ops.normals import normals_for
    from icp_tpu_torch.ops.sampling import sample_representative_indices
    from icp_tpu_torch.rbc import grouping
    from icp_tpu_torch.sensors.synthetic import synthetic_pair, wavy_surface_pair

    def least(fn, reps=20):
        return min(_cuda_ms(fn, reps) for _ in range(rounds))

    out = {}
    for m in (262144, 16384):
        cloud = torch.from_numpy(wavy_surface_pair(m)[0]).to(dev)
        seen = []
        real = nm.bin_knn_moments
        nm.bin_knn_moments = lambda *a, **kw: seen.append((a, kw)) or real(*a, **kw)
        try:
            nm.knn_normals_rbc(cloud)
        finally:
            nm.bin_knn_moments = real
        a, kw = seen[0]
        out[f"K8 at {m} points {tuple(a[1].shape)}"] = least(
            lambda: km.bin_knn_moments(*a, **kw), 5)
        if m == 262144:
            walls = []
            for _ in range(rounds):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    nm.knn_normals_rbc(cloud)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) / 5 * 1e3)
            out["knn_normals_rbc host ms per call at 262144"] = min(walls)

    takes_order = "order" in inspect.signature(tb.bin_table).parameters
    alpha = torch.tensor(ALPHA, dtype=torch.float32, device=dev)
    st = identity_state(torch.float32, dev)
    G, b_row = fs.prep_similarity(st.q, st.t, st.s)
    for name, m, n_r, cap in (("flagship", 16384, 256, 96), ("16x", 262144, 2048, 256)):
        fixed, moving = (torch.from_numpy(x).to(dev) for x in synthetic_pair(m, seed=0))
        reps = fixed[sample_representative_indices(
            m, n_r, ICPConfig(m=m, n_r=n_r).rep_grid, device=dev).long()]
        C, srow = fs.prep_rep_assign(reps, alpha, G.contiguous(), b_row)
        rid, counts = fs.rep_assign_counts(moving, C.contiguous(), srow)
        sidx, _, offsets, _ = grouping.bin_sort_layout(rid, n_r, cap, counts=counts)
        for srcs in ((moving,), (moving, normals_for(moving, "auto"))):
            d = sum(x.shape[1] for x in srcs)
            rows = torch.index_select(srcs[0] if len(srcs) == 1 else torch.cat(srcs, dim=1),
                                      0, sidx).contiguous()
            out[f"K2 on sorted rows {name} d {d}"] = least(
                lambda r=rows: tb.bin_table(r, offsets, capacity=cap))
            if takes_order:
                gather = lambda s=srcs: tb.bin_table(s, offsets, capacity=cap, order=sidx)
            else:
                gather = lambda s=srcs: tb.bin_table(torch.index_select(
                    s[0] if len(s) == 1 else torch.cat(s, dim=1), 0, sidx).contiguous(),
                    offsets, capacity=cap)
            out[f"gather {name} d {d}"] = least(gather)
            out[f"group_rows_by_bin {name} d {d}"] = least(
                lambda s=srcs: grouping.group_rows_by_bin(rid, n_r, cap, s, counts=counts))
    for key, ms in out.items():
        print(f"{key}: {ms} ms (K2 takes the order: {takes_order})", flush=True)
    return out


def _search_kernels(dev, rounds: int = 3) -> dict:
    """Device ms (CUDA events, the least of ``rounds``) of K9 on the
    arguments the estimator hands it at 262144 and 16384 points, and of K5
    on those the unfused step hands it: the flagship pair (V 8), the
    rendered PLANE pair (V 12) and the flagship pair over 16 bins; then of
    K3 and K7 (plane), which share K5's bin staging, on what the fused steps
    hand them: K3 on the flagship pair over 256 and 16 bins, K7 on the
    rendered PLANE pair and the LiDAR PLANE step (262144 x 2048)."""
    from chip_smoke import ALPHA, _capture, _cuda_ms, _rendered_pair
    from icp_tpu_torch import ICPConfig, ICPParams, Objective, icp_step
    from icp_tpu_torch.icp.run import build_index
    from icp_tpu_torch.icp.state import identity_state
    # The module, not the wrapper the package exports under its name.
    bs = importlib.import_module("icp_tpu_torch.kernels.bin_search")
    from icp_tpu_torch.kernels import knn_moments as km
    from icp_tpu_torch.ops import normals as nm
    from icp_tpu_torch.rbc import search as search_mod
    from icp_tpu_torch.sensors.synthetic import synthetic_pair, wavy_surface_pair

    def least(fn, reps=20):
        return min(_cuda_ms(fn, reps) for _ in range(rounds))

    out = {}
    for m in (262144, 16384):
        cloud = torch.from_numpy(wavy_surface_pair(m)[0]).to(dev)
        a, _ = _capture(nm, "rep_top2_counts", lambda: nm.knn_normals_rbc(cloud))
        out[f"K9 at {m} points x {a[1].shape[0]} reps"] = least(
            lambda: km.rep_top2_counts(*a))

    params = ICPParams(alpha=ALPHA).to(dev)
    st0 = identity_state(torch.float32, dev)
    fixed, moving = (torch.from_numpy(x).to(dev) for x in synthetic_pair(16384, seed=0))
    la, lb, _ = _rendered_pair()
    fa, lb = la.to(dev), lb.to(dev)
    cfg_p = ICPConfig(objective=Objective.PLANE, estimate_scale=False, fused_gn=False)
    cases = {"flagship V 8": (fixed, moving, ICPConfig(fused_point=False)),
             "rendered PLANE V 12": (fa, lb, cfg_p),
             "n_r 16 V 8": (fixed, moving, ICPConfig(n_r=16, fused_point=False))}
    for name, (f, mv, cfg) in cases.items():
        index = build_index(f, params, cfg)
        a, _ = _capture(search_mod, "bin_search",
                        lambda: icp_step(st0, mv, index, params, cfg))
        out[f"K5 {name} {tuple(a[0].shape)} x {tuple(a[1].shape)}"] = least(
            lambda: bs.bin_search(*a))
    # K3 and K7 share K5's bin staging (csrc/bin_search_phase.cuh).
    wf, wm = (torch.from_numpy(x).to(dev) for x in wavy_surface_pair(262144)[:2])
    cfg_l = ICPConfig(m=262144, n_r=2048, estimate_scale=False, objective=Objective.PLANE,
                      normal_mode="knn")
    cases = {"K3 flagship": (fixed, moving, ICPConfig(), "bin_point_moments"),
             "K3 n_r 16": (fixed, moving, ICPConfig(n_r=16), "bin_point_moments"),
             "K7 plane rendered": (fa, lb, dataclasses.replace(cfg_p, fused_gn=True),
                                   "bin_gn_moments"),
             "K7 plane 16x": (wf, wm, cfg_l, "bin_gn_moments")}
    for name, (f, mv, cfg, kernel) in cases.items():
        index = build_index(f, params, cfg)
        a, kw = _capture(search_mod, kernel, lambda: icp_step(st0, mv, index, params, cfg))
        fn = getattr(search_mod, kernel)
        out[f"{name} {tuple(a[0].shape)}"] = least(lambda: fn(*a, **kw))
    for key, ms in out.items():
        print(f"{key}: {ms} ms", flush=True)
    return out


def _cells(dev) -> dict:
    """Each cell's profile of 8 steps, and the estimator's of one call."""
    from chip_smoke import ALPHA, _rendered_pair
    from icp_tpu_torch import (Correspondence, ICPConfig, ICPParams, Objective,
                               RobustKernel, Weighting, register, register_batch)
    from icp_tpu_torch.ops.normals import knn_normals_rbc
    from icp_tpu_torch.sensors.synthetic import synthetic_pair, wavy_surface_pair

    fast = ICPParams(alpha=ALPHA, angle_threshold_deg=0.0, translation_threshold=0.0)

    def on_card(*arrays):
        return [torch.as_tensor(a).to(dev) for a in arrays]

    flag = on_card(*synthetic_pair(16384, seed=0))
    la, lb, lb_dirty = _rendered_pair()
    rendered = on_card(la, lb)
    dirty = on_card(la, lb_dirty)
    batch = [on_card(*synthetic_pair(16384, seed=seed)) for seed in range(4)]
    batch_f, batch_m = (torch.stack([pair[i] for pair in batch]) for i in (0, 1))
    wavy16 = on_card(*wavy_surface_pair(262144)[:2])
    wavy4 = on_card(*wavy_surface_pair(65536)[:2])
    cells = {
        "POINT 16384x256": (flag, ICPConfig()),
        "BRUTE POINT 16384": (flag, ICPConfig(correspondence=Correspondence.BRUTE)),
        "PLANE 16384x256 rendered": (rendered, ICPConfig(objective=Objective.PLANE,
                                                         estimate_scale=False)),
        "robust PLANE 16384x256 rendered, adaptive": (dirty, ICPConfig(
            objective=Objective.PLANE, weighting=Weighting.REGULAR,
            robust=RobustKernel.TRIMMED, robust_adaptive=True, estimate_scale=False)),
        "POINT 65536x1024": (wavy4, ICPConfig(m=65536, n_r=1024)),
        "POINT 262144x2048": (wavy16, ICPConfig(m=262144, n_r=2048)),
        "LiDAR PLANE 262144x2048 knn": (wavy16, ICPConfig(
            m=262144, n_r=2048, objective=Objective.PLANE, normal_mode="knn",
            estimate_scale=False)),
    }
    calls = {name: (lambda f=fixed, m=moving, c=dataclasses.replace(
                        config, max_iterations=8): register(f, m, fast, c))
             for name, ((fixed, moving), config) in cells.items()}
    calls["register_batch POINT B4 16384x256"] = lambda: register_batch(
        batch_f, batch_m, fast, ICPConfig(max_iterations=8))
    calls["knn_normals_rbc 262144"] = lambda: knn_normals_rbc(wavy16[0])
    results = {}
    for name, call in calls.items():
        res = results[name] = _profile(call)
        print(f"{name}: wall {res['wall_ms']} ms, device {res['device_ms']} ms in "
              f"{res['device_events']} events, idle share {res['idle_share']}", flush=True)
        for row in res["top"]:
            print(f"    {row['ms']:.4f} ms  {row['name']}", flush=True)
    return results


def _odometry(dev, n_frames: int = 10) -> dict:
    """The profile of one 10-frame chain, and its launches per frame pair."""
    from chip_smoke import ALPHA, _render_terrain
    from icp_tpu_torch import ICPConfig, ICPParams, Objective
    from icp_tpu_torch.kernels import native
    from icp_tpu_torch.sensors import synthetic
    from icp_tpu_torch.slam.odometry import frame_to_landmarks, odometry_chain_device

    poses = synthetic.orbit_trajectory(100, radius_mm=120.0, yaw_rad=0.12, device="cpu")
    (frames,), render_s = _render_terrain([poses[:n_frames]])
    lms = torch.stack([frame_to_landmarks(torch.from_numpy(f).to(dev)) for f in frames])
    params = ICPParams(alpha=ALPHA, angle_threshold_deg=0.0, translation_threshold=0.0).to(dev)
    cfg = ICPConfig(max_iterations=8, estimate_scale=False, objective=Objective.GICP)
    odometry_chain_device(lms, params, cfg)
    before = native.launches()
    res = _profile(lambda: odometry_chain_device(lms, params, cfg), warmup=1)
    ran = native.launches() - before
    pairs = n_frames - 1
    res["pairs"] = pairs
    res["device_events_per_pair"] = res["device_events"] / pairs
    res["wall_ms_per_pair"] = res["wall_ms"] / pairs
    res["device_ms_per_pair"] = res["device_ms"] / pairs
    # Each wrapper was called by the warm-up and the profiled call.
    res["kernel_launches_per_pair"] = {name: ran[name] / (2 * pairs) for name in
                                       ("rep_assign_counts", "bin_table", "bin_gn_moments")}
    res["render_s"] = render_s
    print(f"odometry chain, {n_frames} real-terrain frames (GICP, 8 iterations): wall "
          f"{res['wall_ms']} ms, device {res['device_ms']} ms in {res['device_events']} events, "
          f"idle share {res['idle_share']}; per pair: wall {res['wall_ms_per_pair']} ms, device "
          f"{res['device_ms_per_pair']} ms, {res['device_events_per_pair']} device events, "
          f"kernel launches {res['kernel_launches_per_pair']}", flush=True)
    for row in res["top"]:
        print(f"    {row['ms']:.4f} ms  {row['name']}", flush=True)
    return res


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="build/profile.json")
    parser.add_argument("--gate16x", action="store_true",
                        help="only the 16x POINT gate to convergence, K3 against its twin")
    parser.add_argument("--knn-tables", action="store_true",
                        help="only K8, the estimator and the table gather, timed")
    parser.add_argument("--search-kernels", action="store_true",
                        help="only K9 and K5 on the main path's arguments, timed")
    parser.add_argument("--odometry", action="store_true",
                        help="only one 10-frame odometry chain, profiled")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_port: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, check=True).stdout.strip()
    results = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    if args.gate16x:
        results["gate16x"] = _gate16x(dev)
    elif args.knn_tables:
        results["knn_tables"] = _knn_tables(dev)
    elif args.search_kernels:
        results["search_kernels"] = _search_kernels(dev)
    elif args.odometry:
        results["odometry"] = _odometry(dev)
    else:
        results["cells"] = _cells(dev)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(smi, flush=True)


if __name__ == "__main__":
    main()
