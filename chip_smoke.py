#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (icp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; there is no CPU fallback):

1. Device: require CUDA, print the card (nvidia-smi name and power limit),
   the torch and nvcc versions, and build the kernels from csrc/.
2. Kernels against their plain PyTorch twins on the card, on the tensors of
   the first iteration of the flagship pair (m=16384, n_r=256): K2 bitwise;
   K1 exact counts, rid agreement >= 99.9% with every disagreement a
   float64 near-tie; K3 max|dP| <= 1e-4 max|P|.
3. The slice: register three flagship pairs (seeds 0, 1, 2) with the
   default ICPConfig through icp_tpu_torch.register on CUDA tensors; each
   must land within 0.05 mm and 0.005 deg of the ground truth, the launch
   counters must show every kernel ran at least k times, and seed 0 must
   agree with the same registration on the CPU (the twins) within 0.01 mm
   and 0.001 deg.
4. Times, printed, never gated: the marginal ms per iteration (thresholds
   0, max_iterations 40 against 8, minimum of alternating rounds for each
   before differencing, as bench.py does) and each kernel against its twin
   with CUDA events.

Slice 2 (PLANE / symmetric PLANE / GICP and the robust weights) adds, on the
reference's rendered gate pair (bench.py: pose A the identity, pose B a
0.008 rad turn about y and t = (10, -6, 8) mm, so B is the ground truth),
landmarks made by icp_tpu_torch.sensors:

2b. K4, K7 (plane, plane_sym, gicp) and K3 with Huber and TRIMMED weights
    against their twins on the first iteration's tensors (m=16384, n_r=256,
    cq 96, cb 128): K4 the same +inf slots and finite values within 1e-6 of
    the largest; K7's P and P_z and K3's P within 1e-4 of max|P|; K7's P
    repeats bitwise.
3b. The four bench gates (plane, plane_sym, robust with 12 % gross outliers
    made as bench.py makes them, gicp) registered on CUDA tensors, each
    within t_err < 1.0 mm and a_err < 0.05 deg, with K1, K2, K7 (and K4 for
    robust) launched at least k times; a POINT + HUBER + adaptive
    registration of the synthetic pair (K3 and K4) within the same gate;
    the PLANE gate on the card against the CPU twins within 0.05 mm and
    0.005 deg.
4b. The marginal ms per iteration of PLANE and GICP, and K4, K7 and robust
    K3 against their twins.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
M, N_R = 16384, 256
ALPHA = 2e2  # the benchmark's blend (bench.py)
# Ground truth of __graft_entry__._synthetic_pair: +0.02 rad about z and
# t = (8, -5, 3) mm, for any seed.
Q_GT = np.array([0.0, 0.0, np.sin(0.01), np.cos(0.01)])
T_GT = np.array([8.0, -5.0, 3.0])
ROUNDS = 5
# Ground truth of the rendered gate pair (bench.py), and the errors the JAX
# reference recorded for each gate on its TPU run (BENCH_r05.json): printed
# beside the port's, not targets.
Q_GT_R = np.array([0.0, np.sin(0.004), 0.0, np.cos(0.004)])
T_GT_R = np.array([10.0, -6.0, 8.0])
REFERENCE_GATES = {"plane": (0.306, 0.0208), "plane_sym": (0.352, 0.0233),
                   "robust": (0.334, 0.0219), "gicp": (0.313, 0.0198)}
T_GATE, A_GATE = 1.0, 0.05  # bench.py's accuracy gate, mm and deg


def _run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def _errors(state, q_gt=Q_GT, t_gt=T_GT):
    """(t_err mm, a_err deg) of a registration against the ground truth."""
    from icp_tpu_torch.icp.quaternion import qangle_deg, qconj, qmul

    q_gt = torch.tensor(q_gt, dtype=torch.float32)
    t_err = float(np.linalg.norm(state.t.double().cpu().numpy() - t_gt))
    a_err = float(qangle_deg(qmul(state.q.cpu(), qconj(q_gt))))
    return t_err, a_err


def _rendered_pair():
    """bench.py's rendered gate pair as (fixed, moving, moving with 12 %
    gross outliers) landmark tensors on the CPU."""
    from icp_tpu_torch.ops.sampling import get_landmarks
    from icp_tpu_torch.sensors import synthetic

    scene = synthetic.default_scene()
    pose_b = synthetic.CameraPose(torch.tensor(Q_GT_R, dtype=torch.float32),
                                  torch.tensor(T_GT_R, dtype=torch.float32))
    la = get_landmarks(synthetic.render_cloud(
        scene, synthetic.CameraPose.identity()).reshape(-1, 8)).contiguous()
    lb = get_landmarks(synthetic.render_cloud(scene, pose_b).reshape(-1, 8)).contiguous()
    rng = np.random.default_rng(5)
    dirty = lb.numpy().copy()
    idx = rng.choice(dirty.shape[0], dirty.shape[0] // 8, replace=False)
    dirty[idx, :3] += (rng.uniform(250, 500, (len(idx), 3))
                       * rng.choice([-1.0, 1.0], (len(idx), 3))).astype(np.float32)
    return la, lb, torch.from_numpy(dirty)


def _rel_err(got, want) -> tuple[float, float]:
    """(max|got - want|, max|want|)."""
    return float((got - want).abs().max()), float(want.abs().max())


def _cuda_ms(fn, reps: int = 20) -> float:
    """Mean device ms of one call of ``fn`` over ``reps`` back-to-back calls.

    The card first spins for ~0.2 s, so the host has queued every call
    before the start event runs: the events then time the device work and
    not the host's launch rate (a kernel of a few microseconds is shorter
    than its Python wrapper).
    """
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(400_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    from __graft_entry__ import _synthetic_pair
    from icp_tpu_torch import (ICPConfig, ICPParams, Objective, RobustKernel,
                               Weighting, register)
    from icp_tpu_torch.icp.quaternion import qrotate
    from icp_tpu_torch.icp.run import build_index
    from icp_tpu_torch.icp.state import identity_state
    from icp_tpu_torch.kernels import fused_gn as fg
    from icp_tpu_torch.kernels import fused_step as fs
    from icp_tpu_torch.kernels import native
    from icp_tpu_torch.kernels import table_build as tb
    from icp_tpu_torch.ops.moments import masked_median
    from icp_tpu_torch.ops.normals import normals_for
    from icp_tpu_torch.rbc import grouping

    dev = torch.device("cuda", 0)

    # ---- 1. Device and build ----------------------------------------------
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader", "--id=0"])
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}); "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    print(_run([native._nvcc(), "--version"]).splitlines()[-1], flush=True)
    native.load_library()
    print(f"kernel build: {native.build_info['seconds']:.2f} s "
          f"({native.build_info['path']})", flush=True)
    for line in native.build_info["log"].splitlines():
        if any(k in line for k in ("registers", "Compiling entry", "spill", "== ")):
            print("  ptxas:", line.strip(), flush=True)

    cfg = ICPConfig()
    params = ICPParams(alpha=ALPHA)
    fixed_np, moving_np = _synthetic_pair(M, seed=0)
    fixed = torch.from_numpy(fixed_np).to(dev)
    moving = torch.from_numpy(moving_np).to(dev)

    # ---- 2. Kernels against their twins, first iteration's tensors ---------
    index = build_index(fixed, params.to(dev), cfg)
    st0 = identity_state(torch.float32, dev)
    alpha = torch.tensor(ALPHA, dtype=torch.float32, device=dev)
    G, b_row = fs.prep_similarity(st0.q, st0.t, st0.s)
    G = G.contiguous()
    C, srow = fs.prep_rep_assign(index.reps, alpha, G, b_row)
    C = C.contiguous()

    rid_k, counts_k = fs.rep_assign_counts(moving, C, srow)
    rid_t, counts_t = fs.rep_assign_counts_ref(moving, C, srow)
    torch.cuda.synchronize()
    if not torch.equal(counts_k, torch.bincount(rid_k, minlength=N_R).to(torch.int32)):
        raise AssertionError("K1 counts != bincount(rid)")
    if int(counts_k.sum()) != M:
        raise AssertionError(f"K1 counts sum {int(counts_k.sum())} != {M}")
    agree = float((rid_k == rid_t).float().mean())
    score64 = srow.double() - 2.0 * (moving.double() @ C.double())
    best64 = score64.min(dim=1).values
    picked = score64.gather(1, rid_k.long()[:, None])[:, 0]
    excess = ((picked - best64) / best64.abs().clamp(min=1.0))
    diff = rid_k != rid_t
    worst = float(excess[diff].max()) if bool(diff.any()) else 0.0
    print(f"K1 rep_assign_counts: rid agreement {agree:.6f} "
          f"({int(diff.sum())} of {M} differ), worst float64 excess of a "
          f"differing pick {worst:.3e}", flush=True)
    if agree < 0.999:
        raise AssertionError(f"K1 rid agreement {agree} < 0.999")
    if worst > 1e-5:
        raise AssertionError(f"K1 differing pick is not a near-tie: {worst}")
    k1_err = int((counts_k - counts_t).abs().max())

    sidx, counts, offsets, valid = grouping.bin_sort_layout(
        rid_k, N_R, cfg.query_capacity, counts=counts_k)
    sorted_rows = torch.index_select(moving, 0, sidx).contiguous()
    table_k = tb.bin_table(sorted_rows, offsets, capacity=cfg.query_capacity)
    table_t = tb.bin_table_ref(sorted_rows, offsets, capacity=cfg.query_capacity)
    torch.cuda.synchronize()
    if not torch.equal(table_k.view(torch.int32), table_t.view(torch.int32)):
        raise AssertionError("K2 bin_table is not bitwise equal to its twin")
    k2_err = float((table_k - table_t).abs().max())
    print("K2 bin_table: bitwise equal to its twin", flush=True)

    qvalid = valid.to(torch.float32)
    k3_args = (table_k, qvalid, index.reps, index.bins_centered,
               index.sq_b_masked, G, b_row, alpha)
    P_k = fs.bin_point_moments(*k3_args, weighted=True)
    P_t = fs.bin_point_moments_ref(*k3_args, weighted=True)
    torch.cuda.synchronize()
    k3_err = float((P_k - P_t).abs().max())
    k3_scale = float(P_t.abs().max())
    print(f"K3 bin_point_moments: max|dP| {k3_err:.4e} vs max|P| "
          f"{k3_scale:.4e} (ratio {k3_err / k3_scale:.3e}, bound 1e-4)",
          flush=True)
    if not k3_err <= 1e-4 * k3_scale:
        raise AssertionError("K3 disagrees with its twin")

    # ---- 2b. Slice-2 kernels against their twins, rendered pair ------------
    la, lb, lb_dirty = _rendered_pair()
    fa_d, lb_d, dirty_d = la.to(dev), lb.to(dev), lb_dirty.to(dev)
    cfg_p = ICPConfig(objective=Objective.PLANE, estimate_scale=False)
    index_p = build_index(fa_d, params.to(dev), cfg_p)
    Gp, bp = fs.prep_similarity(st0.q, st0.t, st0.s)
    Gp = Gp.contiguous()
    Cp, srowp = fs.prep_rep_assign(index_p.reps, alpha, Gp, bp)
    rid_p, counts_p = fs.rep_assign_counts(lb_d, Cp.contiguous(), srowp)
    mnr = qrotate(st0.q, normals_for(lb_d, "auto"))
    gl = grouping.group_rows_by_bin(rid_p, N_R, cfg_p.query_capacity, (lb_d, mnr),
                                    counts=counts_p)
    mg11, nm11 = gl.grouped  # strided views of one (n_r, cq, 11) table
    qv = gl.valid.to(torch.float32)
    search = (index_p.reps, index_p.bins_centered, index_p.sq_b_masked, Gp, bp, alpha)
    k4_args = (mg11, qv) + search
    d2_k = fs.bin_min_dists(*k4_args)
    d2_t = fs.bin_min_dists_ref(*k4_args)
    torch.cuda.synchronize()
    fin = torch.isfinite(d2_t)
    if not torch.equal(torch.isfinite(d2_k), fin):
        raise AssertionError("K4 +inf slots differ from its twin")
    k4_err, k4_scale = _rel_err(d2_k[fin], d2_t[fin])
    print(f"K4 bin_min_dists: {int(fin.sum())} finite of {fin.numel()} slots, "
          f"max|dd2| {k4_err:.4e} vs max d2 {k4_scale:.4e} (ratio "
          f"{k4_err / k4_scale:.3e}, bound 1e-6)", flush=True)
    if not k4_err <= 1e-6 * k4_scale:
        raise AssertionError("K4 disagrees with its twin")

    gn_args = {}
    k7_err = 0.0
    for mode in fg.GN_MODES:
        a = (mg11, None if mode == "plane" else nm11, qv, index_p.reps,
             index_p.bins_vals12, index_p.sq_b_masked, Gp, bp, alpha)
        kw = dict(mode=mode, weighted=True, gicp_eps=1e-3)
        gn_args[mode] = (a, kw)
        out_k = fg.bin_gn_moments(*a, **kw)
        out_t = fg.bin_gn_moments_ref(*a, **kw)
        again = fg.bin_gn_moments(*a, **kw)
        torch.cuda.synchronize()
        pairs = zip(("P", "P_z"), *((o if mode == "gicp" else (o,))
                                    for o in (out_k, out_t, again)))
        for name, got, want, rep in pairs:
            err, scale = _rel_err(got, want)
            k7_err = max(k7_err, err)
            print(f"K7 bin_gn_moments {mode} {name}: max|d{name}| {err:.4e} vs "
                  f"max|{name}| {scale:.4e} (ratio {err / scale:.3e}, bound 1e-4); "
                  f"repeats bitwise: {torch.equal(got, rep)}", flush=True)
            if not err <= 1e-4 * scale:
                raise AssertionError(f"K7 {mode} {name} disagrees with its twin")
            if not torch.equal(got, rep):
                raise AssertionError(f"K7 {mode} {name} does not repeat bitwise")

    # A fixed robust scale at the median residual of the first iteration,
    # so about half of the pairs sit on each side of it.
    delta = float(torch.sqrt(masked_median(d2_t, fin)))
    mg8 = mg11.contiguous()
    k3r_args = {}
    k3r_err = 0.0
    for robust, weighted in (("huber", True), ("trimmed", False)):
        a = (mg8, qv) + search
        kw = dict(weighted=weighted, robust=robust, robust_delta=delta)
        k3r_args[robust] = (a, kw)
        P_k = fs.bin_point_moments(*a, **kw)
        P_t = fs.bin_point_moments_ref(*a, **kw)
        torch.cuda.synchronize()
        err, scale = _rel_err(P_k, P_t)
        k3r_err = max(k3r_err, err)
        print(f"K3 bin_point_moments {robust} (delta {delta:.4f}): max|dP| "
              f"{err:.4e} vs max|P| {scale:.4e} (ratio {err / scale:.3e}, "
              f"bound 1e-4)", flush=True)
        if not err <= 1e-4 * scale:
            raise AssertionError(f"K3 {robust} disagrees with its twin")

    # ---- 3. The slice: three flagship registrations ------------------------
    counters = {"rep_assign_counts": fs.rep_assign_counts,
                "bin_table": tb.bin_table,
                "bin_point_moments": fs.bin_point_moments,
                "bin_min_dists": fs.bin_min_dists,
                "bin_gn_moments": fg.bin_gn_moments}
    launches = dict.fromkeys(counters, 0)

    def drive(fixed_t, moving_t, prm, config):
        """One registration on the main path: every count set to 0 just
        before it and read just after it."""
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        state = register(fixed_t, moving_t, prm, config)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ran = {name: fn.launches for name, fn in counters.items()}
        for name, n in ran.items():
            launches[name] += n
        return state, wall, ran

    def require_launched(ran, names, k, what):
        for name in names:
            if ran[name] < k:
                raise AssertionError(f"{what}: {name} launched {ran[name]} < k={k} times")

    results = {}
    for seed in (0, 1, 2):
        f_np, m_np = _synthetic_pair(M, seed=seed)
        st, wall, ran = drive(torch.from_numpy(f_np).to(dev),
                              torch.from_numpy(m_np).to(dev), params, cfg)
        k = int(st.k)
        t_err, a_err = _errors(st)
        results[seed] = st
        print(f"register seed {seed} on {torch.cuda.get_device_name(0)}: k={k} "
              f"t_err={t_err:.6f} mm a_err={a_err:.7f} deg wall={wall:.3f} s "
              f"launches={ran}", flush=True)
        if not (t_err < 0.05 and a_err < 0.005):
            raise AssertionError(f"seed {seed}: registration off the ground truth")
        require_launched(ran, ("rep_assign_counts", "bin_table", "bin_point_moments"),
                         k, f"seed {seed}")

    before = {name: fn.launches for name, fn in counters.items()}
    st_cpu = register(torch.from_numpy(fixed_np), torch.from_numpy(moving_np),
                      params, cfg)
    if any(fn.launches != before[name] for name, fn in counters.items()):
        raise AssertionError("a CPU registration launched a kernel")
    from icp_tpu_torch.icp.quaternion import qangle_deg, qconj, qmul

    st_gpu = results[0]
    dt = float(np.linalg.norm(st_gpu.t.double().cpu().numpy()
                              - st_cpu.t.double().numpy()))
    dang = float(qangle_deg(qmul(st_gpu.q.cpu(), qconj(st_cpu.q))))
    print(f"seed 0 card vs CPU twins: k {int(st_gpu.k)} vs {int(st_cpu.k)} "
          f"(JAX reference on CPU: 10), |dt|={dt:.6f} mm, dangle={dang:.7f} deg",
          flush=True)
    if not (dt <= 0.01 and dang <= 0.001):
        raise AssertionError("card and CPU registrations disagree")

    # ---- 3b. Slice 2: the bench gates on the rendered pair -----------------
    gates = {
        "plane": (ICPConfig(objective=Objective.PLANE, estimate_scale=False), lb_d),
        "plane_sym": (ICPConfig(objective=Objective.PLANE, plane_symmetric=True,
                                estimate_scale=False), lb_d),
        "robust": (ICPConfig(objective=Objective.PLANE, weighting=Weighting.REGULAR,
                             robust=RobustKernel.TRIMMED, robust_adaptive=True,
                             estimate_scale=False), dirty_d),
        "gicp": (ICPConfig(objective=Objective.GICP, estimate_scale=False), lb_d),
    }
    gate_states = {}
    for name, (config, moving_t) in gates.items():
        st, wall, ran = drive(fa_d, moving_t, params, config)
        k = int(st.k)
        t_err, a_err = _errors(st, Q_GT_R, T_GT_R)
        gate_states[name] = st
        ref_t, ref_a = REFERENCE_GATES[name]
        print(f"gate {name} on {torch.cuda.get_device_name(0)}: k={k} "
              f"t_err={t_err:.6f} mm a_err={a_err:.7f} deg wall={wall:.3f} s "
              f"launches={ran} (JAX reference on its TPU run: {ref_t} mm, "
              f"{ref_a} deg)", flush=True)
        if not (t_err < T_GATE and a_err < A_GATE):
            raise AssertionError(f"gate {name}: registration off the ground truth")
        need = ["rep_assign_counts", "bin_table", "bin_gn_moments"]
        require_launched(ran, need + (["bin_min_dists"] if name == "robust" else []),
                         k, f"gate {name}")

    f_np, m_np = _synthetic_pair(M, seed=0)
    st, wall, ran = drive(torch.from_numpy(f_np).to(dev), torch.from_numpy(m_np).to(dev),
                          params, ICPConfig(robust=RobustKernel.HUBER, robust_adaptive=True))
    k = int(st.k)
    t_err, a_err = _errors(st)
    print(f"POINT + HUBER + adaptive, seed 0: k={k} t_err={t_err:.6f} mm "
          f"a_err={a_err:.7f} deg wall={wall:.3f} s launches={ran}", flush=True)
    if not (t_err < T_GATE and a_err < A_GATE):
        raise AssertionError("POINT + HUBER: registration off the ground truth")
    require_launched(ran, ("bin_point_moments", "bin_min_dists"), k, "POINT + HUBER")

    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} never launched on the main path")

    before = {name: fn.launches for name, fn in counters.items()}
    st_cpu = register(la, lb, params, gates["plane"][0])
    if any(fn.launches != before[name] for name, fn in counters.items()):
        raise AssertionError("a CPU registration launched a kernel")
    st_gpu = gate_states["plane"]
    dt = float(np.linalg.norm(st_gpu.t.double().cpu().numpy() - st_cpu.t.double().numpy()))
    dang = float(qangle_deg(qmul(st_gpu.q.cpu(), qconj(st_cpu.q))))
    print(f"gate plane card vs CPU twins: k {int(st_gpu.k)} vs {int(st_cpu.k)}, "
          f"|dt|={dt:.6f} mm, dangle={dang:.7f} deg", flush=True)
    if not (dt <= 0.05 and dang <= 0.005):
        raise AssertionError("PLANE card and CPU registrations disagree")

    # ---- 4. Times (printed, not gated) ------------------------------------
    fast = ICPParams(alpha=ALPHA, angle_threshold_deg=0.0,
                     translation_threshold=0.0)
    best = {40: float("inf"), 8: float("inf")}
    for _ in range(ROUNDS):
        for iters in (40, 8):
            t0 = time.perf_counter()
            st = register(fixed, moving, fast, ICPConfig(max_iterations=iters))
            torch.cuda.synchronize()
            best[iters] = min(best[iters], time.perf_counter() - t0)
            if int(st.k) != iters:
                raise AssertionError(f"k={int(st.k)} != {iters}")
    per_iter = (best[40] - best[8]) / 32 * 1e3
    print(f"marginal ms/iteration at {M}x{N_R}: {per_iter} "
          f"(T40 {best[40] * 1e3} ms, T8 {best[8] * 1e3} ms, "
          f"min of {ROUNDS} alternating rounds)", flush=True)

    for objective in (Objective.PLANE, Objective.GICP):
        best = {40: float("inf"), 8: float("inf")}
        for _ in range(3):
            for iters in (40, 8):
                t0 = time.perf_counter()
                st = register(fa_d, lb_d, fast, ICPConfig(
                    objective=objective, estimate_scale=False, max_iterations=iters))
                torch.cuda.synchronize()
                best[iters] = min(best[iters], time.perf_counter() - t0)
                if int(st.k) != iters:
                    raise AssertionError(f"k={int(st.k)} != {iters}")
        print(f"{objective.name} marginal ms/iteration at {M}x{N_R} (rendered pair): "
              f"{(best[40] - best[8]) / 32 * 1e3} (T40 {best[40] * 1e3} ms, "
              f"T8 {best[8] * 1e3} ms, min of 3 alternating rounds)", flush=True)

    table_args = (sorted_rows, offsets)
    pairs = {
        "rep_assign_counts": (lambda: fs.rep_assign_counts(moving, C, srow),
                              lambda: fs.rep_assign_counts_ref(moving, C, srow)),
        "bin_table": (lambda: tb.bin_table(*table_args, capacity=cfg.query_capacity),
                      lambda: tb.bin_table_ref(*table_args, capacity=cfg.query_capacity)),
        "bin_point_moments": (lambda: fs.bin_point_moments(*k3_args, weighted=True),
                              lambda: fs.bin_point_moments_ref(*k3_args, weighted=True)),
        "bin_min_dists": (lambda: fs.bin_min_dists(*k4_args),
                          lambda: fs.bin_min_dists_ref(*k4_args)),
    }
    for mode, (a, kw) in gn_args.items():
        pairs[f"bin_gn_moments {mode}"] = (
            lambda a=a, kw=kw: fg.bin_gn_moments(*a, **kw),
            lambda a=a, kw=kw: fg.bin_gn_moments_ref(*a, **kw))
    for robust, (a, kw) in k3r_args.items():
        pairs[f"bin_point_moments {robust}"] = (
            lambda a=a, kw=kw: fs.bin_point_moments(*a, **kw),
            lambda a=a, kw=kw: fs.bin_point_moments_ref(*a, **kw))
    times = {}
    for name, (kernel, twin) in pairs.items():
        k_ms, t_ms = float("inf"), float("inf")
        for _ in range(3):  # alternate kernel and twin; keep each minimum
            k_ms = min(k_ms, _cuda_ms(kernel))
            t_ms = min(t_ms, _cuda_ms(twin))
        times[name] = (k_ms, t_ms)
        print(f"{name}: kernel {k_ms} ms, plain twin {t_ms} ms", flush=True)

    meta = {
        "rep_assign_counts": ("icp_tpu_torch/csrc/rep_assign_counts.cu",
                              "icp_tpu/kernels/fused_step.py:372", k1_err),
        "bin_table": ("icp_tpu_torch/csrc/bin_table.cu",
                      "icp_tpu/kernels/table_build.py:79", k2_err),
        "bin_point_moments": ("icp_tpu_torch/csrc/bin_point_moments.cu",
                              "icp_tpu/kernels/fused_step.py:564",
                              max(k3_err, k3r_err)),
        "bin_min_dists": ("icp_tpu_torch/csrc/bin_min_dists.cu",
                          "icp_tpu/kernels/fused_step.py:689", k4_err),
        "bin_gn_moments": ("icp_tpu_torch/csrc/bin_gn_moments.cu",
                           "icp_tpu/kernels/fused_gn.py:318", k7_err),
    }
    # A kernel with several modes reports its slowest mode.
    for name in meta:
        modes = [t for key, t in times.items() if key.split()[0] == name]
        times[name] = (max(t[0] for t in modes), max(t[1] for t in modes))
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], "max_abs_err": err,
                "ms": times[name][0], "plain_ms": times[name][1]}
               for name, (src, rep, err) in meta.items()]
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(f"chip_smoke wall time: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
