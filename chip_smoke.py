#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (icp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; there is no CPU fallback):

1. Device: require CUDA, print the card (nvidia-smi name and power limit),
   the torch and nvcc versions, and build the kernels from csrc/.
2. Kernels against their plain PyTorch twins on the card, on the tensors of
   the first iteration of the flagship pair (m=16384, n_r=256): K2 bitwise;
   K1 exact counts and every rid equal to the twin's, K1′ equal to K1; K3
   max|dP| <= 1e-4 max|P| and a second launch bitwise equal to the first.
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
    the largest; K7's P and P_z and K3's P within 1e-4 of max|P|, each
    repeating bitwise.
3b. The four bench gates (plane, plane_sym, robust with 12 % gross outliers
    made as bench.py makes them, gicp) registered on CUDA tensors, each
    within t_err < 1.0 mm and a_err < 0.05 deg, with K1, K2, K7 (and K4 for
    robust) launched at least k times; a POINT + HUBER + adaptive
    registration of the synthetic pair (K3 and K4) within the same gate;
    the PLANE gate on the card against the CPU twins within 0.05 mm and
    0.005 deg.
4b. The marginal ms per iteration of PLANE and GICP, and K4, K7 and robust
    K3 against their twins.

Slices 3 and 4 (the unfused per-pair pipeline: RBC grouped search with K5,
BRUTE with K6, and K1′) add:

2c. K5 on the tables the
    unfused step passes it (taken from icp_step itself) on the synthetic
    flagship pair (V = 8), on the rendered pair with normals (V = 12) and
    at n_r = 16 (cb = 2048): scores and payloads bitwise; K3 on what the
    fused step hands it at n_r 32 and 16 (cq 768 / 1536, cb 1024 / 2048:
    several query and bin tiles) within 1e-4 of max|P| and repeating
    bitwise; K7 (three modes) on what GICP steps hand it at n_r 32 and 16
    under the same rule; K6 on the 16384 x 16384 BRUTE step: every index and
    score bitwise, with the mean and largest number of pairs its filter
    re-scored per query, and on the adversarial sets of sensors/brute_sets.py
    (uncentred coordinates, duplicates, equal-distance shells, scores ulps
    apart), bitwise. K6's margin probe, through its C entry point and not
    counted as launches: on each of those sets the margin is cut by 2, 4,
    8, ... (and to its floor) until an output differs from the twin's, and
    the largest cut that kept every output bitwise is printed (the margin's
    headroom on the card); and the sweep's time with no pair re-scored (a
    margin of -inf) beside its time with the margin.
2d. K2 at the 16x layout (262144 rows, 2048 bins, cap 256, d = 8 and 11),
    the shape of the windowed TPU variant, bitwise against its twin.
3c. BRUTE POINT on the synthetic pair (seeds 0, 1, 2) within 0.05 mm and
    0.005 deg; BRUTE PLANE and the unfused PLANE, plane_sym, GICP and
    robust gates within 1.0 mm and 0.05 deg; the two-phase POINT step
    (rbc_point_assign, K1′) equal to the K1 step; BRUTE POINT (4096
    landmarks) and unfused PLANE on the card against the CPU twins; the
    fused step against the unfused step on the card (q and qk within 1e-5,
    tk within 0.05 mm); each registration launched its kernels >= k times.
4c. The marginal ms per iteration of BRUTE POINT and unfused PLANE, and
    K1′, K5, K6 and K2 at 16x against their twins.

Slice 5 (kNN normals of unorganized clouds: K9 rep_top2_counts and K8
bin_knn_moments) adds, on the reference's wavy-surface pairs
(icp_tpu_torch.sensors.synthetic.wavy_surface_pair):

2e. K9 at the LiDAR shape (262144 raw points, 2048 Morton reps) against its
    twin: counts exact and equal to the bincounts of the kernel's own ids,
    i1 and i2 agreement >= 99.9 % with every disagreement a float64
    near-tie; K8 on the tables the estimator builds there (n_r 2048, cq 192,
    cb 384, k 16): n bitwise, components within 1e-5 of each query's
    largest, and the normals of the two within cos 0.9999 on >= 99.9 % of
    the slots. K9's and K8's arguments come from one call of the estimator.
2f. The per-step kernels of the 16x paths, on the arguments the steps hand
    them: K1 and K1′ at the LiDAR PLANE step (262144 x 2048) under phase
    2's rule (every rid equal to the twin's), K7 plane there (cq 192, cb
    256), K7 plane_sym and gicp at the LiDAR GICP step, and K3 at the 16x
    POINT step, each P within 1e-4 of max|P| and repeating bitwise.
3d. The reference's LiDAR gate: PLANE at m 262144, n_r 2048 with
    normal_mode "knn" (the RBC estimator) within 1.0 mm and 0.05 deg, K9
    and K8 launched, K1, K2 and K7 at least k times; the estimator on the
    card against the analytic normals (median |cos| > 0.999, >= 95 % above
    0.99, < 2 % zero normals) and at 16384 points against the CPU twins
    (the same zero set, |dn| <= 1e-4 on >= 99.9 % of rows); GICP with
    "knn_rbc" at 16384 points, and the reference's 4x and 16x POINT gates
    (65536 x 1024, 262144 x 2048), each within the gate.
4d. Times: K9, K8, K7 (three modes), K3 and K1 at the 16x shape against
    their twins, the estimator's ms per call at 262144 points and the
    marginal ms per iteration of the LiDAR PLANE registration and the 4x /
    16x POINT cells.

The line before the last is {"kernels": [...]}: per kernel its launches on
the main path, its largest error against the twin over every shape checked
(and, for K1, K1′, K2, K3 and K7, max_abs_err_16x at the 16x shape apart), its
time and the twin's, and its
bound, the larger of the time of the operations of the work and of its
bytes (each input read once, each output written once) over 3.35 TB/s. The
operations are fp32 over 67 TFLOP/s (K3, K4 and K7 count the pairs of valid
query slots and finite bin slots); K6's are the work of its design: 3 x 2 x
8 TF32 flops per pair over 495 TFLOP/s, or its fp32 epilogue (the fma of the
score and a min, 3 operations per pair) over 67 TFLOP/s, whichever takes
longer. K1, K3 and K7 add ms_16x and bound_ms_16x at the 16x step shape, K6
its re-scored pairs per query (mean and largest), the margin's headroom per
set and the sweep's time with no re-score. library_ms is null, since
no single PyTorch call computes any of these functions. The last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

M, N_R = 16384, 256
ALPHA = 2e2  # the benchmark's blend (bench.py)
# Ground truth of icp_tpu_torch.sensors.synthetic.synthetic_pair: +0.02 rad about z and
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
M_L, N_R_L = 262144, 2048  # the LiDAR gate and the 16x cell
# The reference's errors on its TPU run (BENCH_r05.json), printed beside the
# port's scaled-shape gates: not targets.
REFERENCE_SCALE = {"lidar": (0.0006, 1e-05), "icp_4x": (0.3154, 0.00957),
                   "icp_16x": (0.162, 0.00375)}
# H100 SXM peaks (NVIDIA's data sheet, dense): fp32 outside the tensor
# cores, TF32 on them, HBM3.
PEAK_FP32, PEAK_TF32, PEAK_BYTES = 67e12, 495e12, 3.35e12


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


def _capture_all(module, names: tuple[str, ...], call) -> dict:
    """{name: (args, kwargs)} of the first call that ``call()`` makes to each
    ``module.name``: the tensors the main path hands the kernels' wrappers."""
    origs = {name: getattr(module, name) for name in names}
    seen = {}

    def spy(name):
        def wrapped(*args, **kwargs):
            seen.setdefault(name, (args, kwargs))
            return origs[name](*args, **kwargs)
        return wrapped

    for name in names:
        setattr(module, name, spy(name))
    try:
        call()
    finally:
        for name, orig in origs.items():
            setattr(module, name, orig)
    torch.cuda.synchronize()
    return seen


def _capture(module, name: str, call):
    """The (args, kwargs) of the first call that ``call()`` makes to
    ``module.name``."""
    return _capture_all(module, (name,), call)[name]


def _check_rep_assign(fs, moving8, C, srow, what: str) -> tuple:
    """K1 and K1′ against their twin: counts equal the bincount of the
    kernel's own rids, sum to m and equal the twin's; K1's rid equal to the
    twin's on every row (the same lane-order rounding) and K1′'s equal to
    K1's. Returns (rid, counts, max|dcounts| against the twin, rids of K1′
    off the twin)."""
    m, n_r = moving8.shape[0], C.shape[1]
    rid_k, counts_k = fs.rep_assign_counts(moving8, C, srow)
    rid_1 = fs.rep_assign(moving8, C, srow)
    rid_t, counts_t = fs.rep_assign_counts_ref(moving8, C, srow)
    torch.cuda.synchronize()
    if not torch.equal(counts_k, torch.bincount(rid_k, minlength=n_r).to(torch.int32)):
        raise AssertionError(f"K1 {what}: counts != bincount(rid)")
    if int(counts_k.sum()) != m:
        raise AssertionError(f"K1 {what}: counts sum {int(counts_k.sum())} != {m}")
    n_diff = int((rid_k != rid_t).sum())
    n_diff1 = int((rid_1 != rid_t).sum())
    print(f"K1 rep_assign_counts {what} ({m} x {n_r}): {n_diff} of {m} rids differ "
          f"from the twin (bound 0), counts equal to the twin's: "
          f"{torch.equal(counts_k, counts_t)}; K1' rep_assign: {n_diff1} differ, "
          f"equal to K1's: {torch.equal(rid_1, rid_k)}", flush=True)
    if n_diff or not torch.equal(counts_k, counts_t):
        raise AssertionError(f"K1 {what}: {n_diff} rids differ from the twin")
    if not torch.equal(rid_1, rid_k):
        raise AssertionError(f"K1' {what}: rid differs from K1's")
    return rid_k, counts_k, int((counts_k - counts_t).abs().max()), n_diff1


def _check_moments(what: str, kernel, twin, args, kwargs) -> float:
    """A moment kernel (K3, K7) against its twin: every output within 1e-4
    of its largest entry, and a second launch bitwise equal to the first.
    Returns max|dP|."""
    got, want, again = kernel(*args, **kwargs), twin(*args, **kwargs), kernel(*args, **kwargs)
    torch.cuda.synchronize()
    if isinstance(got, torch.Tensor):
        got, want, again = (got,), (want,), (again,)
    worst = 0.0
    for name, g, w, a in zip(("P", "P_z"), got, want, again):
        err, scale = _rel_err(g, w)
        worst = max(worst, err)
        print(f"{what} {name}: max|d{name}| {err:.4e} vs max|{name}| {scale:.4e} (ratio "
              f"{err / scale:.3e}, bound 1e-4); repeats bitwise: {torch.equal(g, a)}",
              flush=True)
        if not err <= 1e-4 * scale:
            raise AssertionError(f"{what} {name} disagrees with its twin")
        if not torch.equal(g, a):
            raise AssertionError(f"{what} {name} does not repeat bitwise")
    return worst


def _bitwise(got, want) -> bool:
    return torch.equal(got.contiguous().view(torch.int32),
                       want.contiguous().view(torch.int32))


def _finite_err(got, want) -> float:
    """max|got - want| over the entries where both are finite."""
    fin = torch.isfinite(got) & torch.isfinite(want)
    return float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0


def _tensors(x) -> list:
    """Every tensor in a nested tuple / list / dict."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _tensors(y)]
    return []


def _work(name: str, args, kwargs, out) -> tuple[float, int]:
    """(ms of the operations at the card's peak, bytes) of one kernel call:
    the bytes read each input and write each output once; the operations are
    counted from the inner loops. A bf16x3 score over 8 lanes is three
    15-operation lane products, 2 adds, the scaled subtraction and a compare
    (50 fp32 operations per query-candidate pair; an FMA counts as two);
    over 3 lanes 21. Per query or per neighbour terms are added where the
    kernel has them. K3, K4 and K7 count the pairs their inputs hold: valid
    query slots times the finite slots of their bin. K6 scores every pair on
    the tensor cores (three m16n8k8 TF32 products, 48 flops a pair) beside
    an fp32 epilogue of 3 operations a pair."""
    nbytes = sum(t.numel() * t.element_size() for t in _tensors((args, kwargs, out)))
    a = args
    if name in ("rep_assign_counts", "rep_assign"):
        ops = 50 * a[0].shape[0] * a[1].shape[1]
    elif name == "bin_table":
        ops = 0
    elif name == "brute_nn":
        pairs = a[0].shape[0] * a[1].shape[0]
        return max(48 * pairs / PEAK_TF32, 3 * pairs / PEAK_FP32) * 1e3, nbytes
    elif name == "bin_search":
        ops = 50 * a[0].shape[0] * a[0].shape[1] * a[1].shape[1]
    elif name == "rep_top2_counts":
        ops = 21 * a[0].shape[0] * a[1].shape[0]
    elif name == "bin_knn_moments":  # d2, 18 bisection passes, membership;
        n_r, cq = a[0].shape[:2]     # 40 per admitted neighbour
        ops = 60 * n_r * cq * a[1].shape[1] + 40 * float(out[1].sum()) + 100 * n_r * cq
    else:  # K3, K4, K7: the search, then per query the transform and rows
        gn = name == "bin_gn_moments"
        kept = (a[2 if gn else 1] != 0).sum(dim=1).double()
        live = torch.isfinite(a[5 if gn else 4]).sum(dim=1).double()
        # Pairs the data needs: each valid query slot (qvalid != 0) against
        # the finite slots of its bin, not every padded slot.
        ops = 50 * float((kept * live).sum()) + 400 * float(kept.sum())
    return ops / PEAK_FP32 * 1e3, nbytes


def _bound(t_ops: float, nbytes: int) -> tuple[float, str]:
    """(least ms the card could take, what bounds it)."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _brute_raw(native, args, kappa: float, floor: float):
    """K6 through its C entry point with the margin's constants given
    (eps_i = kappa (S + 2 A_i) + floor; the wrapper passes KAPPA 2^-20 and
    MARGIN_FLOOR). Not a launch of the main path: the counter stays."""
    qw, db, sq = args
    m, n = qw.shape[0], db.shape[0]
    ms = torch.empty((9,), dtype=torch.float32, device=qw.device)
    idx = torch.empty((m,), dtype=torch.int32, device=qw.device)
    score = torch.empty((m,), dtype=torch.float32, device=qw.device)
    native.check(native.load_library().icp_brute_nn(
        qw.data_ptr(), db.data_ptr(), sq.data_ptr(), ms.data_ptr(), kappa, floor, m, n,
        idx.data_ptr(), score.data_ptr(), None, native.stream_ptr(qw.device)), "icp_brute_nn")
    return idx, score


def _margin_headroom(bn, native, args) -> dict:
    """Cuts K6's margin by 2, 4, 8, ... 2^30, then to its floor alone
    ("floor"), until an output differs from the twin's. Returns the largest
    cut that kept every index and score bitwise ("floor" when even that
    did), and the cut that first did not (None when none did)."""
    idx_t, score_t = bn.brute_nn_ref(*args)
    held = 1.0
    for cut in [2.0 ** k for k in range(1, 31)] + ["floor"]:
        kappa = 0.0 if cut == "floor" else bn.KAPPA * 2.0 ** -20 / cut
        idx, score = _brute_raw(native, args, kappa, bn.MARGIN_FLOOR)
        if not (torch.equal(idx, idx_t) and _bitwise(score, score_t)):
            return {"held_to": held, "failed_at": cut}
        held = cut
    return {"held_to": held, "failed_at": None}


def _analytic_normals(cloud8: np.ndarray) -> np.ndarray:
    """Normals of the wavy surface z = 1500 + 80 sin(u/90) + 60 cos(v/70),
    oriented toward the sensor (the reference's tests/test_knn_normals.py)."""
    u, v = cloud8[:, 0].astype(np.float64), cloud8[:, 1].astype(np.float64)
    n = np.stack([80.0 / 90.0 * np.cos(u / 90.0), -60.0 / 70.0 * np.sin(v / 70.0),
                  -np.ones_like(u)], -1)
    return n / np.linalg.norm(n, axis=-1, keepdims=True)


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
    from icp_tpu_torch import (Correspondence, ICPConfig, ICPParams, Objective,
                               RobustKernel, Weighting, icp_step, register)
    from icp_tpu_torch.icp.quaternion import qrotate
    from icp_tpu_torch.icp.run import build_index
    from icp_tpu_torch.icp.state import identity_state
    from icp_tpu_torch.kernels import bin_search as bs
    from icp_tpu_torch.kernels import brute_nn as bn
    from icp_tpu_torch.kernels import fused_gn as fg
    from icp_tpu_torch.kernels import fused_step as fs
    from icp_tpu_torch.kernels import knn_moments as km
    from icp_tpu_torch.kernels import native
    from icp_tpu_torch.kernels import table_build as tb
    from icp_tpu_torch.ops import distance as distance_mod
    from icp_tpu_torch.ops.moments import masked_median
    from icp_tpu_torch.ops import normals as normals_mod
    from icp_tpu_torch.ops.normals import normals_for
    from icp_tpu_torch.ops.sampling import sample_representative_indices
    from icp_tpu_torch.rbc import grouping
    from icp_tpu_torch.rbc import search as search_mod
    from icp_tpu_torch.sensors.synthetic import synthetic_pair as _synthetic_pair
    from icp_tpu_torch.sensors.synthetic import wavy_surface_pair
    from icp_tpu_torch.sensors import brute_sets

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

    rid_k, counts_k, k1_err, k1p_err = _check_rep_assign(fs, moving, C, srow, "flagship")

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
    k3_err = _check_moments("K3 bin_point_moments flagship", fs.bin_point_moments,
                            fs.bin_point_moments_ref, k3_args, {"weighted": True})

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
        k7_err = max(k7_err, _check_moments(f"K7 bin_gn_moments {mode}", fg.bin_gn_moments,
                                            fg.bin_gn_moments_ref, a, kw))

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
        k3r_err = max(k3r_err, _check_moments(
            f"K3 bin_point_moments {robust} (delta {delta:.4f})", fs.bin_point_moments,
            fs.bin_point_moments_ref, a, kw))

    # ---- 2c. Slices 3-4: K1′, K5 and K6 against their twins ----------------
    # (K1′ is held against its twin and K1 with K1, in _check_rep_assign.)

    prm_d = params.to(dev)
    cfg_u = ICPConfig(fused_point=False)
    cfg_pu = ICPConfig(objective=Objective.PLANE, estimate_scale=False, fused_gn=False)
    cfg_16 = ICPConfig(n_r=16, fused_point=False)
    index_16 = build_index(fixed, prm_d, cfg_16)
    k5_cases = {  # name -> the arguments the unfused step hands K5
        "V=8 flagship": _capture(search_mod, "bin_search", lambda: icp_step(
            st0, moving, index, prm_d, cfg_u))[0],
        "V=12 rendered": _capture(search_mod, "bin_search", lambda: icp_step(
            st0, lb_d, index_p, prm_d, cfg_pu))[0],
        f"V=8 n_r=16 cb={cfg_16.bin_capacity}": _capture(
            search_mod, "bin_search", lambda: icp_step(st0, moving, index_16, prm_d,
                                                       cfg_16))[0],
    }
    k5_err = 0.0
    for name, a in k5_cases.items():
        best_k, matched_k = bs.bin_search(*a)
        best_t, matched_t = bs.bin_search_ref(*a)
        torch.cuda.synchronize()
        ok = _bitwise(best_k, best_t) and _bitwise(matched_k, matched_t)
        k5_err = max(k5_err, _finite_err(best_k, best_t), _finite_err(matched_k, matched_t))
        print(f"K5 bin_search {name}: qg_w {tuple(a[0].shape)}, bins {tuple(a[1].shape)}, "
              f"payload {tuple(a[3].shape)}; {int(torch.isinf(best_t).sum())} +inf "
              f"slots; scores and payloads bitwise: {ok}", flush=True)
        if not ok:
            raise AssertionError(f"K5 {name} differs from its twin")

    # K3 with few, large bins, where it walks several query and bin tiles:
    # n_r 32 gives cq 768 / cb 1024, n_r 16 cq 1536 / cb 2048.
    k3c_err = 0.0
    for n_r in (32, 16):
        cfg_k = ICPConfig(n_r=n_r)
        a, kw = _capture(search_mod, "bin_point_moments", lambda: icp_step(
            st0, moving, build_index(fixed, prm_d, cfg_k), prm_d, cfg_k))
        k3c_err = max(k3c_err, _check_moments(
            f"K3 bin_point_moments n_r={n_r} (cq {cfg_k.query_capacity}, "
            f"cb {cfg_k.bin_capacity})", fs.bin_point_moments, fs.bin_point_moments_ref,
            a, kw))

    # K7 likewise, on what GICP steps of the rendered pair hand it (every
    # mode reads those tables; plane ignores the moving normals).
    for n_r in (32, 16):
        cfg_k = ICPConfig(n_r=n_r, objective=Objective.GICP, estimate_scale=False)
        a, kw = _capture(search_mod, "bin_gn_moments", lambda: icp_step(
            st0, lb_d, build_index(fa_d, prm_d, cfg_k), prm_d, cfg_k))
        for mode in fg.GN_MODES:
            am = (a[0], None if mode == "plane" else a[1]) + tuple(a[2:])
            k7_err = max(k7_err, _check_moments(
                f"K7 bin_gn_moments {mode} n_r={n_r} (cq {cfg_k.query_capacity}, "
                f"cb {cfg_k.bin_capacity})", fg.bin_gn_moments, fg.bin_gn_moments_ref,
                am, dict(kw, mode=mode)))

    def check_brute(what, args) -> tuple[float, torch.Tensor]:
        """K6 against its twin: every index equal, every score bitwise.
        Returns (max|dscore| where finite, re-scored pairs per query)."""
        idx_k, score_k, rescored = bn.brute_nn(*args, count_rescored=True)
        idx_t, score_t = bn.brute_nn_ref(*args)
        torch.cuda.synchronize()
        same_idx = int((idx_k == idx_t).sum())
        r = rescored.double()
        print(f"K6 brute_nn {what} ({args[0].shape[0]} x {args[1].shape[0]}): idx equal on "
              f"{same_idx} of {idx_k.numel()} queries, scores bitwise: "
              f"{_bitwise(score_k, score_t)}; re-scored pairs per query: mean "
              f"{float(r.mean())}, max {int(r.max())}", flush=True)
        if not (same_idx == idx_k.numel() and _bitwise(score_k, score_t)):
            raise AssertionError(f"K6 {what} differs from its twin")
        return _finite_err(score_k, score_t), rescored

    cfg_b = ICPConfig(correspondence=Correspondence.BRUTE)
    k6_args = _capture(distance_mod, "brute_nn", lambda: icp_step(
        st0, moving, fixed, prm_d, cfg_b))[0]
    k6_err, k6_rescored = check_brute("flagship BRUTE step", k6_args)
    k6_sets = {"flagship": k6_args} | {
        name: tuple(torch.from_numpy(x).to(dev) for x in brute_sets.adversarial(name))
        for name in brute_sets.ADVERSARIAL}
    for name in brute_sets.ADVERSARIAL:
        k6_err = max(k6_err, check_brute(name, k6_sets[name])[0])
    # The margin's headroom on the card: a margin below the real error of
    # the tensor-core score can drop a winner, where a near-tie lies within
    # that error (a set without one, or whose error only lowers s~, holds
    # at any cut).
    k6_headroom = {name: _margin_headroom(bn, native, a) for name, a in k6_sets.items()}
    print(f"K6 margin headroom (largest cut of eps still bitwise, first cut that was "
          f"not): {json.dumps(k6_headroom)}", flush=True)
    k6_eps = (bn.KAPPA * 2.0 ** -20, bn.MARGIN_FLOOR)
    k6_full, k6_none = float("inf"), float("inf")
    for _ in range(3):  # alternate; keep each minimum
        k6_full = min(k6_full, _cuda_ms(lambda: _brute_raw(native, k6_args, *k6_eps)))
        k6_none = min(k6_none, _cuda_ms(lambda: _brute_raw(native, k6_args, k6_eps[0],
                                                           -float("inf"))))
    print(f"K6 flagship: {k6_full} ms with its margin, {k6_none} ms with no pair "
          f"re-scored (eps -inf)", flush=True)

    # ---- 2d. K2 at the 16x layout (the windowed TPU variant's shape) ---------
    m16, n_r16, cap16 = 262144, 2048, 256
    f16_np, m16_np = _synthetic_pair(m16, seed=0)
    f16, mv16 = torch.from_numpy(f16_np).to(dev), torch.from_numpy(m16_np).to(dev)
    reps16 = f16[sample_representative_indices(
        m16, n_r16, ICPConfig(m=m16, n_r=n_r16).rep_grid, device=dev).long()]
    C16, srow16 = fs.prep_rep_assign(reps16, alpha, G, b_row)
    rid16, counts16 = fs.rep_assign_counts(mv16, C16.contiguous(), srow16)
    sidx16, _, offsets16, _ = grouping.bin_sort_layout(rid16, n_r16, cap16, counts=counts16)
    rows16 = torch.cat([mv16, normals_for(mv16, "auto")], dim=1)
    k2x_args = {}
    for d in (8, 11):
        sorted16 = torch.index_select(rows16[:, :d].contiguous(), 0, sidx16).contiguous()
        k2x_args[d] = (sorted16, offsets16)
        got = tb.bin_table(sorted16, offsets16, capacity=cap16)
        want = tb.bin_table_ref(sorted16, offsets16, capacity=cap16)
        torch.cuda.synchronize()
        print(f"K2 bin_table 16x ({m16} rows, {n_r16} bins, cap {cap16}, d {d}; bins over "
              f"capacity {int((counts16 > cap16).sum())}, empty {int((counts16 == 0).sum())}):"
              f" bitwise equal to its twin: {_bitwise(got, want)}", flush=True)
        if not _bitwise(got, want):
            raise AssertionError(f"K2 at 16x, d {d}, differs from its twin")
    del f16, mv16, rows16

    # ---- 2e. Slice 5: K9 and K8 at the LiDAR shape ---------------------------
    wf_np, wm_np, q_l, t_l = wavy_surface_pair(M_L)
    wf, wm = torch.from_numpy(wf_np).to(dev), torch.from_numpy(wm_np).to(dev)
    # K9's and K8's arguments as the estimator hands them, from one call.
    knn_args = _capture_all(normals_mod, ("rep_top2_counts", "bin_knn_moments"),
                            lambda: normals_mod.knn_normals_rbc(wf))
    k9_args = knn_args["rep_top2_counts"][0]
    p_l, reps_l = k9_args
    if reps_l.shape[0] != N_R_L:
        raise AssertionError(f"the estimator chose {reps_l.shape[0]} reps, not {N_R_L}")
    top_k = km.rep_top2_counts(*k9_args)
    top_t = km.rep_top2_counts_ref(*k9_args)
    torch.cuda.synchronize()
    for j in range(2):
        if not torch.equal(top_k[2][j], torch.bincount(top_k[j], minlength=N_R_L).to(torch.int32)):
            raise AssertionError(f"K9 counts[{j}] != bincount of its own ids")
    r64 = reps_l.double()
    sq64 = torch.sum(r64 * r64, dim=1)
    k9_worst, k9_msg = 0.0, []
    for j in range(2):
        diff = top_k[j] != top_t[j]
        agree = 1.0 - float(diff.float().mean())
        k9_msg.append(f"i{j + 1} agreement {agree:.6f} ({int(diff.sum())} of {M_L} differ)")
        if agree < 0.999:
            raise AssertionError(f"K9 i{j + 1} agreement {agree} < 0.999")
        if bool(diff.any()):  # the raw score |r|^2 - 2 p.r in float64
            rows = torch.nonzero(diff)[:, 0]
            s64 = sq64[None, :] - 2.0 * (p_l[rows].double() @ r64.T)
            a = s64.gather(1, top_k[j][rows].long()[:, None])
            b = s64.gather(1, top_t[j][rows].long()[:, None])
            k9_worst = max(k9_worst, float(((a - b).abs() / b.abs().clamp(min=1.0)).max()))
    k9_err = int((top_k[2] - top_t[2]).abs().max())
    print(f"K9 rep_top2_counts {M_L} x {N_R_L}: counts equal the bincounts of its ids, "
          f"max|dcounts| vs twin {k9_err}; {', '.join(k9_msg)}; worst float64 "
          f"excess of a differing pick {k9_worst:.3e}", flush=True)
    if k9_worst > 1e-5:
        raise AssertionError(f"K9 differing pick is not a near-tie: {k9_worst}")

    k8_args, k8_kw = knn_args["bin_knn_moments"]
    comps_k, cnt_k = km.bin_knn_moments(*k8_args, **k8_kw)
    comps_t, cnt_t = km.bin_knn_moments_ref(*k8_args, **k8_kw)
    torch.cuda.synchronize()
    ck, ct = torch.stack(comps_k), torch.stack(comps_t)
    k8_err = float((ck - ct).abs().max())
    k8_rel = float(((ck - ct).abs() / ct.abs().amax(dim=0).clamp(min=1e-30)).max())
    qfin = torch.isfinite(k8_args[0]).all(dim=-1)
    n_k = torch.stack(normals_mod._smallest_eigvec3_components(*comps_k), dim=-1)
    n_t = torch.stack(normals_mod._smallest_eigvec3_components(*comps_t), dim=-1)
    cos_share = float(((n_k * n_t).sum(-1).abs()[qfin] > 0.9999).float().mean())
    print(f"K8 bin_knn_moments qp {tuple(k8_args[0].shape)}, bins {tuple(k8_args[1].shape)}, "
          f"k {k8_kw['k']}: n bitwise: {torch.equal(cnt_k, cnt_t)} (mean n "
          f"{float(cnt_k[qfin].mean()):.3f}); max|dC| {k8_err:.4e}, worst relative to the "
          f"query's largest component {k8_rel:.3e} (bound 1e-5); normals cos > 0.9999 on "
          f"{cos_share:.6f} of {int(qfin.sum())} slots", flush=True)
    if not (torch.equal(cnt_k, cnt_t) and k8_rel <= 1e-5 and cos_share >= 0.999):
        raise AssertionError("K8 disagrees with its twin")

    # ---- 2f. K1, K7 and K3 at the 16x shape, as the steps hand them --------
    # The LiDAR PLANE step runs K1 (n_r 2048) and K7 plane (cq 192, cb 256);
    # the 16x POINT step runs K3 at the same layout.
    cfg_lidar = ICPConfig(m=M_L, n_r=N_R_L, estimate_scale=False,
                          objective=Objective.PLANE, normal_mode="knn")
    cfg_16x = ICPConfig(m=M_L, n_r=N_R_L)
    index_l = build_index(wf, prm_d, cfg_lidar)
    step_args = _capture_all(search_mod, ("rep_assign_counts", "bin_gn_moments"),
                             lambda: icp_step(st0, wm, index_l, prm_d, cfg_lidar))
    k1x_args, k7x_args = step_args["rep_assign_counts"], step_args["bin_gn_moments"]
    k3x_args = _capture(search_mod, "bin_point_moments", lambda: icp_step(
        st0, wm, build_index(wf, prm_d, cfg_16x), prm_d, cfg_16x))
    cfg_lg = dataclasses.replace(cfg_lidar, objective=Objective.GICP)
    a, kw = _capture(search_mod, "bin_gn_moments", lambda: icp_step(
        st0, wm, build_index(wf, prm_d, cfg_lg), prm_d, cfg_lg))
    k7x_modes = {"plane": k7x_args, "plane_sym": (a, dict(kw, mode="plane_sym")), "gicp": (a, kw)}
    del index_l
    err16 = {"bin_table": 0.0}  # K2 at 16x is bitwise (2d)
    _, _, err16["rep_assign_counts"], err16["rep_assign"] = _check_rep_assign(
        fs, *k1x_args[0], "LiDAR step")
    for name, kernel, twin, (a, kw) in (
            *(("bin_gn_moments", fg.bin_gn_moments, fg.bin_gn_moments_ref, c)
              for c in k7x_modes.values()),
            ("bin_point_moments", fs.bin_point_moments, fs.bin_point_moments_ref,
             k3x_args)):
        cb = a[4 if name == "bin_gn_moments" else 3].shape[1]
        err16[name] = max(err16.get(name, 0.0), _check_moments(
            f"{name} 16x (mg {tuple(a[0].shape)}, cb {cb}, {kw})", kernel, twin, a, kw))

    # ---- 3. The slice: three flagship registrations ------------------------
    counters = {"rep_assign_counts": fs.rep_assign_counts,
                "rep_assign": fs.rep_assign,
                "bin_table": tb.bin_table,
                "bin_point_moments": fs.bin_point_moments,
                "bin_min_dists": fs.bin_min_dists,
                "bin_search": bs.bin_search,
                "brute_nn": bn.brute_nn,
                "bin_gn_moments": fg.bin_gn_moments,
                "rep_top2_counts": km.rep_top2_counts,
                "bin_knn_moments": km.bin_knn_moments}
    launches = dict.fromkeys(counters, 0)

    def drive_call(call):
        """One call on the main path: every count set to 0 just before it
        and read just after it."""
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ran = {name: fn.launches for name, fn in counters.items()}
        for name, n in ran.items():
            launches[name] += n
        return out, wall, ran

    def drive(fixed_t, moving_t, prm, config):
        """One registration on the main path."""
        return drive_call(lambda: register(fixed_t, moving_t, prm, config))

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

    # ---- 3c. Slices 3-4: BRUTE and the unfused pipeline --------------------
    for seed in (0, 1, 2):
        f_np, m_np = _synthetic_pair(M, seed=seed)
        st, wall, ran = drive(torch.from_numpy(f_np).to(dev),
                              torch.from_numpy(m_np).to(dev), params, cfg_b)
        k = int(st.k)
        t_err, a_err = _errors(st)
        print(f"BRUTE POINT seed {seed} on {torch.cuda.get_device_name(0)}: k={k} "
              f"t_err={t_err:.6f} mm a_err={a_err:.7f} deg wall={wall:.3f} s "
              f"launches={ran}", flush=True)
        if not (t_err < 0.05 and a_err < 0.005):
            raise AssertionError(f"BRUTE seed {seed}: registration off the ground truth")
        require_launched(ran, ("brute_nn",), k, f"BRUTE seed {seed}")

    unfused_gates = {
        "brute_plane": (ICPConfig(objective=Objective.PLANE, estimate_scale=False,
                                  correspondence=Correspondence.BRUTE), lb_d),
        "plane_unfused": (cfg_pu, lb_d),
        "plane_sym_unfused": (ICPConfig(objective=Objective.PLANE, plane_symmetric=True,
                                        estimate_scale=False, fused_gn=False), lb_d),
        "gicp_unfused": (ICPConfig(objective=Objective.GICP, estimate_scale=False,
                                   fused_gn=False), lb_d),
        "robust_unfused": (ICPConfig(objective=Objective.PLANE,
                                     weighting=Weighting.REGULAR,
                                     robust=RobustKernel.TRIMMED, robust_adaptive=True,
                                     estimate_scale=False, fused_gn=False), dirty_d),
    }
    for name, (config, moving_t) in unfused_gates.items():
        st, wall, ran = drive(fa_d, moving_t, params, config)
        k = int(st.k)
        t_err, a_err = _errors(st, Q_GT_R, T_GT_R)
        gate_states[name] = st
        print(f"gate {name} on {torch.cuda.get_device_name(0)}: k={k} "
              f"t_err={t_err:.6f} mm a_err={a_err:.7f} deg wall={wall:.3f} s "
              f"launches={ran}", flush=True)
        if not (t_err < T_GATE and a_err < A_GATE):
            raise AssertionError(f"gate {name}: registration off the ground truth")
        need = (("brute_nn",) if config.correspondence is Correspondence.BRUTE
                else ("bin_table", "bin_search"))
        require_launched(ran, need, k, f"gate {name}")

    # The two-phase POINT step at seed 0's registered state: K1′ assigns,
    # the caller groups and reduces; the moments equal the K1 path's.
    st = results[0]

    def two_phase():
        rid, G2, b2 = search_mod.rbc_point_assign(index, moving, st.q, st.t, st.s, alpha)
        gl = grouping.group_rows_by_bin(rid, N_R, cfg.query_capacity, (moving,))
        return search_mod.rbc_point_moments_grouped(
            index, gl.grouped[0], gl.valid.to(torch.float32), G2, b2, alpha,
            prm_d.c, weighted=True)

    got, _, ran = drive_call(two_phase)
    rid, counts2, G2, b2 = search_mod.rbc_point_assign_counts(index, moving, st.q, st.t,
                                                              st.s, alpha)
    gl = grouping.group_rows_by_bin(rid, N_R, cfg.query_capacity, (moving,), counts=counts2)
    want = search_mod.rbc_point_moments_grouped(
        index, gl.grouped[0], gl.valid.to(torch.float32), G2, b2, alpha, prm_d.c,
        weighted=True)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    print(f"two-phase POINT step (rbc_point_assign, K1'): moments equal to the K1 "
          f"path's: {same}; launches={ran}", flush=True)
    if not same:
        raise AssertionError("the K1' two-phase step differs from the K1 step")
    require_launched(ran, ("rep_assign", "bin_table", "bin_point_moments"), 1, "two-phase")

    # ---- 3d. Slice 5: the LiDAR gate and the scaled-shape gates -------------
    f_g, m_g, q_g, t_g = wavy_surface_pair(M)
    f_4x, m_4x, q_4x, t_4x = wavy_surface_pair(65536)
    f_4x, m_4x = torch.from_numpy(f_4x).to(dev), torch.from_numpy(m_4x).to(dev)
    scale_gates = {  # name -> (fixed, moving, q_gt, t_gt, config, kernels run k times)
        "lidar": (wf, wm, q_l, t_l, cfg_lidar,
                  ("rep_assign_counts", "bin_table", "bin_gn_moments")),
        "gicp knn_rbc 16384": (torch.from_numpy(f_g).to(dev), torch.from_numpy(m_g).to(dev),
                               q_g, t_g, ICPConfig(objective=Objective.GICP,
                                                   normal_mode="knn_rbc",
                                                   estimate_scale=False),
                               ("rep_assign_counts", "bin_table", "bin_gn_moments")),
        "icp_4x": (f_4x, m_4x, q_4x, t_4x, ICPConfig(m=65536, n_r=1024),
                   ("rep_assign_counts", "bin_table", "bin_point_moments")),
        "icp_16x": (wf, wm, q_l, t_l, cfg_16x,
                    ("rep_assign_counts", "bin_table", "bin_point_moments")),
    }
    for name, (f_t, m_t, q_gt, t_gt, config, need) in scale_gates.items():
        st, wall, ran = drive(f_t, m_t, params, config)
        k = int(st.k)
        t_err, a_err = _errors(st, q_gt, t_gt)
        ref = REFERENCE_SCALE.get(name)
        ref_txt = f" (JAX reference on its TPU run: {ref[0]} mm, {ref[1]} deg)" if ref else ""
        print(f"gate {name} (m {config.m}, n_r {config.n_r}, {config.objective.name}, "
              f"normal_mode {config.normal_mode}) on {torch.cuda.get_device_name(0)}: k={k} "
              f"t_err={t_err:.6f} mm a_err={a_err:.7f} deg wall={wall:.3f} s "
              f"launches={ran}{ref_txt}", flush=True)
        if not (t_err < T_GATE and a_err < A_GATE):
            raise AssertionError(f"gate {name}: registration off the ground truth")
        require_launched(ran, need, k, f"gate {name}")
        if config.normal_mode.startswith("knn"):
            require_launched(ran, ("rep_top2_counts", "bin_knn_moments"), 1, f"gate {name}")

    n_l = normals_mod.knn_normals_rbc(wf).cpu().numpy()
    cos = np.abs(np.sum(n_l * _analytic_normals(wf_np), axis=-1))
    zero = float(np.mean((n_l == 0).all(axis=1)))
    print(f"knn_normals_rbc at {M_L} points on the card against the analytic normals: "
          f"median |cos| {float(np.median(cos)):.6f} (bound > 0.999), share above 0.99 "
          f"{float(np.mean(cos > 0.99)):.6f} (>= 0.95), zero normals {zero:.6f} (< 0.02)",
          flush=True)
    if not (np.median(cos) > 0.999 and np.mean(cos > 0.99) >= 0.95 and zero < 0.02):
        raise AssertionError("the card's kNN normals miss the analytic surface")
    c16 = torch.from_numpy(f_g)
    n_gpu = normals_mod.knn_normals_rbc(c16.to(dev)).cpu()
    n_cpu = normals_mod.knn_normals_rbc(c16)
    same_zero = torch.equal((n_gpu == 0).all(1), (n_cpu == 0).all(1))
    close = float(((n_gpu - n_cpu).abs().amax(1) <= 1e-4).float().mean())
    print(f"knn_normals_rbc at {M} points, card vs CPU twins: zero set equal: {same_zero}, "
          f"|dn| <= 1e-4 on {close:.6f} of rows (bound 0.999), max|dn| "
          f"{float((n_gpu - n_cpu).abs().max()):.3e}", flush=True)
    if not (same_zero and close >= 0.999):
        raise AssertionError("kNN normals on the card and the CPU disagree")

    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} never launched on the main path")

    # Card against the CPU twins: BRUTE POINT on 4096 landmarks (the CPU
    # twin of K6 sweeps m x m per step), unfused PLANE at full size.
    f_np, m_np = _synthetic_pair(4096, seed=0)
    cfg_b4 = ICPConfig(m=4096, n_r=64, correspondence=Correspondence.BRUTE)
    cmp_cases = {
        "BRUTE POINT 4096": (torch.from_numpy(f_np), torch.from_numpy(m_np), cfg_b4,
                             0.01, 0.001),
        "unfused PLANE": (la, lb, cfg_pu, 0.05, 0.005),
    }
    for name, (f_c, m_c, config, t_bound, a_bound) in cmp_cases.items():
        st_gpu = register(f_c.to(dev), m_c.to(dev), params, config)
        before = {n: fn.launches for n, fn in counters.items()}
        t0 = time.perf_counter()
        st_cpu = register(f_c, m_c, params, config)
        cpu_s = time.perf_counter() - t0
        if any(fn.launches != before[n] for n, fn in counters.items()):
            raise AssertionError("a CPU registration launched a kernel")
        dt = float(np.linalg.norm(st_gpu.t.double().cpu().numpy() - st_cpu.t.double().numpy()))
        dang = float(qangle_deg(qmul(st_gpu.q.cpu(), qconj(st_cpu.q))))
        print(f"{name} card vs CPU twins: k {int(st_gpu.k)} vs {int(st_cpu.k)}, "
              f"|dt|={dt:.6f} mm, dangle={dang:.7f} deg (CPU {cpu_s:.1f} s)", flush=True)
        if not (dt <= t_bound and dang <= a_bound):
            raise AssertionError(f"{name}: card and CPU registrations disagree")

    # The fused step against the unfused step, on the card, from the
    # identity (POINT: the synthetic pair; GN: the rendered pair).
    fused_cmp = {
        "point": (moving, index, ICPConfig(), cfg_u),
        "plane": (lb_d, index_p, cfg_p, cfg_pu),
    }
    for name in ("plane_sym", "gicp", "robust"):
        fused_cfg = gates[name][0]
        fused_cmp[name] = (gates[name][1], index_p, fused_cfg,
                           dataclasses.replace(fused_cfg, fused_gn=False))
    for name, (moving_t, idx_t, fused_cfg, unfused_cfg) in fused_cmp.items():
        mn = (normals_for(moving_t, "auto") if fused_cfg.needs_normals else None)
        a = icp_step(st0, moving_t, idx_t, prm_d, fused_cfg, moving_normals=mn)
        b = icp_step(st0, moving_t, idx_t, prm_d, unfused_cfg, moving_normals=mn)
        dq = max(float((a.q - b.q).abs().max()), float((a.qk - b.qk).abs().max()))
        dtk = float((a.tk - b.tk).abs().max())
        print(f"fused vs unfused step {name} on the card: max|dq|={dq:.3e} (bound 1e-5), "
              f"max|dtk|={dtk:.3e} mm (bound 0.05)", flush=True)
        if not (dq <= 1e-5 and dtk <= 0.05):
            raise AssertionError(f"fused and unfused {name} steps disagree")

    # ---- 4. Times (printed, not gated) ------------------------------------
    fast = ICPParams(alpha=ALPHA, angle_threshold_deg=0.0,
                     translation_threshold=0.0)

    def marginal_ms(fixed_t, moving_t, config, rounds):
        """(marginal ms/iteration, T40 s, T8 s): the minimum of alternating
        rounds of 40 and 8 iterations for each, then the difference / 32."""
        best = {40: float("inf"), 8: float("inf")}
        for _ in range(rounds):
            for iters in (40, 8):
                t0 = time.perf_counter()
                st = register(fixed_t, moving_t, fast,
                              dataclasses.replace(config, max_iterations=iters))
                torch.cuda.synchronize()
                best[iters] = min(best[iters], time.perf_counter() - t0)
                if int(st.k) != iters:
                    raise AssertionError(f"k={int(st.k)} != {iters}")
        return (best[40] - best[8]) / 32 * 1e3, best[40], best[8]

    per_iter, t40, t8 = marginal_ms(fixed, moving, ICPConfig(), ROUNDS)
    print(f"marginal ms/iteration at {M}x{N_R}: {per_iter} "
          f"(T40 {t40 * 1e3} ms, T8 {t8 * 1e3} ms, "
          f"min of {ROUNDS} alternating rounds)", flush=True)

    for objective in (Objective.PLANE, Objective.GICP):
        per_iter, t40, t8 = marginal_ms(fa_d, lb_d, ICPConfig(
            objective=objective, estimate_scale=False), 3)
        print(f"{objective.name} marginal ms/iteration at {M}x{N_R} (rendered pair): "
              f"{per_iter} (T40 {t40 * 1e3} ms, T8 {t8 * 1e3} ms, min of 3 "
              f"alternating rounds)", flush=True)

    # ---- 4c. Slices 3-4: BRUTE POINT and unfused PLANE, and their kernels ---
    for name, (f_t, m_t, config) in {
            "BRUTE POINT (synthetic pair)": (fixed, moving, cfg_b),
            "unfused PLANE (rendered pair)": (fa_d, lb_d, cfg_pu)}.items():
        per_iter, t40, t8 = marginal_ms(f_t, m_t, config, 3)
        print(f"{name} marginal ms/iteration at {M}x{N_R}: {per_iter} (T40 "
              f"{t40 * 1e3} ms, T8 {t8 * 1e3} ms, min of 3 alternating rounds)",
              flush=True)

    # ---- 4d. Slice 5: the LiDAR cells and the scaled POINT cells -------------
    for name, (f_t, m_t, config) in {
            "LiDAR PLANE, normal_mode knn": (wf, wm, cfg_lidar),
            "POINT 4x": (f_4x, m_4x, scale_gates["icp_4x"][4]),
            "POINT 16x": (wf, wm, scale_gates["icp_16x"][4])}.items():
        per_iter, t40, t8 = marginal_ms(f_t, m_t, config, 3)
        print(f"{name} marginal ms/iteration at {config.m}x{config.n_r}: {per_iter} (T40 "
              f"{t40 * 1e3} ms, T8 {t8 * 1e3} ms, min of 3 alternating rounds)", flush=True)
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            normals_mod.knn_normals_rbc(wf)
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / 5)
    print(f"knn_normals_rbc ms per call at {M_L} points: {best * 1e3} (min of 3 rounds "
          f"of 5 calls; the reference's knn_normals_ms_262144 on its TPU run: 25.402)",
          flush=True)
    # Each timed case: (wrapper, twin, args, kwargs). Keys with "@" are
    # printed apart: the kernels line keeps each kernel's main-path shape
    # (the flagship for K1-K7, the LiDAR shape for K8 and K9).
    cases = {
        "rep_assign_counts": (fs.rep_assign_counts, fs.rep_assign_counts_ref,
                              (moving, C, srow), {}),
        "rep_assign": (fs.rep_assign, fs.rep_assign_ref, (moving, C, srow), {}),
        "bin_table": (tb.bin_table, tb.bin_table_ref, (sorted_rows, offsets),
                      {"capacity": cfg.query_capacity}),
        "bin_point_moments": (fs.bin_point_moments, fs.bin_point_moments_ref, k3_args,
                              {"weighted": True}),
        "bin_min_dists": (fs.bin_min_dists, fs.bin_min_dists_ref, k4_args, {}),
        "brute_nn": (bn.brute_nn, bn.brute_nn_ref, k6_args, {}),
        "rep_top2_counts": (km.rep_top2_counts, km.rep_top2_counts_ref, k9_args, {}),
        "bin_knn_moments": (km.bin_knn_moments, km.bin_knn_moments_ref, k8_args, k8_kw),
        "rep_assign_counts@16x": (fs.rep_assign_counts, fs.rep_assign_counts_ref, *k1x_args),
        **{f"bin_gn_moments@16x {mode}": (fg.bin_gn_moments, fg.bin_gn_moments_ref, *c)
           for mode, c in k7x_modes.items()},
        "bin_point_moments@16x": (fs.bin_point_moments, fs.bin_point_moments_ref,
                                  *k3x_args),
    }
    for mode, (a, kw) in gn_args.items():
        cases[f"bin_gn_moments {mode}"] = (fg.bin_gn_moments, fg.bin_gn_moments_ref, a, kw)
    for robust, (a, kw) in k3r_args.items():
        cases[f"bin_point_moments {robust}"] = (fs.bin_point_moments,
                                               fs.bin_point_moments_ref, a, kw)
    for case, a in k5_cases.items():
        key = "bin_search@" if "n_r=16" in case else "bin_search "
        cases[key + case] = (bs.bin_search, bs.bin_search_ref, a, {})
    for d, (rows, starts) in k2x_args.items():
        cases[f"bin_table@16x d={d}"] = (tb.bin_table, tb.bin_table_ref, (rows, starts),
                                         {"capacity": cap16})
    # Twins that sweep a large set (K6's 16384 x 16384, K1 and K9 over
    # 262144 x 2048 scores, K8 over 2048 bins): 5 calls per timing, not 20.
    twin_reps = {"brute_nn": 5, "rep_top2_counts": 5, "bin_knn_moments": 5,
                 "rep_assign_counts@16x": 5, "bin_point_moments@16x": 5,
                 **{f"bin_gn_moments@16x {mode}": 5 for mode in k7x_modes}}
    times = {}
    for key, (kernel, twin, a, kw) in cases.items():
        bound = _bound(*_work(key.split()[0].split("@")[0], a, kw, kernel(*a, **kw)))
        k_ms, t_ms = float("inf"), float("inf")
        for _ in range(3):  # alternate kernel and twin; keep each minimum
            k_ms = min(k_ms, _cuda_ms(lambda f=kernel, a=a, kw=kw: f(*a, **kw)))
            t_ms = min(t_ms, _cuda_ms(lambda f=twin, a=a, kw=kw: f(*a, **kw),
                                      twin_reps.get(key, 20)))
        times[key] = (k_ms, t_ms, *bound)
        print(f"{key}: kernel {k_ms} ms, plain twin {t_ms} ms, bound {bound[0]} ms "
              f"({bound[1]})", flush=True)

    meta = {
        "rep_assign_counts": ("icp_tpu_torch/csrc/rep_assign_counts.cu",
                              "icp_tpu/kernels/fused_step.py:372", k1_err),
        "rep_assign": ("icp_tpu_torch/csrc/rep_assign_counts.cu",
                       "icp_tpu/kernels/fused_step.py:286", k1p_err),
        "bin_table": ("icp_tpu_torch/csrc/bin_table.cu",
                      "icp_tpu/kernels/table_build.py:79", k2_err),
        "bin_point_moments": ("icp_tpu_torch/csrc/bin_point_moments.cu",
                              "icp_tpu/kernels/fused_step.py:564",
                              max(k3_err, k3r_err, k3c_err)),
        "bin_min_dists": ("icp_tpu_torch/csrc/bin_min_dists.cu",
                          "icp_tpu/kernels/fused_step.py:689", k4_err),
        "bin_search": ("icp_tpu_torch/csrc/bin_search.cu",
                       "icp_tpu/kernels/bin_search.py:115", k5_err),
        "brute_nn": ("icp_tpu_torch/csrc/brute_nn.cu",
                     "icp_tpu/kernels/brute_nn.py:69", k6_err),
        "bin_gn_moments": ("icp_tpu_torch/csrc/bin_gn_moments.cu",
                           "icp_tpu/kernels/fused_gn.py:318", k7_err),
        "rep_top2_counts": ("icp_tpu_torch/csrc/rep_top2_counts.cu",
                            "icp_tpu/kernels/knn_moments.py:223", k9_err),
        "bin_knn_moments": ("icp_tpu_torch/csrc/bin_knn_moments.cu",
                            "icp_tpu/kernels/knn_moments.py:158", k8_err),
    }
    # A kernel with several modes reports its slowest mode and that mode's
    # bound.
    for name in meta:
        modes = [t for key, t in times.items() if key.split()[0] == name]
        slow = max(modes, key=lambda t: t[0])
        times[name] = (slow[0], max(t[1] for t in modes), slow[2], slow[3])
    # max_abs_err is the largest over every shape checked; the kernels the
    # 16x paths run also give their error there apart (max_abs_err_16x), and
    # K1, K3 and K7 their time and bound at the 16x step shape.
    at16 = {"rep_assign_counts": "rep_assign_counts@16x",
            "bin_point_moments": "bin_point_moments@16x",
            "bin_gn_moments": "bin_gn_moments@16x plane"}
    r6 = k6_rescored.double()
    extra = {"brute_nn": {"rescored_mean": float(r6.mean()), "rescored_max": int(r6.max()),
                          "margin_headroom": k6_headroom, "ms_no_rescore": k6_none}}
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], "max_abs_err": max(err, err16.get(name, 0)),
                "ms": times[name][0], "plain_ms": times[name][1],
                "bound_ms": times[name][2], "bound_by": times[name][3],
                "library_ms": None}
               | ({"max_abs_err_16x": err16[name]} if name in err16 else {})
               | ({"ms_16x": times[at16[name]][0], "bound_ms_16x": times[at16[name]][2]}
                  if name in at16 else {})
               | extra.get(name, {})
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
