#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (icp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; there is no CPU fallback):

1. Device: require CUDA, print the card (nvidia-smi name and power limit),
   the torch and nvcc versions, and build the kernels from csrc/.
2. Kernels against their plain PyTorch twins on the card, on the tensors of
   the first iteration of the flagship pair (m=16384, n_r=256): K2 bitwise,
   on sorted rows and on every table the index build and the step make
   (K1, K1′ and K3 on these tensors are rows of phase 5).
3. The slice: register three flagship pairs (seeds 0, 1, 2) with the
   default ICPConfig through icp_tpu_torch.register on CUDA tensors; each
   must land within 0.05 mm and 0.005 deg of the ground truth and the launch
   counters must show every kernel ran at least k times (seed 0 on the card
   against the CPU twins is phase 5's e2e-point row).
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
    cq 96, cb 128): K4 bitwise (the same +inf slots, every finite d2 the
    twin's bits) there (lanes 0:8 of the 11-wide rows), on what
    robust-adaptive POINT and symmetric-PLANE steps hand it on the rendered
    pair, on what robust-adaptive POINT steps of the flagship pair hand it at
    n_r 32, 16 and 8 (cb up to 4096) and on the all-equal bins of
    sensors/search_sets.py; K7's P and P_z and K3's P within 1e-4 of
    max|P|, each repeating bitwise.
3b. The four bench gates (plane, plane_sym, robust with 12 % gross outliers
    made as bench.py makes them, gicp) registered on CUDA tensors, each
    within t_err < 1.0 mm and a_err < 0.05 deg, with K1, K2, K7 (and K4 for
    robust) launched at least k times; a POINT + HUBER + adaptive
    registration of the synthetic pair (K3 and K4) within the same gate
    (the PLANE gate on the card against the CPU twins is phase 5's
    e2e-plane row).
4b. The marginal ms per iteration of PLANE and GICP, and K4, K7 and robust
    K3 against their twins.

Slices 3 and 4 (the unfused per-pair pipeline: RBC grouped search with K5,
BRUTE with K6, and K1′) add:

2c. K5 on the all-equal bins of sensors/search_sets.py (cb 128, 2048,
    4096: every live slot ties, the first must win): scores and payloads
    bitwise (K5 on the tables the unfused steps pass it, taken from
    icp_step itself, at the flagship with V = 8 and 12 and at n_r 16 and 8,
    are rows of phase 5); K3 on what the fused step hands it at n_r 32 (cq
    768, cb 1024: several query and bin tiles) within 1e-4 of max|P| and
    repeating bitwise; K7 (three modes) on what a GICP step hands it at
    n_r 32 under the same rule (n_r 16 for both: phase 5); K6 on the 16384 x 16384 BRUTE step: every index and
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
    the shape of the windowed TPU variant, bitwise against its twin, on
    sorted rows and through the order; also on the PLANE index build's and
    step's tables (2b) and the estimator's (2e).
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

2e. K9 at the LiDAR shape (262144 raw points, 2048 Morton reps), at the
    GICP "knn_rbc" cell's 16384 points (128 reps) and on the top-2 sets of
    sensors/knn_sets.py (among them exact ties between reps in different
    warps and chunks, at 4 and at 8 points a thread) against its twin: i1,
    i2 and the counts bitwise,
    the counts the bincounts of the kernel's own ids; K8 on the tables the
    estimator builds there (n_r 2048, cq 192,
    cb 384, k 16): n bitwise, components within 1e-5 of each query's
    largest, a second launch bitwise equal to the first, and the normals of
    the two within cos 0.9999 on >= 99.9 % of the slots. K9's and K8's
    arguments come from one call of the estimator. K8 under the same rule
    at 16384 points (n_r 128, the GICP "knn_rbc" cell) and on the
    adversarial sets of sensors/knn_sets.py (ties at the k-th value,
    all-invalid bins, NaN queries, negative d2, k 1 / 12 / 16 / 40, cb 100
    and 1024).
2f. K7 plane at the LiDAR PLANE step (cq 192, cb 256) against its twin,
    within 1e-4 of max|P| and repeating bitwise (K1, K1′ there, K7
    plane_sym and gicp at the LiDAR GICP step and K3 at the 16x POINT step
    are rows of phase 5).
3d. The reference's LiDAR gate: PLANE at m 262144, n_r 2048 with
    normal_mode "knn" (the RBC estimator) within 1.0 mm and 0.05 deg, K9
    and K8 launched, K1, K2 and K7 at least k times; the estimator on the
    card against the analytic normals (median |cos| > 0.999, >= 95 % above
    0.99, < 2 % zero normals) and at 16384 points against the CPU twins
    (the same zero set, |dn| <= 1e-4 on >= 99.9 % of rows); GICP with
    "knn_rbc" at 16384 points, and the reference's 4x and 16x POINT gates
    (65536 x 1024, 262144 x 2048), each within the gate.
4d. Times: K9 and K8 (also at 16384 points), K7 (three modes), K3, K1 and K2
    (through the order) at the 16x shape against their twins, the estimator's ms per call
    at 262144 points and the
    marginal ms per iteration of the LiDAR PLANE registration and the 4x /
    16x POINT cells.

Slice 6 (the batch, the pyramid and the app pipelines) adds, at the
flagship width (m 16384, n_r 256):

3e. register_batch of B 4 POINT pairs (synthetic_pair seeds 0-3), B 2
    BRUTE POINT pairs and B 2 PLANE rendered pairs, each lane's k, q, t and
    s torch.equal to register of its pair on the card, each lane within
    its gate (POINT 0.05 mm / 0.005 deg, PLANE 1.0 mm / 0.05 deg), with the
    batch's wall per pair beside register's; register_pyramid (strides 4,
    2, 1) on the reference test's large-motion rendered pair (0.02 rad
    about y, t = (60, -30, 40) mm) within 10 mm and 0.3 deg and no more
    than 1 mm worse than one level, K1 and K3 launched at n_r 16, 64 and
    256; ICPRegistration.register_clouds on the 640x480 rendered pair
    within the reference test's bounds (1 <= k <= 40, |t| < 50 mm, angle
    < 2 deg); ICPStepByStep's two steps (k 1, then 2), its transformed
    cloud (307200, 8) with the colour half untouched, and reset; POINT +
    HUBER + adaptive at n_r 8 (K4 at cb 4096) within 1.0 mm and 0.05 deg.

Slice 7 (the odometry front end: sensors, runtime, SE(3) and the
frame-to-frame chain) adds, at full width (640 x 480 frames, m 16384, n_r
256):

3f. The bench's two 100-frame real-terrain sequences (bench.py:419-449,
    493-513: orbit_trajectory(100, 120 mm, 0.12 rad) and the rotation-heavy
    (100, 60 mm, 0.5 rad)), observed on one terrain_surface by
    sensors.realdata in a pool of forked processes (one per core; the
    render's seconds printed), landmarks taken on the card, then
    odometry_chain_device with GICP, max_iterations 8 and zero thresholds,
    the whole call under torch.cuda.set_sync_debug_mode("error"): ATE
    < 22 mm and RPE10 < 5.5 mm, the rotation arc ATE < 30 mm and RPE10
    < 7.5 mm (bench.py:479, 510), every k 8, K1, K2 and K7 launched; the
    marginal odometry_frames_per_s, 50 / (T(100) - T(50)), the least of 3
    rounds each; run_odometry against odometry_chain_device on 4 rendered
    frames (POINT, max_gap 2): poses and k torch.equal, ATE < 15 mm, K3
    launched; a TUM round trip (3 frames through the PNG codec, then
    run_odometry and evaluate_trajectory: ATE and RPE_t < 0.02 m, RPE_r
    < 1 deg, a drifted copy worse); the native host library built under
    build/ and five frames written by its codec and streamed by FrameSource
    through its ring, frame 0 -> 1 registered torch.equal to the frames
    passed directly; the guided filter on a terrain frame on the card
    within 1 mm (depth) and 1e-4 (colour) of the CPU, holes kept 0, its
    device ms printed.

Slice 8 (the SLAM back end: the pose graph, bundle adjustment, the mapping
engine) adds, at full width:

3g. The bench's wall gate (bench.py:352-391: realdata.wall_surface, an
    in-plane (30, -15, 4) mm motion, POINT, 60 iterations): lateral error
    < 6 mm and |dz| < 0.5 mm at alpha 4e5, |dz| < 0.5 mm and lateral error
    > 25 mm at alpha 1e-6, K1 and K3 launched k times; the bench's pyramid
    pair (bench.py:325-348: PLANE, 0.06 rad about y, t (60, -40, 30) mm,
    strides 4, 2, 1) within 2.0 mm and 0.1 deg; the bench's slam gate
    (bench.py:521-627): the 200-frame real-terrain circle (rendered in the
    same pool and over the same surface as 3f's arcs; its landmarks the
    strided slice that equals get_landmarks) through SlamEngine (GICP, 8
    iterations, max_gap 1, closures within 60 mm / 20 deg at least 50
    keyframes apart, verification batches padded to 16) and
    optimize_map(10): closure precision >= 0.9, recall >= 0.8, ATE after
    < 40 mm and < 0.8 x before, every verification a 16-lane
    register_batch, K1, K2 and K7 launched; the dense optimize on the
    gate's graph and optimize_pcg on a 600-node ring, each twice under
    torch.cuda.set_sync_debug_mode("error"), bitwise equal to itself, the
    ring within 2 mm, 5e-3 in q and 1 % of the cost of the CPU's result,
    the gate's graph within 1e-4 of its cost and 1 mm of its ATE;
    ba_solve (32 cameras, 4096 points, degree <= 8) twice under sync debug
    mode after its host degree check, bitwise equal, its cost falling
    100-fold. Each phase's seconds are printed.

Slice 9 (parallel/ on torch.distributed) adds:

3h. The sharded paths at the flagship width (sharded_phase): this process
    builds the kernels, then make_sharded_register in a world of 1 on NCCL
    here (POINT on synthetic_pair, PLANE and GICP on the rendered gate
    pair) and in worlds of 2 and 4 ranks (meshes (2, 1), (1, 2), (2, 2))
    launched through icp_tpu_torch.parallel.dryrun, whose ranks share the
    one card on gloo and only load the built library: POINT, PLANE, GICP,
    robust-adaptive PLANE (12 % outliers) and BRUTE POINT, each within its
    gate and within the JAX tests' sharded-vs-single bars of register on
    the card, every rank bitwise rank 0's, K2 launched with K3 or K5 at
    least k times on every rank; in the (2, 1) world the sharded dense LM
    on 3g's slam graph and the sharded PCG on the 600-node ring within
    1e-4 of the single-device cost and 1 mm of its ATE, and the sharded
    BA (32 cameras, 4096 points) within 5e-2 of ba_solve. With two or more
    cards the (2, 1) world also runs on NCCL across them, and (2, 2) with
    four. The ranks' launches count on the main path. K2 (over n_r_local +
    1 bins, the parking bin included), K3 and K5 are held against their
    twins on what one sharded step hands them at every rank's shapes of the
    meshes (1, 1), (2, 1), (1, 2) and (2, 2) in phase 5.

Slice 10 (viz/ and the examples) adds:

3i. The six examples on the card (examples_phase), each through its
    ``main(argv)`` at its defaults and full width, into a temporary
    directory: frame_grabber twice (pose A, then pose B of the gate pair:
    0.008 rad about y, t (10, -6, 8) mm) and registration on those two
    files, within 10 mm and 0.3 deg of pose B (POINT's landmark-lattice
    floor on a rendered pair), K1, K2 and K3 launched k times;
    registration --synthetic --robust huber likewise, K3 (robust) k
    times; step_by_step --synthetic --batch 8 torch.equal to an
    ICPStepByStep driven directly for 8 steps, K1, K2 and K3 launched 8
    times; odometry --frames 10 and --plane (ATE printed, finite; K7
    launched for --plane); odometry_service --frames 12
    --checkpoint-every 4 --fail-at 6 (exit code 2), its resume, and an
    uninterrupted run: the final snapshots equal array for array;
    multichip in a world of 1 on NCCL here and with --dp 2 as two ranks
    sharing the card on gloo, within phase 3h's POINT bars of register
    (0.1 mm, 5e-3 deg) and 0.05 mm / 0.005 deg of the ground truth, K2
    and K3 launched. The examples' own printed reports are kept to their
    last lines.

Slice 11 (the support matrix, runtime/support_matrix.py) adds:

5. support_sweep.sweep: every row of the matrix (each kernel x variant x
   shape class that a supported configuration reaches: the pyramid levels,
   the flagship, 4x, 16x, n_r 16 / 8 / 65536, one rank of the sharded
   flagship on (1, 1), (2, 1), (1, 2) and (2, 2), and the kNN estimator at
   262144, 16384 and 2^21 + 128 points and at n_r 128 on 262144) launched on
   the arguments the main path hands its wrapper and held against its twin
   at the bars above, plus the e2e rows (POINT, PLANE and GICP registered on
   the card and on the CPU twins: 0.01 mm / 0.001 deg, 0.05 mm / 0.005
   deg). It fails unless every row is ok and the checked-in table
   (icp_tpu_torch/runtime/support_table.json) has the sources' and the
   wrappers' digests and the matrix's keys; it prints the row count and its seconds. Where a
   row repeats a check that phases 2-3h made, the check is made here only:
   the flagship K1, K1′, K2 through the order, K3 and K5; K1, K1′, K3 and
   K7 plane_sym / gicp at 16x; K3, K4, K5 and K7 at n_r 16; K4 and K5 at
   n_r 8; the sharded ranks' K2, K3 and K5; and the two card-vs-CPU
   registrations.

The line before the last is {"kernels": [...]}: per kernel its launches on
the main path, its largest error against the twin over every shape checked
(and, for K1, K1′, K2, K3 and K7, max_abs_err_16x at the 16x shape apart), its
time and the twin's, and its
bound, the larger of the time of the operations of the work and of its
bytes (each input read once, each output written once; for K5 only the
rows of finite slots and the winning payload rows) over 3.35 TB/s. The
operations are fp32 over 67 TFLOP/s (K3, K4 and K7 count the pairs of valid
query slots and finite bin slots, K5 every query slot against its bin's
finite slots); K6's are the work of its design: 3 x 2 x
8 TF32 flops per pair over 495 TFLOP/s, or its fp32 epilogue (the fma of the
score and a min, 3 operations per pair) over 67 TFLOP/s, whichever takes
longer. K1, K2, K3 and K7 add ms_16x and bound_ms_16x at the 16x step shape,
K6 its re-scored pairs per query (mean and largest), the margin's headroom
per set and the sweep's time with no re-score. K8's bound_ms is the work
the function needs (the d2 cross, 21 operations a pair of a query and a live
candidate, 40 per neighbour, 100 per query); bound_ms_pr4 is the count of its
first design (60 a query-slot pair: the d2, 18 counting passes, the
membership), kept to compare with older records; K8 adds ms_16384,
plain_ms_16384 and both bounds there, K9 ms_16384, plain_ms_16384 and
bound_ms_16384, K4 ms_n_r8, plain_ms_n_r8 and bound_ms_n_r8 on what the
robust-adaptive POINT step hands it at n_r 8 (cq 3072, cb 4096). K5 adds bound_ms_padded (every padded slot pair and every
byte of its inputs, its count before its live-slot design) and its time, the twin's and both bounds at
n_r 16 (ms_n_r16, plain_ms_n_r16, bound_ms_n_r16, bound_ms_padded_n_r16).
matrix_rows counts each
kernel's rows in phase 5, whose errors join max_abs_err (and, at 16x,
max_abs_err_16x). library_ms is null, since no single PyTorch call computes
any of these functions. The last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

# The benchmark's blend and the ground truths of synthetic_pair (+0.02 rad
# about z, t = (8, -5, 3) mm, for any seed) and of the rendered gate pair
# (0.008 rad about y, t = (10, -6, 8) mm), shared with the support sweep.
from icp_tpu_torch.runtime.support_sweep import ALPHA, Q_GT, Q_GT_R, T_GT, T_GT_R
from icp_tpu_torch.runtime.support_sweep import bitwise as _bitwise
from icp_tpu_torch.runtime.support_sweep import capture as _capture
from icp_tpu_torch.runtime.support_sweep import capture_all as _capture_all
from icp_tpu_torch.runtime.support_sweep import finite_err as _finite_err
from icp_tpu_torch.runtime.support_sweep import rendered_pair as _rendered_pair

M, N_R = 16384, 256
ROUNDS = 5
# The errors the JAX reference recorded for each gate of the rendered pair
# on its TPU run (BENCH_r05.json): printed beside the port's, not targets.
# A second rendered pair for the PLANE batch: pose C, 0.006 rad about z and
# t = (-6, 5, 9) mm, is its ground truth.
Q_GT_C = np.array([0.0, 0.0, np.sin(0.003), np.cos(0.003)])
T_GT_C = np.array([-6.0, 5.0, 9.0])
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
N_SLAM = 200  # frames of the bench's SLAM circle (bench.py:545)
# The reference's records on its TPU run (bench.py:352-391, 325-348,
# 521-627; ROADMAP.md), printed beside the port's: history, not targets.
REFERENCE_WALL = (2.9862, 0.0001, 33.4991)  # lateral, z, geometry-only lateral (mm)
REFERENCE_PYRAMID = (0.9931, 0.07668)  # mm, deg
REFERENCE_SLAM = "200 keyframes, 15 closures, precision 1.0, recall 1.0, ATE 47.325 -> 30.254 mm"


def _run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def _errors(state, q_gt=Q_GT, t_gt=T_GT):
    """(t_err mm, a_err deg) of a registration against the ground truth."""
    from icp_tpu_torch.icp.quaternion import qangle_deg, qconj, qmul

    q_gt = torch.tensor(q_gt, dtype=torch.float32)
    t_err = float(np.linalg.norm(state.t.double().cpu().numpy() - t_gt))
    a_err = float(qangle_deg(qmul(state.q.cpu(), qconj(q_gt))))
    return t_err, a_err


def _qmul(a, b):
    """Hamilton product of [x, y, z, w] quaternions (numpy)."""
    (x1, y1, z1, w1), (x2, y2, z2, w2) = a, b
    return np.array([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                     w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2])


def _relative(qa, ta, qb, tb):
    """(q, t) of a^-1 b for camera poses a, b (p_world = R(q) p + t): the
    transform that takes b's frame into a's, the ground truth of
    registering b's landmarks onto a's."""
    qa_inv = np.array([-qa[0], -qa[1], -qa[2], qa[3]])
    d = np.concatenate([np.asarray(tb, np.float64) - ta, [0.0]])
    return _qmul(qa_inv, qb), _qmul(_qmul(qa_inv, d), qa)[:3]


def _rel_err(got, want) -> tuple[float, float]:
    """(max|got - want|, max|want|)."""
    return float((got - want).abs().max()), float(want.abs().max())


def _check_k2_tables(grouping, what: str, n: int, call) -> float:
    """K2 bitwise against its twin on every table that ``call()`` makes
    through ``grouping.bin_table``, of which there must be ``n``. Returns
    max|d| (0.0)."""
    orig, seen = grouping.bin_table, []

    def spy(*args, **kwargs):
        seen.append((args, kwargs))
        return orig(*args, **kwargs)

    grouping.bin_table = spy
    try:
        call()
    finally:
        grouping.bin_table = orig
    torch.cuda.synchronize()
    if len(seen) != n:
        raise AssertionError(f"K2 {what}: {len(seen)} tables made, expected {n}")
    return max(_check_k2(what, a, kw) for a, kw in seen)


def _k2_twin(rows, starts, *, capacity, order=None):
    """K2's twin in either form: bin_table_ref of the gathered,
    concatenated rows."""
    from icp_tpu_torch.kernels import table_build as tb

    sources = (rows,) if isinstance(rows, torch.Tensor) else tuple(rows)
    return tb.bin_table_ref(tb.gathered_rows(sources, order), starts, capacity=capacity)


def _check_k2(what: str, args, kwargs) -> float:
    """K2 against its twin, bitwise. Returns max|d| (0.0)."""
    from icp_tpu_torch.kernels import table_build as tb

    got, want = tb.bin_table(*args, **kwargs), _k2_twin(*args, **kwargs)
    torch.cuda.synchronize()
    ok = _bitwise(got, want)
    src = args[0] if isinstance(args[0], (tuple, list)) else (args[0],)
    print(f"K2 bin_table {what}: table {tuple(got.shape)} from "
          f"{[tuple(x.shape) for x in src]} "
          f"{'through the order' if kwargs.get('order') is not None else 'sorted'}: "
          f"bitwise equal to its twin: {ok}", flush=True)
    if not ok:
        raise AssertionError(f"K2 {what} differs from its twin")
    return float((got - want).abs().max()) if got.numel() else 0.0


def _check_k8(km, what: str, args, kwargs) -> tuple[float, float]:
    """K8 against its twin: n bitwise, the components within 1e-5 of each
    query's largest, a second launch bitwise equal to the first. Returns
    (max|dC|, worst relative error)."""
    comps_k, cnt_k = km.bin_knn_moments(*args, **kwargs)
    again = km.bin_knn_moments(*args, **kwargs)
    comps_t, cnt_t = km.bin_knn_moments_ref(*args, **kwargs)
    torch.cuda.synchronize()
    ck, ct = torch.stack(comps_k), torch.stack(comps_t)
    err = float((ck - ct).abs().max())
    rel = float(((ck - ct).abs() / ct.abs().amax(dim=0).clamp(min=1e-30)).max())
    same_n = torch.equal(cnt_k, cnt_t)
    repeats = _bitwise(ck, torch.stack(again[0])) and torch.equal(cnt_k, again[1])
    print(f"K8 bin_knn_moments {what}: qp {tuple(args[0].shape)}, bins "
          f"{tuple(args[1].shape)}, k {kwargs['k']}: n bitwise: {same_n} (mean n "
          f"{float(cnt_k.mean()):.3f}, max {float(cnt_k.max())}); max|dC| {err:.4e}, worst "
          f"relative to the query's largest component {rel:.3e} (bound 1e-5); repeats "
          f"bitwise: {repeats}", flush=True)
    if not (same_n and rel <= 1e-5 and repeats):
        raise AssertionError(f"K8 {what} disagrees with its twin")
    return err, rel


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
    query slots times the finite slots of their bin; K8 each query slot
    against its bin's live candidates (occupied, finite). K6 scores every pair on
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
    elif name == "bin_search":  # every query slot against its bin's finite slots
        ops = 50 * a[0].shape[1] * float(torch.isfinite(a[2]).sum())
        nbytes = _k5_live_bytes(a, out)
    elif name == "rep_top2_counts":
        ops = 21 * a[0].shape[0] * a[1].shape[0]
    elif name == "bin_knn_moments":  # the d2 cross, 40 per neighbour
        qp, bins, _, bvalid = a
        live = (bvalid & torch.isfinite(bins).all(dim=-1)).sum(dim=1).double()
        ops = (21 * qp.shape[1] * float(live.sum()) + 40 * float(out[1].sum())
               + 100 * qp.shape[0] * qp.shape[1])
    else:  # K3, K4, K7: the search, then per query the transform and rows
        gn = name == "bin_gn_moments"
        kept = (a[2 if gn else 1] != 0).sum(dim=1).double()
        live = torch.isfinite(a[5 if gn else 4]).sum(dim=1).double()
        # Pairs the data needs: each valid query slot (qvalid != 0) against
        # the finite slots of its bin, not every padded slot.
        ops = 50 * float((kept * live).sum()) + 400 * float(kept.sum())
    return ops / PEAK_FP32 * 1e3, nbytes


def _k5_live_bytes(args, out) -> int:
    """Bytes K5's function needs: the queries and |b|^2 read once, the rows
    of the finite slots only, the winning payload rows (distinct per bin),
    and both outputs written once."""
    qg_w, bins_c, sq_b, vals = args
    best, matched = out
    n_r, cq, v = matched.shape
    bin_id = torch.arange(n_r, device=matched.device, dtype=torch.float32)
    rows = torch.cat([bin_id.repeat_interleave(cq)[:, None], matched.reshape(-1, v)], 1)
    n_win = torch.unique(rows, dim=0).shape[0]
    n_fin = int(torch.isfinite(sq_b).sum())
    f = 4  # bytes a float
    return f * (qg_w.numel() + sq_b.numel() + n_fin * bins_c.shape[2] + n_win * v
                + best.numel() + matched.numel())


def _k5_padded_ms(args) -> float:
    """ms of K5's pairs counted over every padded slot (50 operations a
    query slot and bin slot) at the card's fp32 peak: its bound before its
    live-slot search, kept to compare with older records."""
    n_r, cq = args[0].shape[:2]
    return 50 * n_r * cq * args[1].shape[1] / PEAK_FP32 * 1e3


def _k8_pr4_ms(args, out) -> float:
    """ms of K8's first design's count at the card's fp32 peak: 60
    operations a pair of a query and a padded slot (the d2, 18 counting
    passes, the membership), 40 per neighbour, 100 per query. Kept to
    compare with older records."""
    n_r, cq = args[0].shape[:2]
    ops = 60 * n_r * cq * args[1].shape[1] + 40 * float(out[1].sum()) + 100 * n_r * cq
    return ops / PEAK_FP32 * 1e3


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


# The real-terrain surface (2.25 M samples, 54 MB) while phase 3f renders:
# the pool's workers are forked, so they read it copy-on-write instead of
# each receiving a pickled copy or sampling it again.
_SURFACE = None


def _observe(job):
    """One real-terrain frame from a numpy (q, t) pose, or only its
    landmarks (the strided slice that equals ``get_landmarks``, as
    bench.py:552-558 takes it): a worker of the render pool, which reads
    the surface its parent forked with."""
    from icp_tpu_torch.sensors import realdata

    q, t, landmarks = job
    frame = realdata.observe(*_SURFACE, q, t)
    if landmarks:
        return np.ascontiguousarray(frame[49:49 + 384:3, 65:65 + 512:4].reshape(M, 8))
    return frame


def _render_terrain(pose_lists, landmarks_of=()):
    """Every frame of each pose list, rendered in a pool of forked
    processes (one per core), over one terrain surface; the lists whose
    index is in ``landmarks_of`` come back as (16384, 8) landmark sets.
    Returns the frame lists and the seconds the surface and the frames
    took."""
    import concurrent.futures
    import multiprocessing
    import os

    from icp_tpu_torch.sensors import realdata

    global _SURFACE
    t0 = time.perf_counter()
    _SURFACE = realdata.terrain_surface()
    jobs = [(p.q.cpu().numpy(), p.t.cpu().numpy(), i in landmarks_of)
            for i, poses in enumerate(pose_lists) for p in poses]
    with concurrent.futures.ProcessPoolExecutor(
            os.cpu_count(), mp_context=multiprocessing.get_context("fork")) as pool:
        frames = list(pool.map(_observe, jobs, chunksize=4))
    _SURFACE = None
    out, i = [], 0
    for poses in pose_lists:
        out.append(frames[i:i + len(poses)])
        i += len(poses)
    return out, time.perf_counter() - t0


def render_sequences():
    """The real-terrain sequences of phases 3f and 3g, rendered in one
    pool over one surface: the bench's two 100-frame arcs
    (bench.py:419-449, 493-513), the second rotation-heavy, and its
    200-frame SLAM circle of radius 120 mm (bench.py:545-558), of which
    only the landmarks come back. Returns (arcs, arc frame lists, circle
    poses, circle landmark sets)."""
    import os

    from icp_tpu_torch.sensors import synthetic
    from icp_tpu_torch.slam import se3

    arcs = {"odometry": synthetic.orbit_trajectory(100, radius_mm=120.0, yaw_rad=0.12,
                                                    device="cpu"),
            "odometry_rot": synthetic.orbit_trajectory(100, radius_mm=60.0, yaw_rad=0.5,
                                                        device="cpu")}
    a = 2 * np.pi * np.arange(N_SLAM) / N_SLAM
    circle = [se3.Pose(torch.tensor([0.0, 0.0, 0.0, 1.0]), torch.tensor(
        [120.0 * np.cos(x) - 120.0, 120.0 * np.sin(x), 0.0], dtype=torch.float32)) for x in a]
    frame_lists, render_s = _render_terrain([*arcs.values(), circle], landmarks_of=(2,))
    print(f"real-terrain render: {render_s:.3f} s for {200 + N_SLAM} frames of 640 x 480 "
          f"({os.cpu_count()} processes, the surface included)", flush=True)
    return arcs, frame_lists[:2], circle, frame_lists[2]


def odometry_phase(dev, smi, drive_call, require_launched, arcs, frame_lists) -> None:
    """Phase 3f: the odometry front end at full width (640 x 480 frames,
    m 16384, n_r 256). Raises on any failed check."""
    import os
    import tempfile

    from icp_tpu_torch import ICPConfig, ICPParams, Objective, register
    from icp_tpu_torch.runtime import native as host
    from icp_tpu_torch.sensors import guided_filter, synthetic, tum
    from icp_tpu_torch.sensors.stream import FrameSource
    from icp_tpu_torch.slam import se3
    from icp_tpu_torch.slam.odometry import (KeyframePolicy, absolute_trajectory_error,
                                             frame_to_landmarks, odometry_chain_device,
                                             relative_pose_error, run_odometry)

    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    lms = {name: torch.stack([frame_to_landmarks(torch.from_numpy(f).to(dev)) for f in frames])
           for name, frames in zip(arcs, frame_lists)}

    # The bench's chain: GICP, 8 iterations, zero thresholds (bench.py:46-47).
    seq_cfg = ICPConfig(max_iterations=8, estimate_scale=False, objective=Objective.GICP)
    fast_d = ICPParams(alpha=ALPHA, angle_threshold_deg=0.0, translation_threshold=0.0).to(dev)

    def chain(seq_lms):
        """The whole chain, with any call that waits for the stream an error."""
        torch.cuda.set_sync_debug_mode("error")
        try:
            return odometry_chain_device(seq_lms, fast_d, seq_cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    bounds = {"odometry": (22.0, 5.5), "odometry_rot": (30.0, 7.5)}  # bench.py:479, 510
    metrics = {}
    for name, poses in arcs.items():
        (wq, wt, ks), wall, ran = drive_call(lambda: chain(lms[name]))
        est = [se3.Pose(wq[i].cpu(), wt[i].cpu()) for i in range(len(poses))]
        gt = [se3.relative(poses[0], p) for p in poses]
        ate = absolute_trajectory_error(est, gt)
        rpe10, _ = relative_pose_error(est, gt, delta=10)
        metrics[f"{name}_ate_mm_100f"] = ate
        metrics[f"{name}_rpe10_mm"] = rpe10
        print(f"{name} chain (100 frames, GICP, max_iterations 8, thresholds 0) on {card}: "
              f"ATE {ate} mm, RPE10 {rpe10} mm (bounds {bounds[name][0]}, "
              f"{bounds[name][1]}); ks all 8: {bool((ks == 8).all())}; wall {wall:.3f} s "
              f"under sync debug mode; launches={ran}", flush=True)
        if not (ate < bounds[name][0] and rpe10 < bounds[name][1]):
            raise AssertionError(f"{name}: the chain misses the bench's drift gate")
        if not (ks.shape == (99,) and bool((ks == 8).all())):
            raise AssertionError(f"{name}: k {ks.tolist()}, expected 8 on every frame")
        require_launched(ran, ("rep_assign_counts", "bin_table", "bin_gn_moments"),
                         8 * 99, f"{name} chain")

    # frames/s: the marginal rate 50 / (T(100) - T(50)) of the chain alone,
    # the least of 3 rounds of each (bench.py's differencing).
    best = {100: float("inf"), 50: float("inf")}
    for _ in range(3):
        for n in (100, 50):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            chain(lms["odometry"][:n])
            torch.cuda.synchronize()
            best[n] = min(best[n], time.perf_counter() - t0)
    fps = 50 / (best[100] - best[50])
    print(f"odometry chain on {card}: odometry_frames_per_s {fps} (T100 {best[100]} s, "
          f"T50 {best[50]} s, least of 3 rounds); odometry_ate_mm_100f "
          f"{metrics['odometry_ate_mm_100f']}, odometry_rpe10_mm {metrics['odometry_rpe10_mm']}, "
          f"odometry_rot_ate_mm_100f {metrics['odometry_rot_ate_mm_100f']}, "
          f"odometry_rot_rpe10_mm {metrics['odometry_rot_rpe10_mm']}", flush=True)

    # The host chain against the device chain, POINT, on 4 rendered frames
    # (tests/test_se3_odometry.py's trajectory and bound).
    scene = synthetic.default_scene()
    poses_gt = synthetic.orbit_trajectory(4, radius_mm=40.0, yaw_rad=0.03)
    frames = [synthetic.render_cloud(scene, p) for p in poses_gt]
    cfg_o = ICPConfig(max_iterations=40, estimate_scale=False)
    prm = ICPParams(alpha=ALPHA)
    host_res, wall_h, ran_h = drive_call(
        lambda: run_odometry(frames, prm, cfg_o, policy=KeyframePolicy(max_gap=2)))
    lms4 = torch.stack([frame_to_landmarks(f) for f in frames])
    (wq, wt, ks), wall_d, ran_d = drive_call(lambda: odometry_chain_device(lms4, prm, cfg_o))
    same = all(torch.equal(wq[i], p.q) and torch.equal(wt[i], p.t)
               for i, p in enumerate(host_res.poses))
    same_k = ks.tolist() == [int(s.k) for s in host_res.relative]
    ate = absolute_trajectory_error(host_res.poses, [se3.Pose(p.q, p.t) for p in poses_gt])
    print(f"run_odometry vs odometry_chain_device (4 frames, POINT): poses equal {same}, "
          f"k equal {same_k} ({ks.tolist()}); ATE {ate} mm (bound 15); keyframes "
          f"{host_res.keyframes}; walls {wall_h:.3f} / {wall_d:.3f} s; launches "
          f"{ran_h} / {ran_d}", flush=True)
    if not (same and same_k and ate < 15.0 and host_res.keyframes[0] == 0
            and len(host_res.keyframes) >= 2):
        raise AssertionError("the host and device odometry chains disagree or drift")
    for ran in (ran_h, ran_d):
        require_launched(ran, ("bin_point_moments",), 3, "4-frame POINT chain")

    # A TUM round trip through the port's PNG codec (tests/test_tum.py's bounds).
    with tempfile.TemporaryDirectory() as root:
        tum.write_synthetic_sequence(root, n_frames=3)
        seq = tum.load_sequence(root)
        clouds = list(tum.sequence_clouds(seq, fx=595.0, fy=595.0))
        res, wall, ran = drive_call(lambda: run_odometry(
            clouds, prm, ICPConfig(estimate_scale=False), policy=KeyframePolicy(max_gap=2)))
        est_q = torch.stack([p.q for p in res.poses])
        est_t = torch.stack([p.t for p in res.poses])
        ate, rpe_t, rpe_r = tum.evaluate_trajectory(seq, est_q, est_t)
        drifted = tum.evaluate_trajectory(
            seq, est_q, est_t.cpu() + torch.arange(3.0)[:, None] * 50.0)
    print(f"TUM round trip (3 frames, PNG codec): ATE {ate} m, RPE_t {rpe_t} m, RPE_r "
          f"{rpe_r} deg (bounds 0.02, 0.02, 1); drifted copy {drifted[0]} / {drifted[1]}; "
          f"launches={ran}", flush=True)
    if not (ate < 0.02 and rpe_t < 0.02 and rpe_r < 1.0
            and drifted[0] > ate and drifted[1] > rpe_t):
        raise AssertionError("the TUM round trip misses its bounds")
    require_launched(ran, ("rep_assign_counts", "bin_table", "bin_point_moments"), 1,
                     "TUM odometry")

    # FrameSource: five real-terrain frames through the native codec and ring.
    lib = host.load()
    path = host.build_info.get("path") or ""
    build_root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    print(f"native host library: {path} ({'compiled' if host.build_info.get('built') else 'loaded'}"
          f" in {host.build_info.get('seconds', 0):.2f} s)", flush=True)
    if lib is None or not path.startswith(build_root + os.sep):
        raise AssertionError(f"the native host library was not built under build/: "
                             f"{host.build_info}")
    raw = [f.reshape(-1, 8) for f in frame_lists[0][:5]]
    with tempfile.TemporaryDirectory() as root:
        for i, f in enumerate(raw):
            host.write_cloud(os.path.join(root, f"frame_{i:04d}.bin"), f)
        with FrameSource(root) as src:
            streamed = list(src)
            native_ring = src.native
    if not (native_ring and [i for i, _ in streamed] == list(range(5))
            and all(np.array_equal(c, f) for (_, c), f in zip(streamed, raw))):
        raise AssertionError("FrameSource did not stream the frames through the native ring")
    a = register(frame_to_landmarks(streamed[0][1]), frame_to_landmarks(streamed[1][1]),
                 prm, seq_cfg)
    b = register(frame_to_landmarks(torch.from_numpy(raw[0]).to(dev)),
                 frame_to_landmarks(torch.from_numpy(raw[1]).to(dev)), prm, seq_cfg)
    equal = all(torch.equal(getattr(a, f), getattr(b, f))
                for f in ("q", "t", "s", "qk", "tk", "sk", "k"))
    print(f"FrameSource (native ring, 5 frames): streamed bitwise; frame 0 -> 1 registration "
          f"(k {int(a.k)}) equal to the frames passed directly: {equal}", flush=True)
    if not equal:
        raise AssertionError("streamed frames register differently")

    # The guided filter on a rendered frame, card against CPU.
    cloud = torch.from_numpy(frame_lists[0][0])
    depth, rgb = cloud[..., 2].contiguous(), cloud[..., 4:7].contiguous()
    depth_d, rgb_d = depth.to(dev), rgb.to(dev)
    fd, fr = guided_filter.filter_depth(depth_d), guided_filter.filter_rgb(rgb_d)
    dd = float((fd.cpu() - guided_filter.filter_depth(depth)).abs().max())
    dr = float((fr.cpu() - guided_filter.filter_rgb(rgb)).abs().max())
    holes = bool(torch.equal(fd.cpu() == 0, depth == 0))
    ms_d = _cuda_ms(lambda: guided_filter.filter_depth(depth_d))
    ms_r = _cuda_ms(lambda: guided_filter.filter_rgb(rgb_d))
    print(f"guided filter on {card} (640 x 480, radius 5): filter_depth {ms_d} ms, "
          f"filter_rgb {ms_r} ms; card vs CPU max|d| depth {dd} mm (bound 1.0), rgb {dr} "
          f"(bound 1e-4); invalid depth kept 0: {holes} ({int((depth == 0).sum())} holes)",
          flush=True)
    if not (dd <= 1.0 and dr <= 1e-4 and holes):
        raise AssertionError("the guided filter on the card disagrees with the CPU")


def _no_host_read(fn):
    """(fn(), wall s) with any call that waits for the stream an error."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def slam_phase(dev, smi, drive_call, require_launched, circle, circle_lms):
    """Phase 3g: the SLAM back end and the bench's wall, pyramid and slam
    gates at full width (640 x 480 frames, m 16384, n_r 256). Raises on any
    failed check. Returns the slam gate's pose graph (before the backend
    moved it) and its ground-truth node positions relative to node 0."""
    from icp_tpu_torch import ICPConfig, ICPParams, Objective, register
    from icp_tpu_torch.icp.pyramid import register_pyramid
    from icp_tpu_torch.icp.quaternion import qangle_deg, qconj, qmul
    from icp_tpu_torch.ops.sampling import get_landmarks
    from icp_tpu_torch.sensors import realdata, synthetic
    from icp_tpu_torch.slam import bundle_adjustment as ba
    from icp_tpu_torch.slam import mapping
    from icp_tpu_torch.slam import pose_graph as pg
    from icp_tpu_torch.slam import se3
    from icp_tpu_torch.slam.odometry import KeyframePolicy

    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    t0 = time.perf_counter()

    # The bench's wall gate (bench.py:352-391): a frontal wall of the real
    # photograph, in-plane motion ~2.5x the landmark pitch, POINT, 60
    # iterations. At alpha 4e5 the colour lanes must find the lateral
    # motion; geometry alone (alpha 1e-6) must miss it; z is exact either way.
    wpts, wrgb = realdata.wall_surface()
    id_q = np.array([0, 0, 0, 1], np.float32)
    wt = np.array([30.0, -15.0, 4.0], np.float32)
    wla, wlb = (get_landmarks(torch.from_numpy(
        realdata.observe(wpts, wrgb, id_q, t).reshape(-1, 8)).to(dev)).contiguous()
        for t in (np.zeros(3, np.float32), wt))
    wall_cfg = ICPConfig(estimate_scale=False, max_iterations=60)
    wall = {}
    for alpha in (4e5, 1e-6):
        st, wall_s, ran = drive_call(
            lambda a=alpha: register(wla, wlb, ICPParams(alpha=a), wall_cfg))
        t = st.t.cpu().numpy()
        wall[alpha] = (float(np.linalg.norm(t[:2] - wt[:2])), abs(float(t[2]) - float(wt[2])))
        print(f"wall, alpha {alpha} (POINT, max_iterations 60): k={int(st.k)} lateral error "
              f"{wall[alpha][0]} mm, z error {wall[alpha][1]} mm, wall {wall_s:.3f} s; "
              f"launches={ran}", flush=True)
        require_launched(ran, ("rep_assign_counts", "bin_point_moments"), int(st.k),
                         f"wall alpha {alpha}")
    (lat, z_err), (geo_lat, geo_z) = wall[4e5], wall[1e-6]
    print(f"wall gate on {card}: wall_lat_err_mm {lat}, wall_z_err_mm {z_err}, "
          f"wall_geo_lat_err_mm {geo_lat} (geometry-only z {geo_z}); bounds lateral < 6, "
          f"z < 0.5, geometry-only lateral > 25; the reference's TPU record "
          f"{REFERENCE_WALL[0]} / {REFERENCE_WALL[1]} / {REFERENCE_WALL[2]}", flush=True)
    if not (lat < 6.0 and z_err < 0.5 and geo_z < 0.5 and geo_lat > 25.0):
        raise AssertionError("the wall gate fails")

    # The bench's pyramid pair (bench.py:325-348): PLANE from a large
    # offset, coarse to fine (4, 2, 1).
    scene = synthetic.default_scene(device="cpu")
    ident = synthetic.CameraPose.identity(device="cpu")
    pose_c = synthetic.CameraPose(
        torch.tensor([0.0, np.sin(0.03), 0.0, np.cos(0.03)], dtype=torch.float32),
        torch.tensor([60.0, -40.0, 30.0]))
    la, lc = (get_landmarks(synthetic.render_cloud(scene, p).reshape(-1, 8)).contiguous().to(dev)
              for p in (ident, pose_c))
    rel = se3.relative(ident, pose_c)
    stp, wall_p, ran = drive_call(lambda: register_pyramid(
        la, lc, ICPParams(alpha=ALPHA), ICPConfig(estimate_scale=False, objective=Objective.PLANE),
        strides=(4, 2, 1)))
    pyr_t = float(torch.linalg.vector_norm(stp.t.cpu() - rel.t))
    pyr_a = float(qangle_deg(qmul(stp.q.cpu(), qconj(rel.q))))
    print(f"bench pyramid pair on {card} (PLANE, 0.06 rad about y, t (60, -40, 30) mm, "
          f"strides 4, 2, 1): t_err {pyr_t} mm, a_err {pyr_a} deg (bounds 2.0, 0.1); the "
          f"reference's TPU record {REFERENCE_PYRAMID[0]} / {REFERENCE_PYRAMID[1]}; k={int(stp.k)} "
          f"wall {wall_p:.3f} s; launches={ran}", flush=True)
    if not (pyr_t < 2.0 and pyr_a < 0.1):
        raise AssertionError("the bench's pyramid gate fails")
    require_launched(ran, ("rep_assign_counts", "bin_table", "bin_gn_moments"), int(stp.k),
                     "bench pyramid")
    print(f"phase 3g wall + pyramid: {time.perf_counter() - t0:.1f} s", flush=True)

    # The bench's slam gate (bench.py:521-627): 200 frames on a closed
    # circle over the real terrain through SlamEngine (GICP, 8 iterations,
    # every frame a keyframe, closures 50 keyframes apart within 60 mm and
    # 20 deg, every verification batch padded to 16), then optimize_map.
    t0 = time.perf_counter()
    eng = mapping.SlamEngine(
        params=ICPParams(alpha=2e2),
        config=ICPConfig(estimate_scale=False, objective=Objective.GICP, max_iterations=8),
        policy=KeyframePolicy(max_gap=1),
        loop_config=mapping.LoopClosureConfig(max_distance=60.0, max_angle_deg=20.0,
                                              min_gap=50, verify_pad_to=16))
    lms = [torch.from_numpy(f).to(dev) for f in circle_lms]
    lanes, batch = [], mapping.register_batch

    def batch_spy(fixed8, moving8, *a, **kw):  # the lane count of each verification
        lanes.append(fixed8.shape[0])
        return batch(fixed8, moving8, *a, **kw)

    mapping.register_batch = batch_spy
    try:
        _, t_frames, ran = drive_call(lambda: [eng.process_frame(f) for f in lms])
    finally:
        mapping.register_batch = batch
    kfs, closures = eng.map.keyframes, eng.map.loop_closures
    ts_gt = np.stack([p.t.numpy() for p in circle])
    correct = 0
    for (ci, cj), meas in zip(eng.map.edges, eng.map.measurements):
        if (ci, cj) not in set(closures):
            continue
        gt_rel = se3.relative(circle[kfs[ci].index], circle[kfs[cj].index])
        if (float(torch.linalg.vector_norm(meas.t.cpu() - gt_rel.t)) < 6.0
                and float(qangle_deg(qmul(meas.q.cpu(), qconj(gt_rel.q)))) < 1.5):
            correct += 1
    precision = correct / max(len(closures), 1)
    true_pairs = {(i, j) for j in range(N_SLAM) for i in range(j - eng.loop_config.min_gap)
                  if np.linalg.norm(ts_gt[j] - ts_gt[i]) < 20.0}
    kf_pairs = {(kfs[i].index, kfs[j].index) for (i, j) in closures}
    recall = sum(1 for p in true_pairs if p in kf_pairs) / max(len(true_pairs), 1)

    def kf_ate():
        errs = [np.linalg.norm(kf.pose.t.cpu().numpy() - (ts_gt[kf.index] - ts_gt[0]))
                for kf in kfs]
        return float(np.sqrt(np.mean(np.square(errs))))

    ate_before = kf_ate()
    graph = eng._graph()  # the gate's pose graph, before the backend moves it

    # The LM loops enqueue with no host read and repeat bit for bit: the
    # dense optimize on the gate's graph, PCG on a 600-node ring. Against
    # the CPU: on the ring, each pose within tests/test_torch_pose_graph.py's
    # ring tolerances (2 mm, 5e-3 in q, 1 % of the cost). The gate's graph
    # has a valley so flat (its rotations, residuals in radians beside
    # residuals in mm, over real-terrain measurements) that two float32
    # solves part along it by mm and degrees at one cost: there the cost
    # is held within 1e-4 and the ATE to the ground truth within 1 mm, and
    # the per-pose differences are printed.
    graph_gt = ts_gt[[kf.index for kf in kfs]] - ts_gt[0]

    def graph_ate(x):
        return _ate(x.t, graph_gt)

    graph_cpu = pg.PoseGraph(*(x.cpu() for x in graph))
    ring = pg.demo_ring_graph(600, device=dev)  # 12 closures spanning 24 nodes
    ring_cpu = pg.PoseGraph(*(x.cpu() for x in ring))
    for name, fn, g, g_cpu in (("optimize", pg.optimize, graph, graph_cpu),
                               ("optimize_pcg", pg.optimize_pcg, ring, ring_cpu)):
        a, wall_a = _no_host_read(lambda: fn(g, iterations=10))
        b, wall_b = _no_host_read(lambda: fn(g, iterations=10))
        same = torch.equal(a.q, b.q) and torch.equal(a.t, b.t)
        c = fn(g_cpu, iterations=10)
        dt = float((a.t.cpu() - c.t).abs().max())
        dq = float((a.q.cpu() - c.q).abs().max())
        c0, ca, cc = (float(pg.graph_cost(x)) for x in (g, a, c))
        if g is graph:
            close = abs(ca - cc) <= 1e-4 * cc and abs(graph_ate(a) - graph_ate(c)) <= 1.0
            bounds = (f"ATE {graph_ate(a)} mm (CPU {graph_ate(c)}, bound 1.0 apart), cost "
                      f"bound 1e-4 apart")
        else:
            close = dt <= 2.0 and dq <= 5e-3 and abs(ca - cc) <= 1e-2 * cc
            bounds = "bounds 2.0 mm, 5e-3, cost 1e-2 apart"
        print(f"{name} on {card} ({g.q.shape[0]} nodes, {g.edge_i.shape[0]} edges, 10 "
              f"iterations) under sync debug mode: walls {wall_a:.4f} s (first call) and "
              f"{wall_b:.4f} s; twice bitwise equal: {same}; cost {c0} -> {ca} (CPU {cc}); "
              f"card vs CPU max|dt| {dt} mm, max|dq| {dq}; {bounds}", flush=True)
        if not (same and close and ca <= c0):
            raise AssertionError(f"{name}: not repeatable, or off the CPU's result")

    t1 = time.perf_counter()
    eng.optimize_map(iterations=10)
    torch.cuda.synchronize()
    opt_ms = (time.perf_counter() - t1) * 1e3
    ate_after = kf_ate()
    fps = N_SLAM / t_frames
    print(f"slam gate on {card}: slam_keyframes {len(kfs)}, slam_closures {len(closures)}, "
          f"slam_closure_precision {precision}, slam_closure_recall {recall}, "
          f"slam_ate_before_mm {ate_before}, slam_ate_after_mm {ate_after}, "
          f"slam_frames_per_s {fps} ({t_frames:.3f} s for {N_SLAM} frames), optimize_map "
          f"{opt_ms:.3f} ms (10 iterations, dense); batch sizes verified {sorted(set(lanes))} "
          f"({len(lanes)} batches, {eng.n_pairs_verified} pairs); bounds precision >= 0.9, "
          f"recall >= 0.8, ATE after < 40 and < 0.8 x before; the reference's TPU record "
          f"{REFERENCE_SLAM}; launches={ran}", flush=True)
    if not (precision >= 0.9 and recall >= 0.8 and ate_after < 40.0
            and ate_after < 0.8 * ate_before):
        raise AssertionError("the slam gate fails")
    if not (lanes and set(lanes) == {16} and set(eng._verify_fns) == {16}):
        raise AssertionError(f"verification batches of {sorted(set(lanes))} lanes, not 16")
    require_launched(ran, ("rep_assign_counts", "bin_table", "bin_gn_moments"), 8 * (N_SLAM - 1),
                     "slam engine")
    print(f"phase 3g slam: {time.perf_counter() - t0:.1f} s", flush=True)

    # ba_solve after its host degree check: no host read, bit for bit twice,
    # and the cost falls.
    prob = ba.demo_problem(32, 4096, 8, device=dev)
    degree = ba.check_max_degree(prob.obs_point, prob.points.shape[0], 8)
    a, wall_a = _no_host_read(lambda: ba._ba_solve(prob, 5, 8, 1e-4, True))
    b, wall_b = _no_host_read(lambda: ba._ba_solve(prob, 5, 8, 1e-4, True))
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    c0, c1 = float(ba.ba_cost(prob)), float(ba.ba_cost(a))
    print(f"ba_solve on {card} (32 cameras, 4096 points, {prob.obs_cam.shape[0]} observations, "
          f"degree <= {degree}, 5 iterations) under sync debug mode: {wall_a * 1e3:.3f} ms "
          f"(first call), {wall_b * 1e3:.3f} ms; twice bitwise equal: {same}; cost {c0} -> "
          f"{c1}", flush=True)
    if not (same and c1 < 0.01 * c0):
        raise AssertionError("ba_solve: not repeatable, or the cost did not fall")
    return graph, graph_gt


def _ate(t, gt) -> float:
    """RMS position error (mm) of the nodes ``t`` against ``gt``."""
    return float(np.sqrt(np.mean(np.sum((t.double().cpu().numpy() - gt) ** 2, 1))))


def sharded_phase(dev, smi, drive_call, require_launched, launches, slam_graph,
                  slam_gt) -> None:
    """Phase 3h: slice 9, the sharded paths (``icp_tpu_torch.parallel``) at
    the flagship width, as ``__graft_entry__.dryrun_multichip`` runs them:
    POINT on the synthetic pair, PLANE, GICP and robust-adaptive PLANE on
    the rendered gate pair (the robust one with its 12 % outliers), BRUTE
    POINT on the synthetic pair. Each within its gate and, within the JAX
    tests' sharded-vs-single bars, at ``register``'s state on the card.

    A world of 1 runs in this process on NCCL. Worlds of 2 and 4 ranks
    share the one card: NCCL refuses two ranks on one GPU, so their group
    is gloo, which reduces the CUDA tensors itself; the kernels and the
    math stay on the card. Their ranks are processes of
    ``icp_tpu_torch.parallel.dryrun``, which load the library this process
    built and never compile. Every rank must end bitwise equal to rank 0.
    The (2, 1) world also runs the sharded pose-graph solvers (the slam
    gate's graph, dense; the 600-node ring, PCG) and the sharded BA, against
    the single-device solvers on the card. With two or more cards the (2,
    1) world also runs on NCCL across cards (and (2, 2) with four).
    K2, K3 and K5 are held against their twins at every rank's shapes of
    (1, 1), (2, 1), (1, 2) and (2, 2) in phase 5 (the support matrix).
    Raises on any failed check, a failed rank or a missed deadline."""
    import tempfile

    import torch.distributed as dist

    from icp_tpu_torch import (Correspondence, ICPConfig, ICPParams, Objective,
                               RobustKernel, Weighting, register)
    from icp_tpu_torch.icp.quaternion import qangle_deg, qconj, qmul
    from icp_tpu_torch.kernels import native
    from icp_tpu_torch.parallel import initialize_multihost, make_mesh, make_sharded_register
    from icp_tpu_torch.parallel.dryrun import ba_shards, free_port, launch_world
    from icp_tpu_torch.sensors.synthetic import synthetic_pair
    from icp_tpu_torch.slam import bundle_adjustment as ba
    from icp_tpu_torch.slam import pose_graph as pg

    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    t_phase = time.perf_counter()
    native.load_library()  # built here, before any rank starts: the ranks only load it
    params = ICPParams(alpha=ALPHA)
    f_np, m_np = synthetic_pair(M, seed=0)
    fixed, moving = torch.from_numpy(f_np), torch.from_numpy(m_np)
    la, lb, dirty = _rendered_pair()
    point_gate, gate = (0.05, 0.005), (T_GATE, A_GATE)
    synth, rendered = (Q_GT, T_GT), (Q_GT_R, T_GT_R)
    # name: (config, fixed, moving, gate, ground truth, vs-register bars (mm,
    # deg; tests/test_sharded.py), kernels launched at least k times)
    variants = {
        "point": (ICPConfig(), fixed, moving, point_gate, synth, (0.1, 5e-3),
                  ("bin_table", "bin_point_moments")),
        "plane": (ICPConfig(objective=Objective.PLANE, estimate_scale=False), la, lb, gate,
                  rendered, (0.3, 0.02), ("bin_table", "bin_search")),
        "gicp": (ICPConfig(objective=Objective.GICP, estimate_scale=False), la, lb, gate,
                 rendered, (0.3, 0.02), ("bin_table", "bin_search")),
        "robust": (ICPConfig(objective=Objective.PLANE, weighting=Weighting.REGULAR,
                             robust=RobustKernel.TRIMMED, robust_adaptive=True,
                             estimate_scale=False), la, dirty, gate, rendered, (0.3, 0.02),
                   ("bin_table", "bin_search")),
        "brute": (ICPConfig(correspondence=Correspondence.BRUTE), fixed, moving, point_gate,
                  synth, (0.1, 5e-3), ()),
    }
    single = {}  # name: (register's state on the card, its wall on the second call)
    for name, (config, f, m, *_) in variants.items():
        for _ in range(2):
            t0 = time.perf_counter()
            st = register(f.to(dev), m.to(dev), params, config)
            torch.cuda.synchronize()
            single[name] = (st, time.perf_counter() - t0)

    def check(name, st, wall, ran, where):
        config, _, _, (t_gate, a_gate), (q_gt, t_gt), (t_bar, a_bar), kernels = variants[name]
        ref, ref_wall = single[name]
        k = int(st.k)
        t_err, a_err = _errors(st, q_gt, t_gt)
        dt = float(np.linalg.norm(st.t.double().cpu().numpy() - ref.t.double().cpu().numpy()))
        da = float(qangle_deg(qmul(st.q.cpu(), qconj(ref.q.cpu()))))
        print(f"sharded {name} {where}: k={k} (register {int(ref.k)}) t_err={t_err:.6f} mm "
              f"a_err={a_err:.7f} deg (gate {t_gate} mm, {a_gate} deg); vs register |dt|="
              f"{dt:.6f} mm dangle={da:.7f} deg (bars {t_bar} mm, {a_bar} deg); wall "
              f"{wall:.3f} s (register {ref_wall:.3f} s); launches={ran}", flush=True)
        if not (1 <= k < config.max_iterations and t_err < t_gate and a_err < a_gate):
            raise AssertionError(f"sharded {name} {where}: off the ground truth")
        if not (dt < t_bar and da < a_bar):
            raise AssertionError(f"sharded {name} {where}: off register's state")
        require_launched(ran, ("bin_table",), 1, f"sharded {name} {where}")
        require_launched(ran, kernels, k, f"sharded {name} {where}")

    sharded_launches = {}  # every rank's launches on the sharded path, summed
    # A world of 1 on NCCL, in this process: its launches count on the main path.
    initialize_multihost(f"localhost:{free_port()}", 1, 0, backend="nccl", timeout_s=60)
    try:
        mesh = make_mesh(1, 1, dev)
        for name in ("point", "plane", "gicp"):
            config, f, m = variants[name][:3]
            run = make_sharded_register(mesh, config)
            st, wall, ran = drive_call(lambda: run(f.to(dev), m.to(dev), params))
            check(name, st, wall, ran, "mesh (1, 1), NCCL")
            for k, n in ran.items():
                sharded_launches[k] = sharded_launches.get(k, 0) + n
    finally:
        dist.destroy_process_group()
    print(f"phase 3h world of 1: {time.perf_counter() - t_phase:.1f} s", flush=True)

    # The solvers' single-device references on the card, and the ring's
    # ground truth (demo_ring_graph: a 400 mm circle, node 0 at the origin).
    ring = pg.demo_ring_graph(600, device="cpu")
    ring_gt = np.stack([[400.0 * np.cos(2 * np.pi * i / 600), 0.0,
                         400.0 * np.sin(2 * np.pi * i / 600)] for i in range(600)])
    ring_gt = ring_gt - ring_gt[0]
    solver_cases = {
        "optimize": (slam_graph, slam_gt, pg.optimize),
        "optimize_pcg": (ring, ring_gt, pg.optimize_pcg),
    }
    solver_refs = {name: fn(pg.PoseGraph(*(x.to(dev) for x in g)), iterations=10)
                   for name, (g, _, fn) in solver_cases.items()}
    prob = ba.demo_problem(32, 4096, 8, device="cpu")
    ba_ref = ba.ba_solve(prob.__class__(*(x.to(dev) for x in prob)), 5, 8)

    def job(mesh_shape, solvers):
        # A first, unchecked POINT registration takes each rank's first-call
        # costs (CUDA context, library load, solver handles) off the walls.
        tasks = [dict(kind="register", name=name, config=config, params=params,
                      fixed=f, moving=m)
                 for name, (config, f, m, *_) in [("warm-up", variants["point"]),
                                                  *variants.items()]]
        if solvers:
            tasks += [dict(kind=name, name=name,
                           graph=pg.pad_edges(pg.PoseGraph(*(x.cpu() for x in g)), 2),
                           kwargs={"iterations": 10})
                      for name, (g, _, _) in solver_cases.items()]
            tasks.append(dict(kind="ba", name="ba", problem=ba_shards(prob, 2, 8), n_cams=32,
                              kwargs={"iterations": 5, "max_degree": 8}))
        return {"mesh": mesh_shape, "device": "cuda", "tasks": tasks}

    worlds = [((2, 1), "gloo", True), ((1, 2), "gloo", False), ((2, 2), "gloo", False)]
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        worlds.append(((2, 1), "nccl", False))
    if n_cards >= 4:
        worlds.append(((2, 2), "nccl", False))
    else:
        print(f"{n_cards} card(s): the NCCL worlds across cards wait for a machine with "
              "two or more", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for mesh_shape, backend, solvers in worlds:
            t0 = time.perf_counter()
            world = mesh_shape[0] * mesh_shape[1]
            where = (f"mesh {mesh_shape}, {backend}, "
                     + ("ranks sharing one card" if n_cards == 1 else "one card a rank"))
            results = launch_world(job(mesh_shape, solvers), world,
                                   f"{tmp}/{mesh_shape[0]}x{mesh_shape[1]}{backend}",
                                   backend=backend, timeout=180.0, init_timeout=60.0)
            for task, res0 in results[0]["tasks"].items():
                for r in results[1:]:
                    out = r["tasks"][task]["out"]
                    if not all(torch.equal(out[k], v) for k, v in res0["out"].items()):
                        raise AssertionError(f"{where}: rank {r['rank']}'s {task} differs "
                                             "from rank 0's")
                for name in res0["launches"]:
                    n = sum(r["tasks"][task]["launches"][name] for r in results)
                    launches[name] += n
                    sharded_launches[name] = sharded_launches.get(name, 0) + n
                per_rank = [{k: v for k, v in r["tasks"][task]["launches"].items() if v}
                            for r in results]
                if task == "warm-up":
                    continue
                if task in variants:
                    out = res0["out"]
                    st = type(single[task][0])(**{k: out[k] for k in
                                                  ("q", "t", "s", "qk", "tk", "sk", "k")})
                    check(task, st, max(r["tasks"][task]["wall"] for r in results),
                          res0["launches"], where)
                    print(f"  {task} launches per rank: {per_rank}; every rank bitwise "
                          "rank 0's", flush=True)
                elif task == "ba":
                    out = res0["out"]
                    dt = float((out["pose_t"] - ba_ref.pose_t.cpu()).abs().max())
                    dp = float((out["points"] - ba_ref.points.cpu()).abs().max())
                    print(f"sharded BA {where} (32 cameras, 4096 points, 5 iterations): "
                          f"vs ba_solve max|dt| {dt} mm, max|dp| {dp} mm (bound 5e-2); wall "
                          f"{res0['wall']:.3f} s; every rank bitwise rank 0's", flush=True)
                    if not (dt <= 5e-2 and dp <= 5e-2):
                        raise AssertionError("sharded BA: off ba_solve")
                else:
                    g, gt, _ = solver_cases[task]
                    ref = solver_refs[task]
                    out = res0["out"]
                    g_cpu = pg.PoseGraph(*(x.cpu() for x in g))
                    c = float(pg.graph_cost(g_cpu._replace(q=out["q"], t=out["t"])))
                    c_ref = float(pg.graph_cost(pg.PoseGraph(*(x.cpu() for x in ref))))
                    a, a_ref = _ate(out["t"], gt), _ate(ref.t, gt)
                    print(f"sharded {task} {where} ({g.q.shape[0]} nodes, {g.edge_i.shape[0]} "
                          f"edges, 10 iterations): cost {c} (single {c_ref}, bound 1e-4 "
                          f"apart), ATE {a} mm (single {a_ref}, bound 1 mm apart); wall "
                          f"{res0['wall']:.3f} s; every rank bitwise rank 0's", flush=True)
                    if not (abs(c - c_ref) <= 1e-4 * c_ref and abs(a - a_ref) <= 1.0):
                        raise AssertionError(f"sharded {task}: off the single-device solve")
            print(f"phase 3h {where}: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"phase 3h launches on the sharded path, every rank: "
          f"{ {k: n for k, n in sharded_launches.items() if n} }", flush=True)
    print(f"phase 3h sharded: {time.perf_counter() - t_phase:.1f} s", flush=True)


def _quiet(fn, *args, tail: int = 2, **kw):
    """``fn(*args, **kw)`` with its printed lines kept back; the last
    ``tail`` of them are printed, indented (the last 20 if it raises).
    Returns what ``fn`` returned."""
    import contextlib
    import io

    out, ok = io.StringIO(), False
    try:
        with contextlib.redirect_stdout(out):
            ret = fn(*args, **kw)
        ok = True
    finally:
        for line in out.getvalue().splitlines()[-(tail if ok else 20):]:
            print(f"  | {line}", flush=True)
    return ret


def examples_phase(dev, smi, drive_call, require_launched, launches) -> None:
    """Phase 3i: slice 10, the six examples (``icp_tpu_torch.examples``)
    on the card at their defaults, each driven through ``main(argv)`` on the
    main path. Raises on any failed check."""
    import tempfile
    from pathlib import Path
    from types import SimpleNamespace

    import torch.distributed as dist

    from icp_tpu_torch import ICPConfig, ICPParams, register
    from icp_tpu_torch.examples import (frame_grabber, multichip, odometry, odometry_service,
                                        registration, step_by_step)
    from icp_tpu_torch.icp.pipeline import ICPStepByStep
    from icp_tpu_torch.icp.quaternion import qangle_deg, qconj, qmul
    from icp_tpu_torch.parallel import initialize_multihost
    from icp_tpu_torch.parallel.dryrun import free_port, launch_world
    from icp_tpu_torch.sensors.synthetic import orbit_trajectory, synthetic_pair
    from icp_tpu_torch.slam import se3
    from icp_tpu_torch.slam.odometry import absolute_trajectory_error

    t_phase = time.perf_counter()
    k123 = ("rep_assign_counts", "bin_table", "bin_point_moments")
    fields = ("q", "t", "s", "qk", "tk", "sk", "k")
    with tempfile.TemporaryDirectory() as tmp:
        # Grab, then register: the reference's workflow.
        pose_b = [str(x) for x in (*T_GT_R, 0.008)]
        _quiet(frame_grabber.main, ["-s", "1", "--out-dir", tmp], tail=1)
        _quiet(frame_grabber.main, ["-s", "2", "--pose", *pose_b, "--out-dir", tmp], tail=1)
        for name, argv, kernels in [
                ("grab-then-register", ["kg_pc8d", "--data-dir", tmp], k123),
                ("registration --synthetic --robust huber",
                 ["--synthetic", "--robust", "huber"], ("bin_point_moments",))]:
            st, wall, ran = drive_call(lambda: _quiet(
                registration.main, [*argv, "--out-dir", f"{tmp}/reg"], tail=3))
            k = int(st.k)
            t_err, a_err = _errors(st, Q_GT_R, T_GT_R)
            print(f"example {name}: k={k} t_err={t_err:.4f} mm a_err={a_err:.5f} deg "
                  f"(hold 10 mm, 0.3 deg) wall={wall:.3f} s launches={ran}", flush=True)
            if not (1 <= k < 40 and t_err < 10.0 and a_err < 0.3):
                raise AssertionError(f"example {name}: off the grabber's pose")
            require_launched(ran, kernels, k, f"example {name}")

        # step_by_step --batch 8 against ICPStepByStep driven directly.
        app, wall, ran = drive_call(lambda: _quiet(
            step_by_step.main, ["--synthetic", "--batch", "8", "--out-dir", f"{tmp}/sbs"]))
        fixed, moving = step_by_step.load_pair(SimpleNamespace(
            synthetic=True, data_dir=tmp, name="kg_pc8d"), dev)
        direct = ICPStepByStep(fixed, moving, ICPParams(alpha=2e2), ICPConfig(estimate_scale=False))
        direct.build_rbc()
        for _ in range(8):
            direct.step(verbose=False)
        equal = all(torch.equal(getattr(app.state, f), getattr(direct.state, f)) for f in fields)
        t_err, a_err = _errors(app.state, Q_GT_R, T_GT_R)
        print(f"example step_by_step --batch 8: k={int(app.state.k)} t_err={t_err:.4f} mm "
              f"a_err={a_err:.5f} deg after 8 steps; torch.equal to ICPStepByStep driven "
              f"directly: {equal}; wall={wall:.3f} s launches={ran}", flush=True)
        if not equal:
            raise AssertionError("step_by_step --batch 8 differs from ICPStepByStep")
        require_launched(ran, k123, 8, "example step_by_step")

        for argv, kernels in [([], k123), (["--plane"], ("bin_gn_moments",))]:
            eng, wall, ran = drive_call(lambda: _quiet(
                odometry.main, ["--frames", "10", *argv, "--out-dir", f"{tmp}/odo"], tail=5))
            gt = [se3.Pose(p.q, p.t) for p in
                  orbit_trajectory(10, radius_mm=60.0, yaw_rad=0.05, device=dev)]
            ate = absolute_trajectory_error(eng.trajectory, gt)
            print(f"example odometry --frames 10 {' '.join(argv)}: ATE {ate:.3f} mm, "
                  f"{len(eng.map.keyframes)} keyframes, {len(eng.map.loop_closures)} closures; "
                  f"wall={wall:.3f} s launches={ran}", flush=True)
            if not (len(eng.trajectory) == 10 and np.isfinite(ate)):
                raise AssertionError(f"example odometry {argv}: no finite ATE")
            require_launched(ran, kernels, 1, f"example odometry {argv}")

        # The service: an injected crash, its resume, an uninterrupted run.
        run = ["--frames", "12", "--checkpoint-every", "4"]
        rc = _quiet(odometry_service.main, [*run, "--fail-at", "6", "--state-dir", f"{tmp}/a"],
                    tail=1)
        if rc == 0:
            raise AssertionError("odometry_service --fail-at 6 exited 0")
        rc2, wall, ran = drive_call(lambda: _quiet(
            odometry_service.main, [*run, "--state-dir", f"{tmp}/a"], tail=2))
        rc3 = _quiet(odometry_service.main, [*run, "--state-dir", f"{tmp}/b"], tail=2)
        with np.load(f"{tmp}/a/snap_000012.npz") as a, np.load(f"{tmp}/b/snap_000012.npz") as b:
            same = a.files == b.files and all(np.array_equal(a[f], b[f]) for f in a.files)
        print(f"example odometry_service: crash exit {rc}, resume exit {rc2}, uninterrupted "
              f"exit {rc3}; resumed snapshot equal to the uninterrupted one: {same}; resume "
              f"wall={wall:.3f} s launches={ran}", flush=True)
        if not (rc2 == 0 and rc3 == 0 and same):
            raise AssertionError("odometry_service: the resumed run differs")
        require_launched(ran, k123, 1, "example odometry_service")

        # multichip: a world of 1 on NCCL here, then two ranks on gloo.
        f_np, m_np = synthetic_pair(M)
        ref = register(torch.from_numpy(f_np).to(dev), torch.from_numpy(m_np).to(dev),
                       ICPParams(alpha=ALPHA), ICPConfig(estimate_scale=False))

        def check(st, wall, ran, where):
            k = int(st.k)
            t_err, a_err = _errors(st)
            dt = float(np.linalg.norm(st.t.double().cpu().numpy() - ref.t.double().cpu().numpy()))
            da = float(qangle_deg(qmul(st.q.cpu(), qconj(ref.q.cpu()))))
            print(f"example multichip {where}: k={k} t_err={t_err:.6f} mm a_err={a_err:.7f} deg "
                  f"(gate 0.05 mm, 0.005 deg); vs register |dt|={dt:.6f} mm dangle={da:.7f} "
                  f"deg (bars 0.1 mm, 5e-3 deg); wall={wall:.3f} s launches={ran}", flush=True)
            if not (1 <= k < 40 and t_err < 0.05 and a_err < 0.005 and dt < 0.1 and da < 5e-3):
                raise AssertionError(f"example multichip {where}: off")
            require_launched(ran, ("bin_table",), 1, f"example multichip {where}")
            require_launched(ran, ("bin_point_moments",), k, f"example multichip {where}")

        initialize_multihost(f"localhost:{free_port()}", 1, 0, backend="nccl", timeout_s=60)
        try:
            st, wall, ran = drive_call(lambda: _quiet(multichip.main, [], tail=3))
        finally:
            dist.destroy_process_group()
        check(st, wall, ran, "world of 1, NCCL")
        t0 = time.perf_counter()
        results = launch_world({"mesh": (2, 1), "device": "cuda", "tasks": [dict(
            kind="call", name="multichip", fn=multichip.rank_task, argv=["--dp", "2"])]},
            2, f"{tmp}/world", backend="gloo", timeout=180.0, init_timeout=60.0)
        outs = [r["tasks"]["multichip"] for r in results]
        if not all(torch.equal(outs[1]["out"][f], outs[0]["out"][f]) for f in fields):
            raise AssertionError("example multichip --dp 2: rank 1 differs from rank 0")
        for name in outs[0]["launches"]:  # the sharded path's wrappers
            launches[name] += sum(o["launches"][name] for o in outs)
        report = [line for line in Path(f"{tmp}/world/rank0.log").read_text().splitlines()
                  if line.startswith(("mesh:", "registered in"))]
        for line in report:
            print(f"  | {line}", flush=True)
        st = SimpleNamespace(**outs[0]["out"])
        check(st, max(o["wall"] for o in outs), outs[0]["launches"],
              f"--dp 2, gloo, two ranks sharing one card ({time.perf_counter() - t0:.1f} s "
              "with the ranks' start-up); every rank bitwise rank 0's")
    print(f"phase 3i examples: {time.perf_counter() - t_phase:.1f} s on {smi}", flush=True)


def main() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    from icp_tpu_torch import (Correspondence, ICPConfig, ICPParams, Objective,
                               RobustKernel, Weighting, icp_step, register, register_batch)
    from icp_tpu_torch.icp.quaternion import qrotate
    from icp_tpu_torch.icp.run import build_index
    from icp_tpu_torch.icp.state import identity_state
    # The module, not the wrapper the package exports under its name.
    bs = importlib.import_module("icp_tpu_torch.kernels.bin_search")
    bn = importlib.import_module("icp_tpu_torch.kernels.brute_nn")
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
    from icp_tpu_torch.runtime import support_matrix, support_sweep
    from icp_tpu_torch.sensors.synthetic import synthetic_pair as _synthetic_pair
    from icp_tpu_torch.sensors.synthetic import wavy_surface_pair
    from icp_tpu_torch.sensors import brute_sets, knn_sets, search_sets

    dev = torch.device("cuda", 0)
    marks = [("1", time.perf_counter())]

    def phase(name):
        """Print the seconds of the phase that ends here; ``name`` starts."""
        now = time.perf_counter()
        print(f"phase {marks[-1][0]}: {now - marks[-1][1]:.1f} s", flush=True)
        marks.append((name, now))

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
    phase("2")
    index = build_index(fixed, params.to(dev), cfg)
    st0 = identity_state(torch.float32, dev)
    alpha = torch.tensor(ALPHA, dtype=torch.float32, device=dev)
    G, b_row = fs.prep_similarity(st0.q, st0.t, st0.s)
    G = G.contiguous()
    C, srow = fs.prep_rep_assign(index.reps, alpha, G, b_row)
    C = C.contiguous()

    # K1, K1' and K3 on these tensors are rows of the support matrix (phase 5).
    rid_k, counts_k = fs.rep_assign_counts(moving, C, srow)

    sidx, counts, offsets, valid = grouping.bin_sort_layout(
        rid_k, N_R, cfg.query_capacity, counts=counts_k)
    sorted_rows = torch.index_select(moving, 0, sidx).contiguous()
    cap_q = {"capacity": cfg.query_capacity}
    k2_err = _check_k2("flagship, sorted rows", (sorted_rows, offsets), cap_q)
    k2_gather = (((moving,), offsets), dict(cap_q, order=sidx))
    # Every table the flagship index build (db, ids) and step (moving) make.
    k2_err = max(k2_err, _check_k2_tables(grouping, "flagship build / step", 2, lambda: (
        build_index(fixed, params.to(dev), cfg),
        icp_step(st0, moving, index, params.to(dev), cfg))))
    table_k = tb.bin_table(*k2_gather[0], **k2_gather[1])

    qvalid = valid.to(torch.float32)
    k3_args = (table_k, qvalid, index.reps, index.bins_centered,
               index.sq_b_masked, G, b_row, alpha)

    # ---- 2b. Slice-2 kernels against their twins, rendered pair ------------
    phase("2b")
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
    # K2 on the PLANE index build's table (db, ids, normals: d 12) and the
    # step's (moving, normals: d 11).
    k2_err = max(k2_err, _check_k2_tables(grouping, "PLANE build / step", 2, lambda: (
        build_index(fa_d, params.to(dev), cfg_p),
        grouping.group_rows_by_bin(rid_p, N_R, cfg_p.query_capacity, (lb_d, mnr),
                                   counts=counts_p))))
    qv = gl.valid.to(torch.float32)
    search = (index_p.reps, index_p.bins_centered, index_p.sq_b_masked, Gp, bp, alpha)
    k4_args = (mg11, qv) + search
    d2_t = fs.bin_min_dists_ref(*k4_args)
    fin = torch.isfinite(d2_t)
    # K4 bitwise against its twin (the +inf set and every finite d2): the
    # first iteration's table above (lanes 0:8 of the 11-wide rows), what
    # robust-adaptive steps hand it on the rendered pair (POINT; symmetric
    # PLANE, whose table is 11 wide), what robust-adaptive POINT steps of the
    # flagship pair hand it at n_r 32, 16 and 8 (cq up to 3072, cb up to
    # 4096: several query and bin tiles in bounded shared memory), and the
    # all-equal bins of sensors/search_sets.py (every partial minimum ties).
    prm_d = params.to(dev)

    def k4_step_args(fixed_t, moving_t, config):
        return _capture(search_mod, "bin_min_dists", lambda: icp_step(
            st0, moving_t, build_index(fixed_t, prm_d, config), prm_d, config))[0]

    k4_cases = {
        "rendered, first iteration (11-wide rows)": k4_args,
        "rendered, robust-adaptive POINT step": k4_step_args(fa_d, lb_d, ICPConfig(
            robust=RobustKernel.HUBER, robust_adaptive=True, estimate_scale=False)),
        "rendered, robust-adaptive plane_sym step (11-wide rows)": k4_step_args(
            fa_d, dirty_d, ICPConfig(objective=Objective.PLANE, plane_symmetric=True,
                                     weighting=Weighting.REGULAR,
                                     robust=RobustKernel.TRIMMED, robust_adaptive=True,
                                     estimate_scale=False)),
    }
    for n_r in (32, 16, 8):
        k4_cases[f"n_r={n_r}, robust-adaptive POINT step"] = k4_step_args(
            fixed, moving, ICPConfig(n_r=n_r, robust=RobustKernel.HUBER, robust_adaptive=True))
    # Held in phase 5 (the support matrix's nr16 and nr8 rows); kept here for
    # 4d's times.
    in_matrix = {"n_r=16, robust-adaptive POINT step", "n_r=8, robust-adaptive POINT step"}
    for n_r, cq, cb in ((256, 96, 128), (8, 3072, 4096)):
        k4_cases[f"all-equal bins n_r={n_r}"] = tuple(
            torch.from_numpy(x).to(dev) for x in search_sets.min_dists_all_equal(n_r, cq, cb)
        ) + (ALPHA,)
    k4_err = 0.0
    for name, a in k4_cases.items():
        if name in in_matrix:
            continue
        got, want = fs.bin_min_dists(*a), fs.bin_min_dists_ref(*a)
        torch.cuda.synchronize()
        same_inf = torch.equal(torch.isfinite(got), torch.isfinite(want))
        ok = _bitwise(got, want)
        k4_err = max(k4_err, _finite_err(got, want))
        print(f"K4 bin_min_dists {name}: mg {tuple(a[0].shape)} (row stride "
              f"{a[0].stride(1)}), cb {a[3].shape[1]}; {int(torch.isfinite(want).sum())} "
              f"finite of {want.numel()} slots; +inf set equal: {same_inf}; bitwise: {ok}",
              flush=True)
        if not (same_inf and ok):
            raise AssertionError(f"K4 {name} differs from its twin")
    k4_n_r8 = k4_cases["n_r=8, robust-adaptive POINT step"]
    if k4_n_r8[3].shape[1] != 4096:
        raise AssertionError(f"K4 at n_r 8: cb {k4_n_r8[3].shape[1]}, expected 4096")

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
    phase("2c")
    # (K1′ is held against its twin and K1 with K1, in _check_rep_assign.)

    cfg_u = ICPConfig(fused_point=False)
    cfg_pu = ICPConfig(objective=Objective.PLANE, estimate_scale=False, fused_gn=False)
    k5_cases = {  # name -> the arguments the unfused step hands K5
        "V=8 flagship": _capture(search_mod, "bin_search", lambda: icp_step(
            st0, moving, index, prm_d, cfg_u))[0],
        "V=12 rendered": _capture(search_mod, "bin_search", lambda: icp_step(
            st0, lb_d, index_p, prm_d, cfg_pu))[0],
    }
    for n_r in (16, 8):  # few large bins: several query tiles and bin tiles
        cfg_k = ICPConfig(n_r=n_r, fused_point=False)
        k5_cases[f"V=8 n_r={n_r} cb={cfg_k.bin_capacity}"] = _capture(
            search_mod, "bin_search", lambda: icp_step(
                st0, moving, build_index(fixed, prm_d, cfg_k), prm_d, cfg_k))[0]
    # These four are rows of the support matrix (phase 5: flagship V 8 and
    # 12, nr16, nr8); kept here for 4d's times.
    k5_err = 0.0
    # K5 on bins whose live slots all hold one point (sensors/search_sets.py):
    # the warps' partial minima tie, in one staged tile (cb 128) and over
    # several (cb 2048, 4096); the first live slot must win.
    for n_r, cq, cb, v in ((256, 96, 128, 8), (256, 96, 128, 12), (16, 1536, 2048, 8),
                           (8, 3072, 4096, 12)):
        a = tuple(torch.from_numpy(x).to(dev) for x in search_sets.all_equal(n_r, cq, cb, v))
        best_k, matched_k = bs.bin_search(*a)
        best_t, matched_t = bs.bin_search_ref(*a)
        live = torch.isfinite(a[2])
        first = torch.where(live.any(dim=1), live.int().argmax(dim=1), 0)
        first_ok = torch.equal(matched_k, a[3][torch.arange(n_r, device=dev), first][:, None]
                               .expand(-1, cq, -1))
        ok = _bitwise(best_k, best_t) and _bitwise(matched_k, matched_t)
        k5_err = max(k5_err, _finite_err(best_k, best_t), _finite_err(matched_k, matched_t))
        print(f"K5 bin_search all-equal slots (n_r {n_r}, cq {cq}, cb {cb}, V {v}): scores "
              f"and payloads bitwise: {ok}; first live slot wins: {first_ok}", flush=True)
        if not (ok and first_ok):
            raise AssertionError(f"K5 all-equal n_r={n_r} cb={cb} differs from its twin")

    # K3 with few, large bins, where it walks several query and bin tiles:
    # n_r 32 gives cq 768 / cb 1024 (n_r 16, cq 1536 / cb 2048, is the
    # support matrix's nr16 row).
    k3c_err = 0.0
    for n_r in (32,):
        cfg_k = ICPConfig(n_r=n_r)
        a, kw = _capture(search_mod, "bin_point_moments", lambda: icp_step(
            st0, moving, build_index(fixed, prm_d, cfg_k), prm_d, cfg_k))
        k3c_err = max(k3c_err, _check_moments(
            f"K3 bin_point_moments n_r={n_r} (cq {cfg_k.query_capacity}, "
            f"cb {cfg_k.bin_capacity})", fs.bin_point_moments, fs.bin_point_moments_ref,
            a, kw))

    # K7 likewise, on what GICP steps of the rendered pair hand it (every
    # mode reads those tables; plane ignores the moving normals).
    for n_r in (32,):
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
    phase("2d")
    m16, n_r16, cap16 = 262144, 2048, 256
    f16_np, m16_np = _synthetic_pair(m16, seed=0)
    f16, mv16 = torch.from_numpy(f16_np).to(dev), torch.from_numpy(m16_np).to(dev)
    reps16 = f16[sample_representative_indices(
        m16, n_r16, ICPConfig(m=m16, n_r=n_r16).rep_grid, device=dev).long()]
    C16, srow16 = fs.prep_rep_assign(reps16, alpha, G, b_row)
    rid16, counts16 = fs.rep_assign_counts(mv16, C16.contiguous(), srow16)
    sidx16, _, offsets16, _ = grouping.bin_sort_layout(rid16, n_r16, cap16, counts=counts16)
    nrm16 = normals_for(mv16, "auto")
    print(f"16x layout: {m16} rows, {n_r16} bins, cap {cap16}; bins over capacity "
          f"{int((counts16 > cap16).sum())}, empty {int((counts16 == 0).sum())}", flush=True)
    k2x_args = {}
    err16_k2 = 0.0
    for d, srcs in ((8, (mv16,)), (11, (mv16, nrm16))):
        sorted16 = tb.gathered_rows(srcs, sidx16).contiguous()
        k2x_args[d] = ((srcs, offsets16), {"capacity": cap16, "order": sidx16})
        err16_k2 = max(err16_k2, _check_k2(f"16x d {d}, sorted rows", (sorted16, offsets16),
                                           {"capacity": cap16}),
                       _check_k2(f"16x d {d}", *k2x_args[d]))
    del f16

    # ---- 2e. Slice 5: K9 and K8 at the LiDAR shape ---------------------------
    phase("2e")
    wf_np, wm_np, q_l, t_l = wavy_surface_pair(M_L)
    wf, wm = torch.from_numpy(wf_np).to(dev), torch.from_numpy(wm_np).to(dev)
    # K9's and K8's arguments as the estimator hands them, from one call.
    knn_args = _capture_all(normals_mod, ("rep_top2_counts", "bin_knn_moments"),
                            lambda: normals_mod.knn_normals_rbc(wf))
    k9_args = knn_args["rep_top2_counts"][0]
    if k9_args[1].shape[0] != N_R_L:
        raise AssertionError(f"the estimator chose {k9_args[1].shape[0]} reps, not {N_R_L}")
    # K9 bitwise at the LiDAR shape, at the GICP "knn_rbc" cell's 16384
    # points (n_r 128) and on the top-2 sets of sensors/knn_sets.py (exact
    # ties, repeated reps, zero points).
    wg = torch.from_numpy(wavy_surface_pair(M)[0]).to(dev)
    k9s_args = _capture(normals_mod, "rep_top2_counts",
                        lambda: normals_mod.knn_normals_rbc(wg))[0]
    k9_sets = {f"LiDAR {M_L} x {N_R_L}": k9_args, f"{M} points": k9s_args} | {
        name: tuple(torch.from_numpy(x).to(dev) for x in knn_sets.top2(name))
        for name in knn_sets.TOP2}
    k9_err = 0
    for name, a in k9_sets.items():
        top_k = km.rep_top2_counts(*a)
        top_t = km.rep_top2_counts_ref(*a)
        torch.cuda.synchronize()
        n_r = a[1].shape[0]
        for j in range(2):
            if not torch.equal(top_k[2][j], torch.bincount(top_k[j], minlength=n_r).to(torch.int32)):
                raise AssertionError(f"K9 {name} counts[{j}] != bincount of its own ids")
        n_diff = [int((top_k[j] != top_t[j]).sum()) for j in range(2)]
        k9_err = max(k9_err, int((top_k[2] - top_t[2]).abs().max()))
        print(f"K9 rep_top2_counts {name} ({a[0].shape[0]} points, {n_r} reps): counts equal "
              f"the bincounts of its ids; i1, i2 off the twin on {n_diff[0]}, {n_diff[1]} "
              f"points; counts bitwise: {torch.equal(top_k[2], top_t[2])}", flush=True)
        if not all(torch.equal(g, w) for g, w in zip(top_k, top_t)):
            raise AssertionError(f"K9 {name} differs from its twin")

    k8_args, k8_kw = knn_args["bin_knn_moments"]
    k8_err, _ = _check_k8(km, "LiDAR", k8_args, k8_kw)
    comps_k, _ = km.bin_knn_moments(*k8_args, **k8_kw)
    comps_t, _ = km.bin_knn_moments_ref(*k8_args, **k8_kw)
    qfin = torch.isfinite(k8_args[0]).all(dim=-1)
    n_k = torch.stack(normals_mod._smallest_eigvec3_components(*comps_k), dim=-1)
    n_t = torch.stack(normals_mod._smallest_eigvec3_components(*comps_t), dim=-1)
    cos_share = float(((n_k * n_t).sum(-1).abs()[qfin] > 0.9999).float().mean())
    print(f"K8 LiDAR: normals cos > 0.9999 on {cos_share:.6f} of {int(qfin.sum())} slots",
          flush=True)
    if cos_share < 0.999:
        raise AssertionError("K8's normals disagree with its twin's")
    # K2 on the estimator's two groupings there (d 4 and 3).
    k2_err = max(k2_err, _check_k2_tables(grouping, "LiDAR estimator", 2,
                                          lambda: normals_mod.knn_normals_rbc(wf)))
    # K8 at the GICP "knn_rbc" cell's shape (16384 points: n_r 128, same
    # bins), and on the adversarial sets of sensors/knn_sets.py.
    k8s_args, k8s_kw = _capture(normals_mod, "bin_knn_moments",
                                lambda: normals_mod.knn_normals_rbc(wg))
    k8_err = max(k8_err, _check_k8(km, "16384", k8s_args, k8s_kw)[0])
    for name in knn_sets.ADVERSARIAL:
        *arrays, k = knn_sets.adversarial(name)
        a = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in arrays)
        k8_err = max(k8_err, _check_k8(km, f"adversarial {name}", a, {"k": k})[0])

    # ---- 2f. K1, K7 and K3 at the 16x shape, as the steps hand them --------
    phase("2f")
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
    # K1, K1', K3 and K7 plane_sym / gicp at the 16x step shapes are rows
    # of the support matrix (phase 5), whose errors join err16 there.
    err16 = {"bin_table": err16_k2}  # K2 at 16x is bitwise (2d)
    a, kw = k7x_args
    err16["bin_gn_moments"] = _check_moments(
        f"bin_gn_moments 16x LiDAR PLANE step (mg {tuple(a[0].shape)}, cb "
        f"{a[4].shape[1]}, {kw})", fg.bin_gn_moments, fg.bin_gn_moments_ref, a, kw)

    # ---- 3. The slice: three flagship registrations ------------------------
    phase("3")
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

    # Seed 0 on the card against the CPU twins is the support matrix's
    # e2e-point row (phase 5).
    from icp_tpu_torch.icp.quaternion import qangle_deg, qconj, qmul

    # ---- 3b. Slice 2: the bench gates on the rendered pair -----------------
    phase("3b")
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

    # The PLANE gate on the card against the CPU twins is the support
    # matrix's e2e-plane row (phase 5).

    # ---- 3c. Slices 3-4: BRUTE and the unfused pipeline --------------------
    phase("3c")
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
    phase("3d")
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

    # ---- 3e. Slice 6: the batch, the pyramid and the app pipelines --------
    phase("3e")
    from icp_tpu_torch.icp import chunk_graph
    from icp_tpu_torch.icp.pipeline import ICPRegistration, ICPStepByStep
    from icp_tpu_torch.icp.pyramid import register_pyramid
    from icp_tpu_torch.ops.sampling import get_landmarks
    from icp_tpu_torch.sensors import synthetic

    def check_batch(what, fixed_b, moving_b, config, gts, gate, need):
        """register_batch of the pairs against register of each pair on the
        card: k, q, t and s torch.equal; each lane within ``gate`` of its
        ground truth; the batch's wall per pair beside the singles'."""
        batch, wall_b, ran = drive_call(
            lambda: register_batch(fixed_b, moving_b, params, config))
        n = fixed_b.shape[0]
        walls, ks = [], [int(k) for k in batch.k]
        for i in range(n):
            t0 = time.perf_counter()
            single = register(fixed_b[i], moving_b[i], params, config)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            same = all(torch.equal(getattr(batch, f)[i], getattr(single, f))
                       for f in ("k", "q", "t", "s"))
            t_err, a_err = _errors(single, *gts[i])
            print(f"register_batch {what} lane {i}: k={ks[i]} t_err={t_err:.6f} mm "
                  f"a_err={a_err:.7f} deg; k, q, t, s equal to register's: {same}", flush=True)
            if not same:
                raise AssertionError(f"register_batch {what} lane {i} differs from register")
            if not (t_err < gate[0] and a_err < gate[1]):
                raise AssertionError(f"register_batch {what} lane {i} off the ground truth")
        print(f"register_batch {what} (B {n}) on {torch.cuda.get_device_name(0)}: wall "
              f"{wall_b * 1e3 / n} ms per pair, register alone {np.mean(walls) * 1e3} ms per "
              f"pair; launches={ran}", flush=True)
        require_launched(ran, need, max(ks), f"register_batch {what}")

    pairs = [_synthetic_pair(M, seed=seed) for seed in range(4)]
    check_batch("POINT, seeds 0-3", torch.from_numpy(np.stack([p[0] for p in pairs])).to(dev),
                torch.from_numpy(np.stack([p[1] for p in pairs])).to(dev), cfg,
                [(Q_GT, T_GT)] * 4, (0.05, 0.005),
                ("rep_assign_counts", "bin_table", "bin_point_moments"))
    check_batch("BRUTE POINT, seeds 0-1",
                torch.from_numpy(np.stack([p[0] for p in pairs[:2]])).to(dev),
                torch.from_numpy(np.stack([p[1] for p in pairs[:2]])).to(dev), cfg_b,
                [(Q_GT, T_GT)] * 2, (0.05, 0.005), ("brute_nn",))
    scene = synthetic.default_scene(device="cpu")
    lc = get_landmarks(synthetic.render_cloud(scene, synthetic.CameraPose(
        torch.tensor(Q_GT_C, dtype=torch.float32), torch.tensor(T_GT_C, dtype=torch.float32))
    ).reshape(-1, 8)).contiguous()
    check_batch("PLANE, two rendered pairs", torch.stack([fa_d, fa_d]),
                torch.stack([lb_d, lc.to(dev)]), cfg_p, [(Q_GT_R, T_GT_R), (Q_GT_C, T_GT_C)],
                (T_GATE, A_GATE), ("rep_assign_counts", "bin_table", "bin_gn_moments"))

    # The pyramid on the reference test's large-motion pair (tests/test_pyramid.py):
    # K1 and K3 must launch at each level's n_r (16, 64, 256).
    q_big = np.array([0.0, np.sin(0.01), 0.0, np.cos(0.01)])
    t_big = np.array([60.0, -30.0, 40.0])
    lb_big = get_landmarks(synthetic.render_cloud(scene, synthetic.CameraPose(
        torch.tensor(q_big, dtype=torch.float32), torch.tensor(t_big, dtype=torch.float32))
    ).reshape(-1, 8)).contiguous().to(dev)
    q_rel, t_rel = _relative(np.array([0.0, 0.0, 0.0, 1.0]), np.zeros(3), q_big, t_big)
    cfg_pyr = ICPConfig(estimate_scale=False, max_iterations=40)
    single, wall_s, _ = drive(fa_d, lb_big, params, cfg_pyr)
    shapes = {"rep_assign_counts": set(), "bin_point_moments": set()}
    real = {name: getattr(search_mod, name) for name in shapes}

    def shape_spy(name):
        def wrapped(*a, **kw):  # K1's C is (8, n_r), K3's mg (n_r, cq, 8)
            shapes[name].add(a[1].shape[1] if name == "rep_assign_counts" else a[0].shape[0])
            return real[name](*a, **kw)
        return wrapped

    # A replay runs the captured kernels and calls no wrapper: capture anew.
    chunk_graph.clear()
    for name in shapes:
        setattr(search_mod, name, shape_spy(name))
    try:
        pyr, wall_p, ran = drive_call(lambda: register_pyramid(fa_d, lb_big, params, cfg_pyr,
                                                               strides=(4, 2, 1)))
    finally:
        for name, fn in real.items():
            setattr(search_mod, name, fn)
    t_s, a_s = _errors(single, q_rel, t_rel)
    t_p, a_p = _errors(pyr, q_rel, t_rel)
    print(f"register_pyramid (4, 2, 1), large motion (0.02 rad, |t| "
          f"{np.linalg.norm(t_big):.1f} mm) on {torch.cuda.get_device_name(0)}: k={int(pyr.k)} "
          f"t_err={t_p:.6f} mm a_err={a_p:.7f} deg (bounds 10 mm, 0.3 deg) wall={wall_p:.3f} s; "
          f"single level k={int(single.k)} t_err={t_s:.6f} mm a_err={a_s:.7f} deg "
          f"wall={wall_s:.3f} s; n_r launched: {sorted(shapes['rep_assign_counts'])} (K1), "
          f"{sorted(shapes['bin_point_moments'])} (K3); launches={ran}", flush=True)
    if not (t_p < 10.0 and a_p < 0.3 and t_p <= t_s + 1.0):
        raise AssertionError("register_pyramid misses the large-motion gate")
    for name, seen in shapes.items():
        if seen != {16, 64, 256}:
            raise AssertionError(f"register_pyramid: {name} ran at n_r {sorted(seen)}")

    # The app pipelines on the reference test's 640x480 pair (tests/test_pipeline.py).
    q_app = torch.tensor([0.0, np.sin(0.003), 0.0, np.cos(0.003)], dtype=torch.float32)
    cloud_a = synthetic.render_cloud(scene, synthetic.CameraPose.identity(device="cpu")).to(dev)
    cloud_b = synthetic.render_cloud(scene, synthetic.CameraPose(
        q_app, torch.tensor([8.0, -4.0, 6.0]))).to(dev)
    cfg_app = ICPConfig(estimate_scale=False)
    st, wall, ran = drive_call(lambda: ICPRegistration(ICPParams(alpha=ALPHA), cfg_app)
                               .register_clouds(cloud_a, cloud_b, verbose=True))
    t_norm, ang = float(torch.linalg.vector_norm(st.t)), float(qangle_deg(st.q.cpu()))
    print(f"ICPRegistration.register_clouds (640 x 480): k={int(st.k)} |t|={t_norm:.6f} mm "
          f"angle={ang:.7f} deg (bounds 1 <= k <= 40, 50 mm, 2 deg) wall={wall:.3f} s "
          f"launches={ran}", flush=True)
    if not (1 <= int(st.k) <= 40 and t_norm < 50.0 and ang < 2.0):
        raise AssertionError("ICPRegistration misses the reference test's bounds")
    require_launched(ran, ("rep_assign_counts", "bin_table", "bin_point_moments"),
                     int(st.k), "ICPRegistration")
    # Numpy clouds, as the reference's app takes them: they go to the card.
    app = ICPStepByStep(cloud_a.cpu().numpy(), cloud_b.cpu().numpy(), ICPParams(alpha=ALPHA),
                        cfg_app)
    if app.fixed_cloud.device != cloud_a.device or app.state.q.device != cloud_a.device:
        raise AssertionError(f"ICPStepByStep put numpy clouds on {app.fixed_cloud.device}")
    app.build_rbc()
    (st1, st2), _, ran = drive_call(lambda: (app.step(verbose=True), app.step(verbose=False)))
    tc = app.transformed_cloud()
    colour_same = torch.equal(tc[:, 4:], cloud_b.reshape(-1, 8)[:, 4:])
    app.reset()
    print(f"ICPStepByStep: k {int(st1.k)} then {int(st2.k)}; transformed cloud "
          f"{tuple(tc.shape)}, colour half untouched: {colour_same}; k after reset "
          f"{int(app.state.k)}; launches={ran}", flush=True)
    if not (int(st1.k) == 1 and int(st2.k) == 2 and tc.shape == (307200, 8) and colour_same
            and int(app.state.k) == 0):
        raise AssertionError("ICPStepByStep misses the reference test's checks")
    require_launched(ran, ("rep_assign_counts", "bin_table", "bin_point_moments"), 2,
                     "ICPStepByStep")

    # Robust-adaptive POINT at n_r 8: K4 at cb 4096.
    cfg_r8 = ICPConfig(n_r=8, robust=RobustKernel.HUBER, robust_adaptive=True)
    st, wall, ran = drive(fixed, moving, params, cfg_r8)
    t_err, a_err = _errors(st)
    print(f"POINT + HUBER + adaptive at n_r 8 (cq {cfg_r8.query_capacity}, cb "
          f"{cfg_r8.bin_capacity}), seed 0: k={int(st.k)} t_err={t_err:.6f} mm "
          f"a_err={a_err:.7f} deg wall={wall:.3f} s launches={ran}", flush=True)
    if not (t_err < T_GATE and a_err < A_GATE and cfg_r8.bin_capacity == 4096):
        raise AssertionError("POINT + HUBER at n_r 8: registration off the ground truth")
    require_launched(ran, ("bin_point_moments", "bin_min_dists"), int(st.k),
                     "POINT + HUBER at n_r 8")

    # ---- 3f. Slice 7: the odometry front end ----------------------------------
    phase("3f")
    arcs, arc_frames, circle, circle_frames = render_sequences()
    odometry_phase(dev, smi, drive_call, require_launched, arcs, arc_frames)
    del arc_frames

    # ---- 3g. Slice 8: the SLAM back end -----------------------------------------
    phase("3g")
    slam_graph, slam_gt = slam_phase(dev, smi, drive_call, require_launched, circle,
                                     circle_frames)
    del circle_frames

    # ---- 3h. Slice 9: the sharded paths -------------------------------------------
    phase("3h")
    sharded_phase(dev, smi, drive_call, require_launched, launches, slam_graph, slam_gt)

    # ---- 3i. Slice 10: the examples ----------------------------------------------
    phase("3i")
    examples_phase(dev, smi, drive_call, require_launched, launches)

    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} never launched on the main path")

    phase("3 card vs CPU, fused vs unfused")
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
    phase("4")
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
    phase("4c")
    for name, (f_t, m_t, config) in {
            "BRUTE POINT (synthetic pair)": (fixed, moving, cfg_b),
            "unfused PLANE (rendered pair)": (fa_d, lb_d, cfg_pu)}.items():
        per_iter, t40, t8 = marginal_ms(f_t, m_t, config, 3)
        print(f"{name} marginal ms/iteration at {M}x{N_R}: {per_iter} (T40 "
              f"{t40 * 1e3} ms, T8 {t8 * 1e3} ms, min of 3 alternating rounds)",
              flush=True)

    # ---- 4d. Slice 5: the LiDAR cells and the scaled POINT cells -------------
    phase("4d")
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
        "bin_table": (tb.bin_table, _k2_twin, *k2_gather),
        "bin_point_moments": (fs.bin_point_moments, fs.bin_point_moments_ref, k3_args,
                              {"weighted": True}),
        "bin_min_dists": (fs.bin_min_dists, fs.bin_min_dists_ref, k4_args, {}),
        "bin_min_dists@n_r=8": (fs.bin_min_dists, fs.bin_min_dists_ref, k4_n_r8, {}),
        "brute_nn": (bn.brute_nn, bn.brute_nn_ref, k6_args, {}),
        "rep_top2_counts": (km.rep_top2_counts, km.rep_top2_counts_ref, k9_args, {}),
        "rep_top2_counts@16384": (km.rep_top2_counts, km.rep_top2_counts_ref, k9s_args, {}),
        "bin_knn_moments": (km.bin_knn_moments, km.bin_knn_moments_ref, k8_args, k8_kw),
        "bin_knn_moments@16384": (km.bin_knn_moments, km.bin_knn_moments_ref, k8s_args,
                                  k8s_kw),
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
        if "n_r=8" in case:
            continue
        key = "bin_search@" if "n_r=16" in case else "bin_search "
        cases[key + case] = (bs.bin_search, bs.bin_search_ref, a, {})
    for d, (a, kw) in k2x_args.items():
        cases[f"bin_table@16x d={d}"] = (tb.bin_table, _k2_twin, a, kw)
    # Twins that sweep a large set (K6's 16384 x 16384, K1 and K9 over
    # 262144 x 2048 scores, K8 over 2048 bins): 5 calls per timing, not 20.
    twin_reps = {"brute_nn": 5, "rep_top2_counts": 5, "rep_top2_counts@16384": 5,
                 "bin_knn_moments": 5,
                 "bin_knn_moments@16384": 5, "bin_min_dists@n_r=8": 5,
                 "rep_assign_counts@16x": 5, "bin_point_moments@16x": 5,
                 **{f"bin_gn_moments@16x {mode}": 5 for mode in k7x_modes}}
    times, pr4 = {}, {}
    for key, (kernel, twin, a, kw) in cases.items():
        out = kernel(*a, **kw)
        bound = _bound(*_work(key.split()[0].split("@")[0], a, kw, out))
        if key.startswith("bin_knn_moments"):
            pr4[key] = _bound(_k8_pr4_ms(a, out), _work("bin_knn_moments", a, kw, out)[1])
            print(f"{key}: bound of the first design's count {pr4[key][0]} ms "
                  f"({pr4[key][1]})", flush=True)
        if key.startswith("bin_search"):
            pr4[key] = _bound(_k5_padded_ms(a), sum(
                t.numel() * t.element_size() for t in _tensors((a, kw, out))))
            print(f"{key}: bound over every padded slot {pr4[key][0]} ms ({pr4[key][1]})",
                  flush=True)
        k_ms, t_ms = float("inf"), float("inf")
        for _ in range(3):  # alternate kernel and twin; keep each minimum
            k_ms = min(k_ms, _cuda_ms(lambda f=kernel, a=a, kw=kw: f(*a, **kw)))
            t_ms = min(t_ms, _cuda_ms(lambda f=twin, a=a, kw=kw: f(*a, **kw),
                                      twin_reps.get(key, 20)))
        times[key] = (k_ms, t_ms, *bound)
        print(f"{key}: kernel {k_ms} ms, plain twin {t_ms} ms, bound {bound[0]} ms "
              f"({bound[1]})", flush=True)

    # ---- 5. The support matrix ----------------------------------------------
    phase("5")
    t5 = time.perf_counter()
    matrix = support_sweep.sweep(dev, log=lambda line: print(line, flush=True))
    with open(support_matrix.TABLE_PATH) as f:
        table = json.load(f)
    rows = support_matrix.rows_by_key()
    keys = set(rows)
    failed = sorted(key for key, r in matrix.items() if not r["ok"])
    print(f"phase 5 support matrix: {len(matrix)} rows on the card, {len(failed)} failed; "
          f"the checked-in table's digest {table['digest']}, the sources' "
          f"{native.source_digest()}", flush=True)
    if failed:
        raise AssertionError(f"support matrix rows failed on the card: {failed}")
    if (table["digest"] != native.source_digest()
            or table["wrappers_digest"] != support_matrix.wrappers_digest()):
        raise AssertionError("the support table was written by other kernel sources or "
                             "wrappers: run python3 -m icp_tpu_torch.runtime.support_sweep "
                             "--write")
    if not set(matrix) == set(table["rows"]) == keys:
        raise AssertionError("the support table's rows are not the matrix's: "
                             f"{sorted(set(matrix) ^ set(table['rows']))}")
    print(f"phase 5 rows: {len(matrix)}", flush=True)
    print(f"phase 5 seconds: {time.perf_counter() - t5:.1f}", flush=True)
    # Each kernel's largest error over its rows; the 16x class's apart.
    matrix_err, matrix_rows = {}, {}
    for key, r in matrix.items():
        if r["kernel"] is None:
            continue
        matrix_rows[r["kernel"]] = matrix_rows.get(r["kernel"], 0) + 1
        matrix_err[r["kernel"]] = max(matrix_err.get(r["kernel"], 0.0), r["err"])
        if rows[key].shape_class == "16x":
            err16[r["kernel"]] = max(err16.get(r["kernel"], 0.0), r["err"])
    k1_err, k1p_err = matrix_err["rep_assign_counts"], matrix_err["rep_assign"]
    k3_err = matrix_err["bin_point_moments"]
    k2_err, k4_err = max(k2_err, matrix_err["bin_table"]), max(k4_err, matrix_err["bin_min_dists"])
    k5_err, k6_err = max(k5_err, matrix_err["bin_search"]), max(k6_err, matrix_err["brute_nn"])
    k7_err = max(k7_err, matrix_err["bin_gn_moments"])
    k8_err = max(k8_err, matrix_err["bin_knn_moments"])
    k9_err = max(k9_err, matrix_err["rep_top2_counts"])

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
    slowest = {}
    for name in meta:
        modes = [key for key in times if key.split()[0] == name]
        slowest[name] = max(modes, key=lambda key: times[key][0])
        slow = times[slowest[name]]
        times[name] = (slow[0], max(times[key][1] for key in modes), slow[2], slow[3])
    # max_abs_err is the largest over every shape checked; the kernels the
    # 16x paths run also give their error there apart (max_abs_err_16x), and
    # K1, K3 and K7 their time and bound at the 16x step shape.
    at16 = {"rep_assign_counts": "rep_assign_counts@16x",
            "bin_table": "bin_table@16x d=8",
            "bin_point_moments": "bin_point_moments@16x",
            "bin_gn_moments": "bin_gn_moments@16x plane"}
    r6 = k6_rescored.double()
    k8x, k9x, k4x = "bin_knn_moments@16384", "rep_top2_counts@16384", "bin_min_dists@n_r=8"
    k5x = next(key for key in times if key.startswith("bin_search@"))
    extra = {"brute_nn": {"rescored_mean": float(r6.mean()), "rescored_max": int(r6.max()),
                          "margin_headroom": k6_headroom, "ms_no_rescore": k6_none},
             "bin_knn_moments": {"bound_ms_pr4": pr4["bin_knn_moments"][0],
                                 "ms_16384": times[k8x][0], "plain_ms_16384": times[k8x][1],
                                 "bound_ms_16384": times[k8x][2],
                                 "bound_ms_pr4_16384": pr4[k8x][0]},
             "rep_top2_counts": {"ms_16384": times[k9x][0], "plain_ms_16384": times[k9x][1],
                                 "bound_ms_16384": times[k9x][2]},
             "bin_min_dists": {"ms_n_r8": times[k4x][0], "plain_ms_n_r8": times[k4x][1],
                               "bound_ms_n_r8": times[k4x][2]},
             "bin_search": {"bound_ms_padded": pr4[slowest["bin_search"]][0],
                            "ms_n_r16": times[k5x][0], "plain_ms_n_r16": times[k5x][1],
                            "bound_ms_n_r16": times[k5x][2],
                            "bound_ms_padded_n_r16": pr4[k5x][0]}}
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], "max_abs_err": max(err, err16.get(name, 0)),
                "ms": times[name][0], "plain_ms": times[name][1],
                "bound_ms": times[name][2], "bound_by": times[name][3],
                "library_ms": None, "matrix_rows": matrix_rows[name]}
               | ({"max_abs_err_16x": err16[name]} if name in err16 else {})
               | ({"ms_16x": times[at16[name]][0], "bound_ms_16x": times[at16[name]][2]}
                  if name in at16 else {})
               | extra.get(name, {})
               for name, (src, rep, err) in meta.items()]
    banned = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "icp_tpu", "__graft_entry__",
                                           "PIL", "matplotlib"))
    if banned:
        raise AssertionError(f"imported {banned}")
    phase("end")
    print(f"chip_smoke wall time: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
