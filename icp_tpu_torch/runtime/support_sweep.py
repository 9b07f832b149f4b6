"""Run the support matrix on the card: every row of
``runtime.support_matrix.kernel_rows`` launched on the arguments the main
path hands its wrapper, and held against its plain twin.

    python -m icp_tpu_torch.runtime.support_sweep [--write] [--out PATH]

Each shape class drives the real path once per kind of step and captures
what the wrappers receive: a POINT step (K1, K2 on the queries, K3), a
robust-adaptive POINT step (K4), an unfused POINT step (K5, 8-wide
payload), an unfused PLANE step (K5, 12-wide), a GICP step (K2 on the
queries and their normals, K7) and a BRUTE step (K6), on ``synthetic_pair``
at the class's m (``wavy_surface_pair`` at 4x and 16x) and, for the GN
steps, the rendered gate pair (its pyramid level below 16384 landmarks;
the wavy pair with kNN normals at 4x and 16x). The live-slot counts decide
how many tiles a search walks, so random tensors would not do. The
sharded classes run one rank's step (every rank of the mesh, emulated in
this process; the (1, 1) rank on a real world of 1), the kNN classes
``knn_normals_rbc`` (K9, K2, K8). Variants
that differ only in a kernel's keyword arguments (K3's and K7's weights
and robust kinds, K7's modes) reuse one capture.

The bars are ``chip_smoke.py``'s: bitwise for K1, K1', K2, K4, K5, K6 and
K9; K3 and K7 within 1e-4 of each output's largest entry and a second
launch bitwise equal to the first; K8 n bitwise, the components within 1e-5
of each query's largest and repeating bitwise. The three end-to-end rows
register at the flagship on the card and on the CPU twins; a CPU
registration that launched a kernel fails its row.

``--write`` writes the table to ``support_matrix.TABLE_PATH`` (or
``--out``): per row ``ok``, the error and its bar, the kernel's device ms;
the sources' digest (``kernels.native.source_digest``) and the wrappers'
(``support_matrix.wrappers_digest``), the card's name and power limit, and
each kernel's registers, spills and static shared memory from the
``-Xptxas -v`` build log. It needs a CUDA device and exits non-zero
if any row fails.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from icp_tpu_torch.kernels import fused_gn as fg
from icp_tpu_torch.kernels import fused_step as fs
from icp_tpu_torch.kernels import knn_moments as km
from icp_tpu_torch.kernels import table_build as tb
from icp_tpu_torch.runtime import support_matrix as sm

# The modules, not the wrappers the kernels package exports under their names.
bs = importlib.import_module("icp_tpu_torch.kernels.bin_search")
bn = importlib.import_module("icp_tpu_torch.kernels.brute_nn")

ALPHA = 2e2  # the benchmark's blend (bench.py)
# Ground truth of synthetic_pair (+0.02 rad about z, t = (8, -5, 3) mm) and
# of the rendered gate pair (0.008 rad about y, t = (10, -6, 8) mm).
Q_GT = np.array([0.0, 0.0, np.sin(0.01), np.cos(0.01)])
T_GT = np.array([8.0, -5.0, 3.0])
Q_GT_R = np.array([0.0, np.sin(0.004), 0.0, np.cos(0.004)])
T_GT_R = np.array([10.0, -6.0, 8.0])
MOMENTS_BAR = 1e-4  # K3, K7: max|d| over max|P|
KNN_BAR = 1e-5      # K8: max|dC| over each query's largest component


# ---------------------------------------------------------------------------
# Capturing what the main path hands the wrappers
# ---------------------------------------------------------------------------


def record_calls(targets, call) -> dict:
    """{attr: [(args, kwargs), ...]} of every call that ``call()`` makes to
    ``module.attr`` for each (module, attr) of ``targets``; the originals are
    restored afterwards."""
    seen = {attr: [] for _, attr in targets}
    origs = [(mod, attr, getattr(mod, attr)) for mod, attr in targets]

    def spy(attr, orig):
        def wrapped(*args, **kwargs):
            seen[attr].append((args, kwargs))
            return orig(*args, **kwargs)
        return wrapped

    for mod, attr, orig in origs:
        setattr(mod, attr, spy(attr, orig))
    try:
        call()
    finally:
        for mod, attr, orig in origs:
            setattr(mod, attr, orig)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return seen


def capture_all(module, names: tuple[str, ...], call) -> dict:
    """{name: (args, kwargs)} of the first call that ``call()`` makes to
    each ``module.name``: the tensors the main path hands the kernels'
    wrappers."""
    seen = record_calls([(module, name) for name in names], call)
    return {name: calls[0] for name, calls in seen.items() if calls}


def capture(module, name: str, call):
    """The (args, kwargs) of the first call that ``call()`` makes to
    ``module.name``."""
    return capture_all(module, (name,), call)[name]


def bitwise(got, want) -> bool:
    """Equal bit for bit (float32 compared as int32, so NaN and -0.0 too)."""
    return torch.equal(got.contiguous().view(torch.int32),
                       want.contiguous().view(torch.int32))


def finite_err(got, want) -> float:
    """max|got - want| over the entries where both are finite."""
    fin = torch.isfinite(got) & torch.isfinite(want)
    return float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0


def rendered_pair():
    """bench.py's rendered gate pair as (fixed, moving, moving with 12 %
    gross outliers) landmark tensors on the CPU."""
    from icp_tpu_torch.ops.sampling import get_landmarks
    from icp_tpu_torch.sensors import synthetic

    scene = synthetic.default_scene(device="cpu")
    pose_b = synthetic.CameraPose(torch.tensor(Q_GT_R, dtype=torch.float32),
                                  torch.tensor(T_GT_R, dtype=torch.float32))
    la = get_landmarks(synthetic.render_cloud(
        scene, synthetic.CameraPose.identity(device="cpu")).reshape(-1, 8)).contiguous()
    lb = get_landmarks(synthetic.render_cloud(scene, pose_b).reshape(-1, 8)).contiguous()
    rng = np.random.default_rng(5)
    dirty = lb.numpy().copy()
    idx = rng.choice(dirty.shape[0], dirty.shape[0] // 8, replace=False)
    dirty[idx, :3] += (rng.uniform(250, 500, (len(idx), 3))
                       * rng.choice([-1.0, 1.0], (len(idx), 3))).astype(np.float32)
    return la, lb, torch.from_numpy(dirty)


class RankStandIn:
    """One rank of an (n_dp, n_mp) mesh, emulated in this process for the
    kernel checks: its coordinates, shape and device; its collectives return
    their input (the checks read what the kernels take and give, not the
    step's result)."""

    def __init__(self, n_dp: int, n_mp: int, dp: int, mp: int, device):
        self.shape = {"dp": n_dp, "mp": n_mp}
        self.dp_index, self.mp_index, self.device = dp, mp, device

    def size(self, axis_name) -> int:
        return 1

    def psum(self, x, axis_name):
        return x

    pmin = pmax = psum


# ---------------------------------------------------------------------------
# Checks: each returns (ok, max|d|, bar)
# ---------------------------------------------------------------------------


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _rows_chunked(fn, rows: torch.Tensor, *rest, elems: int = 2 ** 27):
    """``fn`` of a row-wise twin over row slices small enough that its
    (rows, n_r, 8) intermediates stay bounded, concatenated."""
    step = max(1, elems // (8 * rest[0].shape[1]))
    return torch.cat([fn(rows[s:s + step], *rest) for s in range(0, rows.shape[0], step)])


def check_rep_assign(args, counts: bool):
    """K1 (counts) or K1' against the twin: every rid equal; K1's counts the
    twin's and the bincount of its own rids; K1' equal to K1."""
    moving8, C, srow = args
    rid_t = _rows_chunked(fs.rep_assign_ref, moving8, C, srow)
    if counts:
        rid, cnt = fs.rep_assign_counts(*args)
        own = torch.zeros_like(cnt).scatter_add_(0, rid.long(), torch.ones_like(rid))
        cnt_t = torch.zeros_like(cnt).scatter_add_(0, rid_t.long(), torch.ones_like(rid_t))
        _sync()
        ok = torch.equal(rid, rid_t) and torch.equal(cnt, cnt_t) and torch.equal(cnt, own)
        return ok, float((cnt - cnt_t).abs().max()), "rid and counts bitwise"
    rid = fs.rep_assign(*args)
    rid_k, _ = fs.rep_assign_counts(*args)
    _sync()
    ok = torch.equal(rid, rid_t) and torch.equal(rid, rid_k)
    return ok, float((rid != rid_t).sum()), "rid bitwise, equal to K1's"


def _k2_twin(rows, starts, *, capacity, order=None):
    """K2's twin in either form: bin_table_ref of the gathered rows."""
    sources = (rows,) if isinstance(rows, torch.Tensor) else tuple(rows)
    return tb.bin_table_ref(tb.gathered_rows(sources, order), starts, capacity=capacity)


def _table_width(args, kwargs) -> int:
    """Lanes of the rows K2 groups: its sources' widths summed."""
    sources = (args[0],) if isinstance(args[0], torch.Tensor) else tuple(args[0])
    return sum(x.shape[1] for x in sources)


def check_table(args, kwargs):
    """K2 bitwise against its twin."""
    got, want = tb.bin_table(*args, **kwargs), _k2_twin(*args, **kwargs)
    _sync()
    err = float((got - want).abs().nan_to_num().max()) if got.numel() else 0.0
    return bitwise(got, want), err, "bitwise"


def check_moments(kernel, twin, args, kwargs):
    """K3 or K7: every output within MOMENTS_BAR of its largest entry, and a
    second launch bitwise equal to the first."""
    got, want, again = kernel(*args, **kwargs), twin(*args, **kwargs), kernel(*args, **kwargs)
    _sync()
    if isinstance(got, torch.Tensor):
        got, want, again = (got,), (want,), (again,)
    ok, worst = True, 0.0
    for g, w, a in zip(got, want, again):
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        worst = max(worst, err)
        ok = ok and err <= MOMENTS_BAR * scale and torch.equal(g, a)
    return ok, worst, f"max|d| <= {MOMENTS_BAR} max|P|, repeats bitwise"


def check_min_dists(args):
    """K4 bitwise: the same +inf slots and every finite d2 the twin's bits."""
    got, want = fs.bin_min_dists(*args), fs.bin_min_dists_ref(*args)
    _sync()
    return bitwise(got, want), finite_err(got, want), "bitwise"


def check_search(args):
    """K5: scores and payloads bitwise."""
    best, matched = bs.bin_search(*args)
    best_t, matched_t = bs.bin_search_ref(*args)
    _sync()
    ok = bitwise(best, best_t) and bitwise(matched, matched_t)
    return ok, max(finite_err(best, best_t), finite_err(matched, matched_t)), "bitwise"


def check_brute(args):
    """K6: every index equal and every score bitwise."""
    idx, score = bn.brute_nn(*args)
    idx_t, score_t = bn.brute_nn_ref(*args)
    _sync()
    return (torch.equal(idx, idx_t) and bitwise(score, score_t), finite_err(score, score_t),
            "idx and scores bitwise")


def check_top2(args):
    """K9: i1, i2 and counts bitwise, the counts the bincounts of its ids."""
    p3, reps = args
    got = km.rep_top2_counts(p3, reps)
    want = km.rep_top2_counts_ref(p3, reps, chunk=max(1, 2 ** 26 // reps.shape[0]))
    _sync()
    own = all(torch.equal(got[2][j], km.bin_counts(got[j], reps.shape[0])) for j in range(2))
    ok = own and all(torch.equal(g, w) for g, w in zip(got, want))
    return ok, float((got[2] - want[2]).abs().max()), "i1, i2 and counts bitwise"


def check_knn(args, kwargs):
    """K8: n bitwise, components within KNN_BAR of each query's largest,
    repeating bitwise."""
    qp, bins = args[0], args[1]
    chunk = max(1, 2 ** 25 // (qp.shape[1] * bins.shape[1]))
    comps, cnt = km.bin_knn_moments(*args, **kwargs)
    again = km.bin_knn_moments(*args, **kwargs)
    comps_t, cnt_t = km.bin_knn_moments_ref(*args, **dict(kwargs, chunk=chunk))
    _sync()
    ck, ct = torch.stack(comps), torch.stack(comps_t)
    err = float((ck - ct).abs().max())
    rel = float(((ck - ct).abs() / ct.abs().amax(dim=0).clamp(min=1e-30)).max())
    ok = (torch.equal(cnt, cnt_t) and rel <= KNN_BAR and bitwise(ck, torch.stack(again[0]))
          and torch.equal(cnt, again[1]))
    return ok, err, f"n bitwise, max|dC| <= {KNN_BAR} of the query's largest, repeats bitwise"


def launch_counts() -> dict:
    """{wrapper: launches so far} of every kernel of the matrix."""
    wrappers = (fs.rep_assign_counts, fs.rep_assign, tb.bin_table, fs.bin_point_moments,
                fs.bin_min_dists, bs.bin_search, bn.brute_nn, fg.bin_gn_moments,
                km.bin_knn_moments, km.rep_top2_counts)
    return {fn.__name__: fn.launches for fn in wrappers}


def device_ms(fn, reps: int = 5):
    """Mean device ms of one call of ``fn`` over ``reps`` back-to-back calls
    behind a short spin (None off the card)."""
    if not torch.cuda.is_available():
        return None
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# The cases of each shape class: key -> (check, timed call)
# ---------------------------------------------------------------------------


def _robust_delta(args) -> float:
    """A robust scale at the median blended NN distance of a search's
    arguments (K4's twin): about half the pairs on each side of it."""
    from icp_tpu_torch.ops.moments import masked_median

    d2 = fs.bin_min_dists_ref(*args[:8])
    return float(torch.sqrt(masked_median(d2, torch.isfinite(d2))))


def _register_cases(name, sc, dev, pairs) -> dict:
    """The POINT, robust-adaptive, unfused, GN and BRUTE steps of a
    registration class, captured once each."""
    from icp_tpu_torch import Correspondence, ICPParams, Objective, RobustKernel, icp_step
    from icp_tpu_torch.icp.run import build_index
    from icp_tpu_torch.icp.state import identity_state
    from icp_tpu_torch.ops import distance as distance_mod
    from icp_tpu_torch.ops.sampling import sample_representative_indices
    from icp_tpu_torch.rbc import grouping
    from icp_tpu_torch.rbc import search as search_mod

    cfg = sc.config
    prm = ICPParams(alpha=ALPHA).to(dev)
    st0 = identity_state(torch.float32, dev)
    fixed, moving = pairs.point(sc)
    cases = {}
    if sc.family == "assign":  # K1 alone: C and srow as prep_rep_assign makes them
        reps = fixed[sample_representative_indices(cfg.m, cfg.n_r, cfg.rep_grid,
                                                   device=dev).long()]
        G, b_row = fs.prep_similarity(st0.q, st0.t, st0.s)
        C, srow = fs.prep_rep_assign(reps, prm.alpha, G.contiguous(), b_row)
        k1 = (moving, C.contiguous(), srow)
    else:
        index = build_index(fixed, prm, cfg)
        got = record_calls([(search_mod, "rep_assign_counts"), (search_mod, "bin_point_moments"),
                            (grouping, "bin_table")],
                           lambda: icp_step(st0, moving, index, prm, cfg))
        k1 = got["rep_assign_counts"][0][0]
    n_r, m = cfg.n_r, cfg.m
    cases[f"repassignc|m{m}|nr{n_r}"] = (lambda: check_rep_assign(k1, True),
                                         lambda: fs.rep_assign_counts(*k1))
    cases[f"repassign|m{m}|nr{n_r}"] = (lambda: check_rep_assign(k1, False),
                                        lambda: fs.rep_assign(*k1))
    if sc.family == "assign":
        return cases
    cq, cb = cfg.query_capacity, cfg.bin_capacity
    dims = f"{n_r}x{cq}x{cb}"
    (t8,) = got["bin_table"]
    k3, k3_kw = got["bin_point_moments"][0]
    delta = _robust_delta(k3)
    tables = {8: t8}
    for row in sm.kernel_rows():
        if row.shape_class != name or row.kind != "point":
            continue
        kw = dict(k3_kw, weighted=row.weighted, robust=row.robust, robust_delta=delta)
        cases[row.key] = (
            lambda kw=kw: check_moments(fs.bin_point_moments, fs.bin_point_moments_ref, k3, kw),
            lambda kw=kw: fs.bin_point_moments(*k3, **kw))

    cfg_r = dataclasses.replace(cfg, robust=RobustKernel.HUBER, robust_adaptive=True)
    k4 = capture(search_mod, "bin_min_dists", lambda: icp_step(
        st0, moving, build_index(fixed, prm, cfg_r), prm, cfg_r))[0]
    cases[f"mindist|{dims}"] = (lambda: check_min_dists(k4), lambda: fs.bin_min_dists(*k4))

    cfg_u = dataclasses.replace(cfg, fused_point=False)
    k5 = {8: capture(search_mod, "bin_search", lambda: icp_step(st0, moving, index, prm,
                                                                  cfg_u))[0]}
    if name == "flagship":
        cfg_b = dataclasses.replace(cfg, correspondence=Correspondence.BRUTE)
        k6 = capture(distance_mod, "brute_nn", lambda: icp_step(st0, moving, fixed, prm,
                                                                 cfg_b))[0]
        cases[f"brute|m{m}|n{m}"] = (lambda: check_brute(k6),
                                     lambda: bn.brute_nn(*k6))

    # The GN steps: the rendered pair (or the wavy one with kNN normals).
    fixed_g, moving_g, normal_mode = pairs.gn(sc)
    gn = dict(estimate_scale=False, normal_mode=normal_mode)
    cfg_pu = dataclasses.replace(cfg, objective=Objective.PLANE, fused_gn=False, **gn)
    k5[12] = capture(search_mod, "bin_search", lambda: icp_step(
        st0, moving_g, build_index(fixed_g, prm, cfg_pu), prm, cfg_pu))[0]
    cfg_g = dataclasses.replace(cfg, objective=Objective.GICP, **gn)
    index_g = build_index(fixed_g, prm, cfg_g)
    got = record_calls([(search_mod, "bin_gn_moments"), (grouping, "bin_table")],
                       lambda: icp_step(st0, moving_g, index_g, prm, cfg_g))
    # The step's grouping of the queries and their normals (a GICP step on
    # an unorganized cloud first groups for its kNN normals: d 4 and 3).
    (tables[11],) = [c for c in got["bin_table"] if _table_width(*c) == 11]
    k7, k7_kw = got["bin_gn_moments"][0]
    delta_g = _robust_delta((k7[0], k7[2], k7[3], k7[4][..., :8], *k7[5:]))
    for v, a in k5.items():
        cases[f"binsearch|{dims}|v{v}"] = (lambda a=a: check_search(a),
                                           lambda a=a: bs.bin_search(*a))
    for d, (a, kw) in tables.items():
        cases[f"table|m{m}|nr{n_r}|cap{cq}|d{d}"] = (
            lambda a=a, kw=kw: check_table(a, kw),
            lambda a=a, kw=kw: tb.bin_table(*a, **kw))
    for row in sm.kernel_rows():
        if row.shape_class != name or row.kind != "gn":
            continue
        a = (k7[0], None if row.mode == "plane" else k7[1]) + tuple(k7[2:])
        kw = dict(k7_kw, mode=row.mode, weighted=row.weighted, robust=row.robust,
                  robust_delta=delta_g)
        cases[row.key] = (
            lambda a=a, kw=kw: check_moments(fg.bin_gn_moments, fg.bin_gn_moments_ref, a, kw),
            lambda a=a, kw=kw: fg.bin_gn_moments(*a, **kw))
    return cases


@contextlib.contextmanager
def _world_of_1(dev):
    """The (1, 1) mesh of a world of 1 in this process (NCCL on the card),
    over the process group if one is up, else over one started here and
    ended on exit."""
    import torch.distributed as dist

    from icp_tpu_torch.parallel import initialize_multihost, make_mesh
    from icp_tpu_torch.parallel.dryrun import free_port

    started = not dist.is_initialized()
    if started:
        initialize_multihost(f"localhost:{free_port()}", 1, 0, timeout_s=60)
    try:
        yield make_mesh(1, 1, dev)
    finally:
        if started:
            dist.destroy_process_group()


def _sharded_cases(name, sc, dev, pairs) -> dict:
    """K2 over n_r_local + 1 bins, K3 (POINT) and K5 (PLANE, GICP,
    robust-adaptive PLANE) on what one sharded step hands them at every
    rank of the class's mesh. The (1, 1) step runs on a real world of 1;
    the ranks of larger meshes are emulated here (:class:`RankStandIn`),
    their phase 1 taken as the nearest of all the representatives with the
    lowest id on a tie, which is what the two pmins of
    ``sharded._phase1_owned_bins`` give."""
    from icp_tpu_torch import ICPConfig, ICPParams, Objective, RobustKernel, Weighting
    from icp_tpu_torch.icp.state import identity_state
    from icp_tpu_torch.ops.distance import pairwise_sq_dists
    from icp_tpu_torch.parallel import sharded
    from icp_tpu_torch.rbc import grouping
    from icp_tpu_torch.rbc import search as search_mod

    n_dp, n_mp = sc.mesh
    prm = ICPParams(alpha=ALPHA).to(dev)
    fixed, moving = pairs.point(sc)
    la, lb, dirty = pairs.rendered()
    variants = {
        "point": (ICPConfig(), fixed, moving),
        "plane": (ICPConfig(objective=Objective.PLANE, estimate_scale=False), la, lb),
        "gicp": (ICPConfig(objective=Objective.GICP, estimate_scale=False), la, lb),
        "robust": (ICPConfig(objective=Objective.PLANE, weighting=Weighting.REGULAR,
                             robust=RobustKernel.TRIMMED, robust_adaptive=True,
                             estimate_scale=False), la, dirty),
    }
    n_bins, cap, cb = sm.sharded_capacities(sc.config, sc.mesh)
    mesh = f"mesh{n_dp}x{n_mp}"
    calls = {}  # key -> [(check, timed call)] over the ranks

    def capture_rank(rank, emulated):
        for variant, (config, f, mv) in variants.items():
            n_r_local = config.n_r // n_mp
            index, mov, mnorm = sharded.sharded_inputs(f, mv, prm, config, rank)

            def phase1(local, tm, p, n_loc, r, reps=index.reps):
                rid = torch.argmin(pairwise_sq_dists(tm, reps, p.alpha), dim=1)
                rid = rid.to(torch.int32) - r.mp_index * n_loc
                return torch.where((rid >= 0) & (rid < n_loc), rid,
                                   torch.full_like(rid, n_loc))

            kind, v = sm.SHARDED_VARIANTS[variant]
            orig = sharded._phase1_owned_bins
            if emulated:
                sharded._phase1_owned_bins = phase1
            try:
                got = record_calls(
                    [(grouping, "bin_table"), (sharded, "bin_point_moments"),
                     (search_mod, "bin_search")],
                    lambda: sharded.sharded_icp_step(
                        identity_state(torch.float32, dev), mov, index, prm, config,
                        n_r_local, cap, rank, mnormals_local=mnorm))
            finally:
                sharded._phase1_owned_bins = orig
            (t_a, t_kw), = got["bin_table"]
            d = sm.SHARDED_TABLE_WIDTH[variant]
            key = f"table|{mesh}|{variant}|m{config.m // n_dp}|nr{n_bins}|cap{cap}|d{d}"
            calls.setdefault(key, []).append((
                lambda a=t_a, kw=t_kw: check_table(a, kw),
                lambda a=t_a, kw=t_kw: tb.bin_table(*a, **kw)))
            dims = f"{n_bins - 1}x{cap}x{cb}"
            if kind == "point":
                (a, kw), = got["bin_point_moments"]
                calls.setdefault(f"point|{mesh}|{dims}|w1|none", []).append((
                    lambda a=a, kw=kw: check_moments(
                        fs.bin_point_moments, fs.bin_point_moments_ref, a, kw),
                    lambda a=a, kw=kw: fs.bin_point_moments(*a, **kw)))
            else:
                (a, _), = got["bin_search"]
                calls.setdefault(f"binsearch|{mesh}|{variant}|{dims}|v{v}", []).append((
                    lambda a=a: check_search(a), lambda a=a: bs.bin_search(*a)))

    if sc.mesh == (1, 1):
        with _world_of_1(dev) as mesh_1:
            capture_rank(mesh_1, False)
    else:
        for dp in range(n_dp):
            for mp in range(n_mp):
                capture_rank(RankStandIn(n_dp, n_mp, dp, mp, dev), True)

    def over_ranks(pairs_):
        def check():
            results = [c() for c, _ in pairs_]
            return (all(r[0] for r in results), max(r[1] for r in results), results[0][2]
                    + f" on all {len(results)} ranks")
        return check, pairs_[0][1]

    return {key: over_ranks(v) for key, v in calls.items()}


def _knn_cases(name, sc, dev, pairs) -> dict:
    """K9, the two groupings' K2 and K8 on what ``knn_normals_rbc`` hands
    them on the class's wavy cloud."""
    from icp_tpu_torch.ops import normals as normals_mod
    from icp_tpu_torch.rbc import grouping

    cloud = pairs.wavy(sc.points)[0]
    got = record_calls([(normals_mod, "rep_top2_counts"), (normals_mod, "bin_knn_moments"),
                        (grouping, "bin_table")],
                       lambda: normals_mod.knn_normals_rbc(cloud, n_r=sc.knn_n_r))
    (k9, _), = got["rep_top2_counts"]
    (k8, k8_kw), = got["bin_knn_moments"]
    n_r, cq, cb = sm.knn_capacities(sc.points, sc.knn_n_r)
    cases = {
        f"top2|m{sc.points}|nr{n_r}": (lambda: check_top2(k9),
                                       lambda: km.rep_top2_counts(*k9)),
        f"knn|{n_r}x{cq}x{cb}|k16": (lambda: check_knn(k8, k8_kw),
                                     lambda: km.bin_knn_moments(*k8, **k8_kw)),
    }
    for d, (a, kw) in zip((4, 3), got["bin_table"]):
        cases[f"table|knn|m{sc.points}|nr{n_r}|cap{cq}|d{d}"] = (
            lambda a=a, kw=kw: check_table(a, kw),
            lambda a=a, kw=kw: tb.bin_table(*a, **kw))
    return cases


def _e2e_cases(dev, pairs) -> dict:
    """The flagship registrations on the card against the CPU twins: POINT
    on ``synthetic_pair`` (0.01 mm, 0.001 deg), PLANE and GICP on the
    rendered gate pair (0.05 mm, 0.005 deg), each also within its gate of
    the ground truth (0.05 mm / 0.005 deg; 1.0 mm / 0.05 deg)."""
    from icp_tpu_torch import ICPConfig, ICPParams, Objective, register
    from icp_tpu_torch.icp.quaternion import qangle_deg, qconj, qmul

    params = ICPParams(alpha=ALPHA)
    fixed, moving = pairs.point(sm.shape_classes()["flagship"])
    la, lb, _ = pairs.rendered()
    cases = {}
    for name, config, f, mv, bars, gate, (q_gt, t_gt) in (
            ("point", ICPConfig(), fixed, moving, (0.01, 0.001), (0.05, 0.005), (Q_GT, T_GT)),
            ("plane", ICPConfig(objective=Objective.PLANE, estimate_scale=False), la, lb,
             (0.05, 0.005), (1.0, 0.05), (Q_GT_R, T_GT_R)),
            ("gicp", ICPConfig(objective=Objective.GICP, estimate_scale=False), la, lb,
             (0.05, 0.005), (1.0, 0.05), (Q_GT_R, T_GT_R))):
        def check(config=config, f=f, mv=mv, bars=bars, gate=gate, q_gt=q_gt, t_gt=t_gt):
            st = register(f.to(dev), mv.to(dev), params, config)
            before = launch_counts()
            st_cpu = register(f.cpu(), mv.cpu(), params, config)
            if launch_counts() != before:  # the CPU reference must be the twins alone
                raise AssertionError(f"e2e-{name}: the CPU registration launched a kernel: "
                                     f"{before} -> {launch_counts()}")
            dt = float(np.linalg.norm(st.t.double().cpu().numpy() - st_cpu.t.double().numpy()))
            da = float(qangle_deg(qmul(st.q.cpu(), qconj(st_cpu.q))))
            q = torch.tensor(q_gt, dtype=torch.float32)
            t_err = float(np.linalg.norm(st.t.double().cpu().numpy() - t_gt))
            a_err = float(qangle_deg(qmul(st.q.cpu(), qconj(q))))
            ok = dt <= bars[0] and da <= bars[1] and t_err < gate[0] and a_err < gate[1]
            return ok, dt, (f"card vs CPU |dt| <= {bars[0]} mm, angle <= {bars[1]} deg; "
                            f"t_err < {gate[0]} mm, a_err < {gate[1]} deg "
                            f"(k {int(st.k)} / {int(st_cpu.k)}, |dt| {dt:.6f} mm, "
                            f"{da:.7f} deg, t_err {t_err:.6f} mm, a_err {a_err:.7f} deg)")
        cases[f"e2e-{name}"] = (check, None)
    return cases


class _Pairs:
    """The class's landmark pairs on the device, made once each."""
    def __init__(self, dev):
        self.dev, self._cache = dev, {}

    def _get(self, key, make):
        if key not in self._cache:
            self._cache[key] = make()
        return self._cache[key]

    def wavy(self, m):
        from icp_tpu_torch.sensors.synthetic import wavy_surface_pair

        return self._get(("wavy", m), lambda: tuple(
            torch.from_numpy(x).to(self.dev) for x in wavy_surface_pair(m)[:2]))

    def point(self, sc):
        from icp_tpu_torch.sensors.synthetic import synthetic_pair

        m = sc.config.m
        if sc.pair == "wavy":
            return self.wavy(m)
        return self._get(("synthetic", m), lambda: tuple(
            torch.from_numpy(x).to(self.dev) for x in synthetic_pair(m, seed=0)))

    def rendered(self):
        return self._get("rendered", rendered_pair)

    def gn(self, sc):
        """(fixed, moving, normal_mode) of the class's GN steps: the rendered
        pair at its pyramid level, or the wavy pair with kNN normals."""
        from icp_tpu_torch.icp.pyramid import LM_GRID, subsample_grid

        m = sc.config.m
        if sc.pair == "wavy":
            return (*self.wavy(m), "knn")
        la, lb, _ = self.rendered()
        stride = int(round((LM_GRID * LM_GRID // m) ** 0.5))
        return (subsample_grid(la, stride).to(self.dev), subsample_grid(lb, stride).to(self.dev),
                "auto")


def sweep(dev, log=print) -> dict:
    """Run every row of the matrix on ``dev``. Returns {key: {"ok", "err",
    "bar", "ms", "kernel", ...}}; a row whose check raised has ``ok`` False
    and the error's text."""
    rows = sm.rows_by_key()
    pairs = _Pairs(dev)
    results = {}
    makers = {"register": _register_cases, "assign": _register_cases,
              "sharded": _sharded_cases, "knn": _knn_cases}
    for name, sc in sm.shape_classes().items():
        t0 = time.perf_counter()
        cases = makers[sc.family](name, sc, dev, pairs)
        if name == "flagship":
            cases.update(_e2e_cases(dev, pairs))
        want = {key for key, row in rows.items() if row.shape_class == name}
        if set(cases) != want:
            raise AssertionError(f"class {name}: cases {sorted(set(cases) ^ want)} do not "
                                 "match the matrix's rows")
        for key in sorted(cases, key=list(rows).index):
            check, call = cases[key]
            entry = {"kernel": sm.KERNEL_OF[rows[key].kind]}
            try:
                ok, err, bar = check()
                entry.update(ok=bool(ok), err=err, bar=bar,
                             ms=device_ms(call) if call is not None else None)
            except Exception as exc:  # a launch the card refused, or a shape error
                entry.update(ok=False, err=None, bar=None, ms=None,
                             error=f"{type(exc).__name__}: {exc}")
            results[key] = entry
            log(f"support {key}: {'ok' if entry['ok'] else 'FAILED'} "
                f"(max|d| {entry['err']}, {entry['bar'] or entry.get('error')}; "
                f"{entry['ms']} ms)")
        del cases
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        log(f"support class {name}: {len(want)} rows, {time.perf_counter() - t0:.1f} s")
    return results


def _kernel_name(mangled: str) -> str:
    """The last name of an Itanium-mangled nested name and its template
    arguments: ``rep_top2_counts_kernelILi8ELb1EE``."""
    i = mangled.find("_ZN")
    i = i + 3 if i >= 0 else mangled.find("_Z") + 2
    name = mangled
    while 0 < i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    if i < len(mangled) and mangled[i] == "I":  # to its matching E: I, L, N open
        depth, j = 0, i
        while j < len(mangled):
            depth += 1 if mangled[j] in "ILN" else -1 if mangled[j] == "E" else 0
            j += 1
            if depth == 0:
                break
        name += mangled[i:j]
    return name


def ptxas_info(log: str) -> dict:
    """{source file: [{"kernel", "registers", "spill_stores", "spill_loads",
    "smem_bytes"}, ...]} from the ``-Xptxas -v`` build log."""
    info, src, entry = {}, None, None
    for line in log.splitlines():
        if line.startswith("== "):
            src = line[3:].strip()
            info[src] = []
        elif "Compiling entry function" in line and src:
            entry = {"kernel": _kernel_name(line.split("'")[1])}
            info[src].append(entry)
        elif "spill stores" in line and entry is not None:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            entry.update(spill_stores=nums[1], spill_loads=nums[2])
        elif "Used" in line and "registers" in line and entry is not None:
            entry["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            entry["smem_bytes"] = int(smem.group(1)) if smem else 0
    return info


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "--id=0"], capture_output=True,
                          text=True, check=True).stdout.strip()


def table(results: dict, seconds: float) -> dict:
    """The table ``--write`` records."""
    from icp_tpu_torch.kernels import native

    return {"digest": native.source_digest(), "wrappers_digest": sm.wrappers_digest(),
            "card": card(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "rows": results, "n_rows": len(results), "seconds": seconds,
            "ptxas": ptxas_info(native.build_info.get("log", ""))}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--write", action="store_true", help="write the table")
    parser.add_argument("--out", default=str(sm.TABLE_PATH), help="where --write writes it")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("support_sweep: no CUDA device; the matrix is verified on the card",
              file=sys.stderr)
        return 2
    from icp_tpu_torch.kernels import native

    native.load_library()
    t0 = time.perf_counter()
    results = sweep(torch.device("cuda", 0), log=lambda s: print(s, flush=True))
    seconds = time.perf_counter() - t0
    bad = sorted(key for key, r in results.items() if not r["ok"])
    print(f"support matrix: {len(results)} rows, {len(bad)} failed, {seconds:.1f} s on "
          f"{card()}", flush=True)
    if args.write:
        with open(args.out, "w") as f:
            json.dump(table(results, seconds), f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.out}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
