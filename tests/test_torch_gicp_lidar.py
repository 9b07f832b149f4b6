"""GICP LiDAR odometry, the benchmark's ``lidar.gicp`` cell, on the CPU at a
small size.

The port's ``register`` (GICP, "knn" normals) follows the benchmark's plain
GICP reference (``portbench/reference/gicp.py``) iteration by iteration on a
small sweep of the cell's sensor, and copies of the reference with a planted
fault (the moving normals left unrotated, or zeroed) are told apart from it.
The reference loads nothing of the port or of JAX. A GICP registration opens
one ``icp.moving_normals`` span and counts one estimate; POINT and PLANE
open none. K7's work count at the LiDAR shape by hand, and the two readers
of the cell's new metrics on a made-up window.
"""

import tests.torch_one_thread  # noqa: F401  (torch on one CPU thread)
import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import icp_tpu_torch  # noqa: E402
from icp_tpu_torch.icp import run as run_mod  # noqa: E402
from icp_tpu_torch.runtime import timing  # noqa: E402
from icp_tpu_torch.sensors.synthetic import synthetic_pair  # noqa: E402
from portbench import check, drive, peaks, scene, spec, work_gn  # noqa: E402
from portbench.devtrace import Trace  # noqa: E402
from portbench.reference import gicp as ref_gicp  # noqa: E402

REFERENCE = ROOT / "portbench" / "reference" / "gicp.py"
ITERATIONS = 8  # one chunk, every step taken (thresholds 0)
SEED, PAIR = 2, (1, 2)  # a pair turned by 0.03 rad, the larger of the pool's two
# The sound run's per-iteration gaps to the reference, as read here: at most
# 0.018 mm and 8.5e-4 deg. At this size (2048 rays in a room) the port and
# the reference, which build their own bins, pick another fixed point for a
# few near-tied pairs (the port's float32 d^2 of a pair cancels at bin-centred
# coordinates of metres), which moves a step by up to 0.083 mm and 3.4e-3 deg
# on other seeds. The planted faults move the pose by 0.68 mm (unrotated) and
# 67 mm (zeroed) at the last iteration.
T_TOL_MM = 0.1
ANGLE_TOL_DEG = 0.005


def small_sweep_config() -> dict:
    """The cell's configuration on a 32 x 64-ray sweep in a 8 x 6 m room
    (the hall's walls, floor and ceiling, two pillars), n_r 128, every step
    of one chunk taken."""
    cfg = spec.load_json(ROOT / "portbench/configs/lidar_os1_262144x2048_gicp.json")
    cfg["points"] = 32 * 64
    cfg["sensor"].update(beams=32, columns=64)
    cfg["scene"].update(half_extent_mm=[4000.0, 3000.0],
                        pillars_mm=[[-2000.0, 0.0], [2000.0, 0.0]])
    cfg["icp"].update(n_r=128, max_iterations=ITERATIONS, angle_threshold_deg=0.0,
                      translation_threshold_mm=0.0)
    return cfg


@pytest.fixture(scope="module")
def sweep_run():
    """The port's pose after each iteration of one ``register`` of the pair
    (each step's state recorded as ``_run_lanes`` takes it), its final
    state, and the reference's run with its normals cache."""
    cfg = small_sweep_config()
    frames = scene.make_pool(SEED, cfg, 4, "cpu")["frames"]
    params, config = drive.port_settings(cfg)
    states = []
    step = run_mod.icp_step

    def recording_step(*args, **kwargs):
        states.append(step(*args, **kwargs))
        return states[-1]

    run_mod.icp_step = recording_step
    try:
        final = icp_tpu_torch.register(frames[PAIR[0]], frames[PAIR[1]], params, config)
    finally:
        run_mod.icp_step = step
    cache = {}
    ref = ref_gicp.run(frames, PAIR, cfg["icp"], ITERATIONS, cache)
    return {"cfg": cfg, "frames": frames, "states": states, "final": final,
            "ref": ref, "cache": cache}


def _gaps(states, ref) -> list:
    out = []
    for k, st in enumerate(states, 1):
        row = torch.cat([st.q, st.t, st.s.reshape(1), torch.tensor([float(k)])]).double()
        out.append(check.pose_gaps(row, ref))
    return out


def _faulty_reference(old: str, new: str):
    """A copy of the reference module with ``old`` replaced by ``new``."""
    source = REFERENCE.read_text()
    assert source.count(old) == 1
    spec_ = importlib.util.spec_from_loader("gicp_fault", loader=None)
    module = importlib.util.module_from_spec(spec_)
    exec(compile(source.replace(old, new), "gicp_fault", "exec"), module.__dict__)
    return module


def test_register_follows_the_reference_after_each_iteration(sweep_run):
    states, final = sweep_run["states"], sweep_run["final"]
    assert len(states) == ITERATIONS and int(final.k) == ITERATIONS
    assert torch.equal(final.t, states[-1].t) and torch.equal(final.q, states[-1].q)
    assert sweep_run["ref"]["k"] == ITERATIONS
    for k, g in enumerate(_gaps(states, sweep_run["ref"]), 1):
        assert g["t_gap_mm"] <= T_TOL_MM, (k, g)
        assert g["angle_gap_deg"] <= ANGLE_TOL_DEG, (k, g)
        assert g["scale_gap"] == 0.0


@pytest.mark.parametrize("fault", [
    ("moving_normals[qi] @ R.T", "moving_normals[qi]"),  # left unrotated
    ("moving_normals[qi] @ R.T", "0.0 * moving_normals[qi]"),  # zeroed
], ids=["unrotated", "zeroed"])
def test_a_planted_fault_in_the_moving_normals_is_told_apart(sweep_run, fault):
    faulty = _faulty_reference(*fault)
    frames, cfg, cache = sweep_run["frames"], sweep_run["cfg"], sweep_run["cache"]
    ref = faulty.run(frames, PAIR, cfg["icp"], ITERATIONS, dict(cache))
    assert _gaps(sweep_run["states"], ref)[-1]["t_gap_mm"] > 2 * T_TOL_MM


def test_the_reference_refuses_what_it_does_not_compute():
    icp = small_sweep_config()["icp"]
    for bad in ({"objective": "plane"}, {"normal_mode": "grid"}, {"robust": "huber"}):
        with pytest.raises(ValueError, match="gicp reference"):
            ref_gicp.run(None, (0, 1), {**icp, **bad}, 0, {})
    with pytest.raises(ValueError, match="gicp_epsilon"):
        ref_gicp.run(None, (0, 1), {k: v for k, v in icp.items() if k != "gicp_epsilon"},
                     0, {})


def test_the_reference_loads_nothing_of_the_port_nor_jax():
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, portbench.reference.gicp\n"
         "print(' '.join(sys.modules))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    names = {m.split(".")[0] for m in proc.stdout.split()}
    assert "torch" in names
    assert not names & {"icp_tpu_torch", "icp_tpu", "jax", "jaxlib", "flax"}


def test_the_cell_is_the_lidar_stream_sweeps_under_gicp():
    cell = spec.cell("lidar.gicp")
    plane = spec.load_json(ROOT / "portbench/configs/lidar_os1_262144x2048.json")
    for key in ("points", "sampling", "sensor", "scene", "motion"):
        assert cell["config"][key] == plane[key], key
    assert cell["traffic"] == spec.cell("lidar.stream")["traffic"]
    assert spec.reference(cell["config"]).__module__ == "portbench.reference.gicp"
    params, config = drive.port_settings(cell["config"])
    assert config.objective is icp_tpu_torch.Objective.GICP
    assert (config.normal_mode, config.n_r, config.m) == ("knn", 2048, 262144)
    assert params.gicp_epsilon == 0.001


@pytest.fixture
def spans():
    timing.take_spans()
    timing.record_spans(True)
    try:
        yield
    finally:
        timing.record_spans(False)
        timing.take_spans()


@pytest.mark.parametrize("objective", ["gicp", "point", "plane"])
def test_gicp_alone_opens_the_moving_normals_span(spans, objective):
    m = 1024
    kwargs = {} if objective == "point" else dict(
        objective=icp_tpu_torch.Objective(objective), normal_mode="knn", estimate_scale=False)
    config = icp_tpu_torch.ICPConfig(m=m, n_r=16, max_iterations=8, **kwargs)
    fixed, moving = (torch.from_numpy(x) for x in synthetic_pair(m, seed=3))
    before = timing.counters().get("icp.moving_normals", 0)
    icp_tpu_torch.register(fixed, moving, icp_tpu_torch.ICPParams(alpha=2e2), config)
    counted = timing.counters().get("icp.moving_normals", 0) - before
    recorded = timing.take_spans()
    mine = [s for s in recorded if s.name == "icp.moving_normals"]
    if objective != "gicp":
        assert mine == [] and counted == 0
        return
    assert len(mine) == 1 and counted == 1
    by_id = {s.id: s for s in recorded}
    assert by_id[mine[0].parent].name == "icp.run"
    inner = [s for s in recorded if s.name == "icp.normals" and s.parent == mine[0].id]
    assert len(inner) == 1


@pytest.mark.parametrize("mode,row_ops,moments", [
    ("plane", 14 + 36 * 3, 1), ("plane_sym", 3 + 14 + 36 * 3, 1),
    ("gicp", 6 + 28 + 5 + 10 + 2 + 36 * 6 + 28 * 3, 2)])
def test_k7_work_count_by_hand_at_the_lidar_shape(mode, row_ops, moments):
    m, n_r = 262144, 2048
    cb, cq = 256, 192  # 2x and 1.5x the mean occupancy of 128
    ops, nbytes = work_gn.gn_moments(m, m, n_r, mode)
    per_query = 128 + 24 + 3 + 3 + row_ops
    assert ops == 50 * m * 128 + m * per_query
    lanes = 8 + (0 if mode == "plane" else 3) + 1
    assert nbytes == 4 * (n_r * cq * lanes + n_r * 8 + n_r * cb * 13 + 64 + 8 + 3
                          + n_r * 64 * moments)
    # The operations bound it: ~1.8 GFLOP against ~47 MB.
    assert peaks.least_seconds(ops, nbytes) == pytest.approx(ops / peaks.PEAK_FP32_FLOPS)
    with pytest.raises(ValueError):
        work_gn.gn_moments(m, m, n_r, "point")


def test_the_new_readers_on_a_made_up_window():
    config = {"points": 262144, "icp": {"n_r": 2048, "objective": "gicp"}}
    ops, nbytes = work_gn.gn_moments(262144, 262144, 2048, "gicp")
    least = peaks.least_seconds(ops, nbytes)
    kernel = "void (anonymous namespace)::bin_gn_moments_kernel<2>(float const*)"
    trace = Trace(device=[(kernel, 0.0, 4 * least), (kernel, 1.0, 1.0 + 4 * least),
                          ("other", 2.0, 3.0)], host=[], start=0.0, end=4.0)
    spans = [timing.Span("icp.moving_normals", 0, 6_000_000, 1, None, 1),
             timing.Span("icp.moving_normals", 10_000_000, 12_000_000, 2, None, 2),
             timing.Span("icp.normals", 0, 5_000_000, 3, 1, 1)]
    w = drive.Window(calls=[], seconds=4.0, trace=trace, config=config,
                     traced_counters={"icp.moving_normals": 2}, traced_spans=spans)
    assert spec.metric_reader("roofline_share.K7")(w) == pytest.approx(25.0)
    assert spec.metric_reader("moving_normals_ms")(w) == pytest.approx(4.0)
    # Nothing to read (no K7 call, a program without the span): no value, not 0.
    parent = drive.Window(calls=[], seconds=4.0, config=config,
                          trace=Trace(device=[("other", 0.0, 1.0)], host=[], start=0.0,
                                      end=2.0))
    assert spec.metric_reader("roofline_share.K7")(parent) is None
    assert spec.metric_reader("moving_normals_ms")(parent) is None
