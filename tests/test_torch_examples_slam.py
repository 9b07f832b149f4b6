"""The port's SLAM and multi-card demos (``icp_tpu_torch.examples``:
odometry, odometry_service, multichip) against the JAX package's
``examples/``, and the service's crash and resume.

Size: the port's CPU twins of the kernels cost ~0.5 s a step at the
flagship width (16384 landmarks, n_r 256) on one core, so the SLAM examples
run here as tests/test_torch_slam_engine.py runs the engine: on the 64x64
subsample of each frame's landmark grid, m 4096 and n_r 64, in both
packages. The cut is made with ``monkeypatch``: each package's
``ICPConfig`` takes m 4096 and n_r 64, each renderer's ``render_cloud``
returns the subsample (the port's returns the JAX frame's, so both start
from the same clouds), and for recorded ``.bin`` frames the engine's
``frame_to_landmarks`` subsamples likewise. ``multichip`` runs as its JAX
docstring suggests for CPUs, m 1024 and n_r 16, on a gloo world of 2 ranks
against JAX's mesh over the conftest's virtual devices. Full width runs on
the card (chip_smoke.py, phase 3i).

Tolerances: the odometry maps as tests/test_torch_slam_engine.py holds
them (the same keyframes and closures; trajectory and measurements within
0.05 mm and 1e-5 in q before ``optimize_map``, the keyframes within 1 mm
and 2e-2 after it), the printed ATE within 0.05 mm (1 mm after the
optimization); the sharded state within the larger of the slice's
tolerances and four times JAX's own one-ulp spread (the rule of
tests/test_torch_parallel.py), every rank bitwise rank 0's. The service's
resumed run equals its uninterrupted run bitwise.
"""

import contextlib
import functools
import io
import re
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import icp_tpu
import icp_tpu_torch
from __graft_entry__ import _synthetic_pair
from icp_tpu.icp.pyramid import subsample_grid as j_subsample_grid
from icp_tpu.ops.sampling import get_landmarks as j_get_landmarks
from icp_tpu.parallel import distributed as JDIST
from icp_tpu.parallel import sharded as JSH
from icp_tpu.sensors import synthetic as JY
from icp_tpu.slam import mapping as JM
from icp_tpu_torch.examples import frame_grabber as TFG
from icp_tpu_torch.examples import multichip as TMC
from icp_tpu_torch.examples import odometry as TODO
from icp_tpu_torch.examples import odometry_service as TSVC
from icp_tpu_torch.icp.pyramid import subsample_grid
from icp_tpu_torch.parallel.dryrun import launch_world
from icp_tpu_torch.sensors import synthetic as TY
from icp_tpu_torch.slam import mapping as TM
from tests.test_torch_examples import _diff, _jax_main, _labels, _port_main
from tests.test_torch_slam_engine import OPT_Q_TOL, OPT_T_TOL, _same_map

import examples.multichip as JMC
import examples.odometry as JODO

M_S, N_R_S = 4096, 64


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def _small(landmarks):
    """The 64x64 subsample of a 128x128 landmark grid (m 4096)."""
    return (j_subsample_grid(landmarks, 2) if isinstance(landmarks, jnp.ndarray)
            else subsample_grid(landmarks, 2))


@pytest.fixture
def small_configs(monkeypatch):
    """Both packages' ICPConfig at m 4096, n_r 64, as the examples import it."""
    for pkg in (icp_tpu, icp_tpu_torch):
        monkeypatch.setattr(pkg, "ICPConfig", functools.partial(pkg.ICPConfig, m=M_S, n_r=N_R_S))


def _spy(mp, cls, name, record):
    """Call ``record(self)`` before each ``cls.name`` call; returns the
    instances seen."""
    seen, real = [], getattr(cls, name)

    def spy(self, *a, **kw):
        seen.append(self)
        record(self)
        return real(self, *a, **kw)

    mp.setattr(cls, name, spy)
    return seen


def test_odometry_matches_jax(tmp_path, monkeypatch, small_configs):
    """``odometry --frames 3`` (POINT) in both packages on the same frames:
    the same map before and after ``optimize_map``, the same report."""
    real_render = JY.render_cloud

    def j_render(scene, pose):
        return _small(j_get_landmarks(real_render(scene, pose).reshape(-1, 8)))

    def t_render(scene, pose):
        jpose = JY.CameraPose(jnp.asarray(pose.q.numpy()), jnp.asarray(pose.t.numpy()))
        return torch.from_numpy(np.array(j_render(JY.default_scene(), jpose)))

    monkeypatch.setattr(JY, "render_cloud", j_render)
    monkeypatch.setattr(TY, "render_cloud", t_render)
    before = {}  # engine -> its map before optimize_map, as (trajectory, keyframes)

    def record(eng):
        before[id(eng)] = [(p.q, p.t) for p in eng.trajectory]

    engines = {pkg: _spy(monkeypatch, cls, "optimize_map", record)
               for pkg, cls in (("jax", JM.SlamEngine), ("torch", TM.SlamEngine))}
    j_out = _jax_main(monkeypatch, JODO, ["--frames", "3", "--out-dir", str(tmp_path / "j")])
    te, t_out = _port_main(TODO.main, ["--frames", "3", "--out-dir", str(tmp_path / "t")])
    je = engines["jax"][0]
    assert engines["torch"] == [te]
    assert len(te.trajectory) == 3 and len(te.map.keyframes) >= 2
    for (tq, tt), (jq, jt) in zip(before[id(te)], before[id(je)]):
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=0.05)
        np.testing.assert_allclose(np.abs(tq.numpy()), np.abs(np.asarray(jq)), rtol=0, atol=1e-5)
    _same_map(je, te, OPT_T_TOL, OPT_Q_TOL)

    def report(out):
        return dict(re.findall(r"^(ATE \(odometry only\)|keyframes|loop closures|"
                               r"keyframe ATE \(optimized\))\s*: ([\d.]+)", out, re.M))

    rj, rt = report(j_out), report(t_out)
    assert rj.keys() == rt.keys() and len(rt) == 4
    assert rt["keyframes"] == rj["keyframes"] and rt["loop closures"] == rj["loop closures"]
    assert abs(float(rt["ATE (odometry only)"]) - float(rj["ATE (odometry only)"])) <= 0.05
    assert abs(float(rt["keyframe ATE (optimized)"])
               - float(rj["keyframe ATE (optimized)"])) <= OPT_T_TOL
    assert _labels(t_out) == _labels(j_out)
    assert (tmp_path / "t" / "metrics.jsonl").exists()


@pytest.fixture
def small_port_frames(monkeypatch, small_configs):
    """The port's renderer and the engine's frame_to_landmarks at m 4096."""
    real_render, real_lms = TY.render_cloud, TM.frame_to_landmarks
    monkeypatch.setattr(TY, "render_cloud", lambda scene, pose: _small(
        real_lms(real_render(scene, pose))))
    monkeypatch.setattr(TM, "frame_to_landmarks", lambda cloud: _small(real_lms(cloud)))


def _service(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = TSVC.main(argv, device="cpu")
    return rc, out.getvalue(), err.getvalue()


def test_service_resume_equals_uninterrupted_run(tmp_path, small_port_frames):
    """A crash injected after frame 3 ends the run with code 2; the rerun
    resumes from the frame-2 snapshot, and its final snapshot (trajectory,
    keyframes, edges, closures, the last frame) equals an uninterrupted
    run's, bitwise, as do the reports."""
    run = ["--frames", "6", "--checkpoint-every", "2"]
    rc, out, err = _service([*run, "--fail-at", "3", "--state-dir", str(tmp_path / "a")])
    assert rc == 2 and "injected failure" in err
    assert out.splitlines()[0] == "fresh session" and "frame   3:" in out
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == ["snap_000002.npz"]
    rc, resumed, _ = _service([*run, "--state-dir", str(tmp_path / "a")])
    assert rc == 0
    assert resumed.splitlines()[0].startswith(
        f"resumed from {tmp_path / 'a' / 'snap_000002.npz'}: 2 frames, ")
    assert "frame   1:" not in resumed and "frame   2:" in resumed
    rc, whole, _ = _service([*run, "--state-dir", str(tmp_path / "b")])
    assert rc == 0
    with np.load(tmp_path / "a" / "snap_000006.npz") as a, \
            np.load(tmp_path / "b" / "snap_000006.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
    tail = [line for line in whole.splitlines() if line.startswith(("ATE:", "pose graph"))]
    assert len(tail) == 2 and tail == [line for line in resumed.splitlines()
                                       if line.startswith(("ATE:", "pose graph"))]
    # The frames after the snapshot print the same poses.
    assert [line[line.index("t ="):] for line in resumed.splitlines() if "  t = " in line] == \
        [line[line.index("t ="):] for line in whole.splitlines() if "  t = " in line][2:]


def test_service_refuses_orbax_before_any_frame(tmp_path):
    with pytest.raises(NotImplementedError, match="orbax"):
        _service(["--backend", "orbax", "--state-dir", str(tmp_path)])
    assert list(tmp_path.iterdir()) == []


def test_service_streams_recorded_frames(tmp_path, small_port_frames):
    """``--data-dir``: three clouds written by the port's frame_grabber
    stream through the native FrameSource, in file order, into the same
    trajectory as an engine fed those files directly, bitwise."""
    from icp_tpu_torch.runtime.native import read_cloud
    from icp_tpu_torch.slam.odometry import KeyframePolicy

    d = tmp_path / "rec"
    for s, pose in (("1", None), ("2", "5 0 10 0.01"), ("3", "10 0 20 0.02")):
        _port_main(TFG.main, ["-s", s, "--out-dir", str(d)] + (["--pose", *pose.split()]
                                                                if pose else []))
    rc, out, _ = _service(["--data-dir", str(d), "--state-dir", str(tmp_path / "s")])
    assert rc == 0
    assert re.search(r"^frames: 3   keyframes: \d+   loop closures: \d+   "
                     r"\(recorded data: no ground truth\)$", out, re.M), out
    eng = TM.SlamEngine(icp_tpu_torch.ICPParams(alpha=2e2),
                        icp_tpu_torch.ICPConfig(estimate_scale=False),
                        policy=KeyframePolicy(max_gap=3))
    for s in "123":
        eng.process_frame(torch.from_numpy(read_cloud(str(d / f"kg_pc8d_{s}.bin"))))
    with np.load(tmp_path / "s" / "snap_000003.npz") as snap:
        assert np.array_equal(snap["traj_t"], torch.stack([p.t for p in eng.trajectory]).numpy())
        assert np.array_equal(snap["traj_q"], torch.stack([p.q for p in eng.trajectory]).numpy())


def test_multichip_gloo_world_matches_jax(tmp_path, monkeypatch):
    """``multichip --cpu --dp 2 --m 1024 --n-r 16``: the port's gloo world
    of 2 ranks (every rank bitwise rank 0's, rank 0 alone reporting)
    against JAX's example on a (2, 1) mesh of virtual devices."""
    argv = ["--cpu", "--dp", "2", "--m", "1024", "--n-r", "16"]
    world = tmp_path / "world"
    results = launch_world({"mesh": (2, 1), "device": "cpu", "tasks": [
        dict(kind="call", name="multichip", fn=TMC.rank_task, argv=argv)]}, 2, world,
        timeout=120.0, init_timeout=60.0)
    outs = [r["tasks"]["multichip"]["out"] for r in results]
    assert all(torch.equal(outs[1][k], v) for k, v in outs[0].items())
    logs = [(world / f"rank{r}.log").read_text() for r in range(2)]
    assert "mesh: dp=2 mp=1 over 2 devices, 2 process(es)" in logs[0]
    assert re.search(r"^registered in k=\d+ iterations, [\d.]+ ms", logs[0], re.M)
    assert "T = [" in logs[0]
    assert not any(s in logs[1] for s in ("mesh:", "registered in", "T ="))

    # JAX's example, single-process over the virtual devices: no cluster
    # auto-detection.
    monkeypatch.setattr(JDIST, "initialize_multihost", lambda *a, **kw: None)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    runs, states = [], []
    real = JSH.make_sharded_register

    def spy(mesh, config):
        run = real(mesh, config)
        runs.append(run)

        def recorded(*a):
            states.append(run(*a))
            return states[-1]
        return recorded

    monkeypatch.setattr(JSH, "make_sharded_register", spy)
    j_out = _jax_main(monkeypatch, JMC, argv)
    assert j_out.splitlines()[0].startswith("mesh: dp=2 mp=1 over ")
    js = states[0]
    got = type("S", (), {k: v.numpy() for k, v in outs[0].items()})
    assert abs(int(got.k) - int(js.k)) <= 2 and max(int(got.k), int(js.k)) < 40
    fixed, moving = _synthetic_pair(1024)
    params = icp_tpu.ICPParams(alpha=2e2).as_f32()
    spread = np.zeros(3)
    for d in (np.inf, -np.inf):
        st = runs[0](jnp.asarray(fixed), jnp.asarray(np.nextafter(moving, np.float32(d))),
                     params)
        spread = np.maximum(spread, _diff(st, js))
    bars = np.maximum([0.01, 2e-4, 1e-5], 4 * spread)
    err = _diff(got, js)
    assert np.all(err <= bars), f"|dt|, dangle, |ds| {err}; reference spread {spread}; bars {bars}"
