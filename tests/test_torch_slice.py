"""The port's slice as a whole: ``icp_tpu_torch.register`` against
``icp_tpu.register`` on the benchmark's pair, the chunked loop against the
step-by-step loop, and the package's import hygiene."""

import tests.torch_one_thread  # noqa: F401  (torch on one CPU thread)
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import icp_tpu
import icp_tpu_torch
from __graft_entry__ import _synthetic_pair
from icp_tpu.icp.quaternion import qangle_deg, qconj, qmul
from icp_tpu_torch.icp import run as TRUN
from icp_tpu_torch.icp.quaternion import qangle_deg as t_qangle_deg
from icp_tpu_torch.icp.state import identity_state
from icp_tpu_torch.icp.step import icp_step

ROOT = Path(__file__).resolve().parent.parent
T_GT = np.array([8.0, -5.0, 3.0])  # _synthetic_pair's ground truth, any seed
Q_GT = np.array([0.0, 0.0, np.sin(0.01), np.cos(0.01)], np.float32)


def test_register_matches_jax_on_benchmark_pair():
    """m=4096, n_r=64 on _synthetic_pair(4096), the benchmark's alpha=2e2.

    After convergence each float32 step moves t by up to ~0.01 mm, the
    translation threshold itself (the scale solve sqrt(S[9]/S[10]) carries
    ~5e-6 of rounding, times |mean_m| ~ 1500 mm), so the step at which the
    loop stops is decided by rounding: by the order in which the host's
    vector code sums. On one host the port stops at k 6 with ATen's default
    capability and at k 8 with AVX2 or AVX-512, where JAX stops at 6. So the
    converged k are held within 2 steps of each other, both below the cap,
    and the states are compared where both packages run the same steps:
    with thresholds 0 for a fixed 6 and a fixed 8 steps, the angle within
    2e-4 deg and the scale within 1e-5 (the reference's own spread: its
    eager step-by-step loop and its jitted loop end 0.0047 mm apart on this
    pair), and t within max(0.01 mm, 4 x the reference's own one-ulp
    spread): JAX's t at the same steps with ``moving`` moved one float32
    ulp up, then down. On one host that spread is 0.0053 mm at 6 steps and
    0.0095 mm at 8, where the port's gap to JAX is 0.0069 / 0.0127 mm on one
    thread and 0.0008 / 0.0089 mm on four. Both land on the ground truth, as
    the reference does (0.0069 mm).
    """
    m, n_r = 4096, 64
    fixed, moving = _synthetic_pair(m)

    def jax_register(moving, max_iterations, **thresholds):
        return icp_tpu.register(jnp.asarray(fixed), jnp.asarray(moving),
                                icp_tpu.ICPParams(alpha=2e2, **thresholds).as_f32(),
                                icp_tpu.ICPConfig(m=m, n_r=n_r, max_iterations=max_iterations))

    def both(max_iterations=40, **thresholds):
        js = jax_register(moving, max_iterations, **thresholds)
        ts = icp_tpu_torch.register(torch.from_numpy(fixed), torch.from_numpy(moving),
                                    icp_tpu_torch.ICPParams(alpha=2e2, **thresholds),
                                    icp_tpu_torch.ICPConfig(m=m, n_r=n_r,
                                                            max_iterations=max_iterations))
        return js, ts

    js, ts = both()
    assert abs(int(js.k) - int(ts.k)) <= 2, (int(js.k), int(ts.k))
    assert max(int(js.k), int(ts.k)) < 40, (int(js.k), int(ts.k))
    # Both land on the ground truth, as the reference does (0.0069 mm).
    assert np.linalg.norm(ts.t.numpy() - T_GT) < 0.02
    assert float(qangle_deg(qmul(jnp.asarray(ts.q.numpy()),
                                 qconj(jnp.asarray(Q_GT))))) < 0.001
    for steps in (6, 8):
        fixed_steps = dict(angle_threshold_deg=0.0, translation_threshold=0.0)
        js, ts = both(steps, **fixed_steps)
        assert int(js.k) == int(ts.k) == steps
        spread = max(float(np.linalg.norm(
            np.asarray(jax_register(np.nextafter(moving, np.float32(d)), steps,
                                    **fixed_steps).t) - np.asarray(js.t)))
            for d in (np.inf, -np.inf))
        gap = float(np.linalg.norm(ts.t.numpy() - np.asarray(js.t)))
        assert gap <= max(0.01, 4 * spread), (steps, gap, spread)
        assert float(qangle_deg(qmul(jnp.asarray(ts.q.numpy()), qconj(js.q)))) <= 2e-4, steps
        assert abs(float(ts.s) - float(js.s)) <= 1e-5, steps


def _step_by_step(moving, index, params, config):
    """The JAX package's while_loop, one host-side step at a time."""
    state = identity_state()
    done = False
    while state.k < config.max_iterations and (state.k == 0 or not done):
        state = icp_step(state, moving, index, params, config)
        done = bool(TRUN.converged(state, params))
    return state


@pytest.mark.parametrize("max_iterations, thresholds", [
    (40, (0.001, 0.01)),   # converges inside a chunk
    (5, (0.0, 0.0)),       # stops mid-chunk at the cap
    (8, (0.0, 0.0)),       # stops at a chunk boundary
    (11, (0.0, 0.0)),
    (40, (1e9, 1e9)),      # converged after the first step: k == 1
])
def test_chunked_loop_equals_step_by_step(max_iterations, thresholds):
    m, n_r = 1024, 16
    fixed, moving = map(torch.from_numpy, _synthetic_pair(m, seed=3))
    params = icp_tpu_torch.ICPParams(alpha=2e2, angle_threshold_deg=thresholds[0],
                                     translation_threshold=thresholds[1]).to("cpu")
    config = icp_tpu_torch.ICPConfig(m=m, n_r=n_r, max_iterations=max_iterations)
    index = TRUN.build_index(fixed, params, config)
    want = _step_by_step(moving, index, params, config)
    got = TRUN.icp_run(moving, index, params, config)
    for name in ("q", "t", "s", "qk", "tk", "sk", "k"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    if thresholds[0] == 0.0:
        assert int(got.k) == max_iterations
    if thresholds[0] > 1.0:
        assert int(got.k) == 1


def test_converged_matches_jax():
    from icp_tpu.icp.run import converged as j_converged
    from icp_tpu.icp.state import identity_state as j_identity

    params_j = icp_tpu.ICPParams().as_f32()
    params_t = icp_tpu_torch.ICPParams().to("cpu")
    for ang, tk in [(0.0005, 0.005), (0.0005, 0.02), (0.002, 0.005)]:
        half = np.radians(ang) / 2
        qk = np.array([np.sin(half), 0, 0, np.cos(half)], np.float32)
        tkv = np.array([tk, 0, 0], np.float32)
        js = j_identity()._replace(qk=jnp.asarray(qk), tk=jnp.asarray(tkv))
        ts = identity_state()
        ts.qk, ts.tk = torch.from_numpy(qk), torch.from_numpy(tkv)
        assert bool(TRUN.converged(ts, params_t)) == bool(j_converged(js, params_j))
        assert abs(float(t_qangle_deg(ts.qk)) - ang) < 1e-6


def test_identity_pair_stops_at_first_step():
    fixed, _ = _synthetic_pair(1024)
    f = torch.from_numpy(fixed)
    st = icp_tpu_torch.register(f, f.clone(), icp_tpu_torch.ICPParams(alpha=2e2),
                                icp_tpu_torch.ICPConfig(m=1024, n_r=16))
    assert int(st.k) == 1
    assert float(torch.linalg.vector_norm(st.t)) < 1e-2
    assert float(t_qangle_deg(st.q)) < 1e-3


def test_register_rejects_bad_inputs():
    x = torch.zeros(64, 8)
    cfg = icp_tpu_torch.ICPConfig(m=64, n_r=4)
    with pytest.raises(ValueError):
        icp_tpu_torch.register(x.double(), x.double(), icp_tpu_torch.ICPParams(), cfg)
    with pytest.raises(ValueError):
        icp_tpu_torch.register(x[:, :7], x[:, :7], icp_tpu_torch.ICPParams(), cfg)


_HYGIENE = """
import json, sys
import numpy as np, torch
import icp_tpu_torch as T
import icp_tpu_torch.viz
matplotlib = sorted(m for m in sys.modules if m.split(".")[0] == "matplotlib")
from icp_tpu_torch.examples import (frame_grabber, multichip, odometry, odometry_service,
                                    registration, step_by_step)
from icp_tpu_torch.kernels import native
from icp_tpu_torch.parallel import distributed, dryrun, mesh, sharded
from icp_tpu_torch.slam import bundle_adjustment, pose_graph
from icp_tpu_torch.sensors import synthetic
rng = np.random.default_rng(0)
f = np.ones((256, 8), np.float32)
f[:, :3] = rng.uniform(-300, 300, (256, 3)); f[:, 2] += 1500
ks = []
for cfg in (T.ICPConfig(m=256, n_r=16),
            T.ICPConfig(m=256, n_r=16, robust=T.RobustKernel.HUBER, robust_adaptive=True),
            T.ICPConfig(m=256, n_r=16, objective=T.Objective.GICP, estimate_scale=False)):
    st = T.register(torch.from_numpy(f), torch.from_numpy(f.copy()), T.ICPParams(), cfg)
    ks.append(int(st.k))
synthetic.render(synthetic.wall_scene(device="cpu"), synthetic.CameraPose.identity(device="cpu"))
print(json.dumps({
    "k": min(ks),
    "modules": sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "icp_tpu", "__graft_entry__")),
    "tf32": [torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32],
    "precision": torch.get_float32_matmul_precision(),
    "launches": native.launches(),
    "loader": native.load_library.cache_info().currsize,
    "matplotlib": matplotlib,
}))
"""


@pytest.fixture(scope="module")
def hygiene():
    out = subprocess.run([sys.executable, "-c", _HYGIENE], cwd=ROOT,
                         capture_output=True, text=True, check=True, timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_never_imports_jax_or_icp_tpu(hygiene):
    assert hygiene["k"] >= 1
    assert hygiene["modules"] == []


def test_import_turns_tf32_off(hygiene):
    assert hygiene["tf32"] == [False, False]
    assert hygiene["precision"] == "highest"


def test_cpu_run_never_launches_or_loads_kernels(hygiene):
    assert hygiene["launches"] == {}
    assert hygiene["loader"] == 0


def test_viz_import_leaves_matplotlib_out(hygiene):
    """matplotlib is imported by the first plot call, not by the package:
    the card's machine has none."""
    assert hygiene["matplotlib"] == []


# Each subpackage as the first import of a fresh interpreter: the package
# exports could close the cycles kernels.fused_step -> ops.distance ->
# ops/__init__ -> ops.normals -> kernels.knn_moments -> kernels.fused_step
# and ops.normals -> rbc.grouping -> rbc/__init__ -> rbc.construct ->
# kernels.fused_gn -> kernels.fused_step.
FIRST_IMPORTS = ["icp_tpu_torch." + m for m in (
    "ops", "rbc", "kernels", "icp", "slam", "sensors", "runtime", "parallel", "viz",
    "examples", "interop")]


@pytest.fixture(scope="module")
def first_imports():
    """module -> (exit code, stderr) of ``import module`` in a fresh
    interpreter, all started at once."""
    procs = {m: subprocess.Popen([sys.executable, "-c", f"import {m}"], cwd=ROOT,
                                 stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
             for m in FIRST_IMPORTS}
    return {m: (p.communicate(timeout=300)[1], p.returncode)[::-1] for m, p in procs.items()}


@pytest.mark.parametrize("module", FIRST_IMPORTS)
def test_module_imports_first_in_a_fresh_interpreter(first_imports, module):
    rc, err = first_imports[module]
    assert rc == 0, err
