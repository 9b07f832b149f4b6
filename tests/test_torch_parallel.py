"""``icp_tpu_torch.parallel.make_sharded_register`` on gloo worlds of CPU
ranks, against ``icp_tpu.parallel.sharded.make_sharded_register`` on the
same mesh shape over the conftest's 8 virtual CPU devices and against the
port's own single-device ``register``, mirroring tests/test_sharded.py on
its pair (``_make_pair(rng 11, 4096, angle 0.03, trans 12)``, m 4096,
n_r 64).

Each mesh shape, (4, 1), (2, 2) and (1, 4), is one world of 4 ranks
launched through the port's per-rank entry (``parallel.dryrun``): one torch
thread a rank, a 60 s rendezvous and collective timeout, 120 s for the
world to finish. The world runs every variant to convergence (the same
variants for a fixed 8 steps are in tests/test_torch_parallel_steps.py).
Variants: POINT (POWER + WEIGHTED), PLANE, GICP, BRUTE (SVD + REGULAR) and
PLANE + TRIMMED with the adaptive scale (the distributed median).

Tolerances:
- against JAX converged: k within 2 of each other and below the cap (after
  convergence each float32 step moves t by up to the 0.01 mm threshold, so
  the stopping step is decided by rounding); the state within the larger of
  the slice's tolerances and four times the reference's own spread, JAX's
  sharded run with the moving set moved one float32 ulp up, then down;
- against the port's ``register``: the JAX tests' sharded-vs-single bars,
  POINT and BRUTE 5e-3 deg and 0.1 mm, PLANE, GICP and robust 0.02 deg and
  0.3 mm; every variant within ``_check``'s ground-truth bars;
- every rank's state ``torch.equal`` to rank 0's.
"""

import tests.torch_one_thread  # noqa: F401  (torch on one CPU thread)
from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import icp_tpu
import icp_tpu_torch as T
from icp_tpu.icp.quaternion import qangle_deg, qconj, qmul
from icp_tpu.parallel.mesh import make_mesh as j_make_mesh
from icp_tpu.parallel.sharded import make_sharded_register as j_make_sharded_register
from icp_tpu_torch.parallel import make_sharded_register
from icp_tpu_torch.parallel.dryrun import launch_world
from icp_tpu_torch.parallel.sharded import sharded_query_capacity
from tests.test_icp_e2e import _make_pair

MESHES = [(4, 1), (2, 2), (1, 4)]
VARIANTS = ("point", "plane", "gicp", "brute", "robust")
FIELDS = ("q", "t", "s", "qk", "tk", "sk", "k")
SINGLE_BARS = {"point": (0.1, 5e-3), "brute": (0.1, 5e-3)}  # mm, deg; else (0.3, 0.02)


def _variants(pkg, max_iterations):
    """name -> (config, ICPParams kwargs) of tests/test_sharded.py's cases."""
    kw = dict(m=4096, n_r=64, max_iterations=max_iterations)
    return {
        "point": (pkg.ICPConfig(rotation=pkg.RotationMode.POWER,
                                weighting=pkg.Weighting.WEIGHTED,
                                correspondence=pkg.Correspondence.RBC, **kw), {"alpha": 2e2}),
        "plane": (pkg.ICPConfig(objective=pkg.Objective.PLANE, estimate_scale=False, **kw),
                  {"alpha": 2e2}),
        "gicp": (pkg.ICPConfig(objective=pkg.Objective.GICP, estimate_scale=False, **kw),
                 {"alpha": 2e2}),
        "brute": (pkg.ICPConfig(rotation=pkg.RotationMode.SVD, weighting=pkg.Weighting.REGULAR,
                                correspondence=pkg.Correspondence.BRUTE, **kw), {}),
        "robust": (pkg.ICPConfig(objective=pkg.Objective.PLANE, estimate_scale=False,
                                 weighting=pkg.Weighting.REGULAR,
                                 robust=pkg.RobustKernel.TRIMMED, robust_adaptive=True, **kw),
                   {"alpha": 2e2}),
    }


@pytest.fixture(scope="module")
def pair():
    fixed, moving, q_true, t_true = _make_pair(np.random.default_rng(11), 4096, angle=0.03,
                                               trans=12.0)
    return np.array(fixed), np.array(moving), q_true, t_true


def run_worlds(tasks, tmp_path_factory) -> dict:
    """mesh -> every rank's results of one world of 4 ranks running ``tasks``."""
    return {mesh: launch_world({"mesh": mesh, "device": "cpu", "tasks": tasks},
                               mesh[0] * mesh[1], tmp_path_factory.mktemp("world"),
                               timeout=120.0, init_timeout=60.0)
            for mesh in MESHES}


@pytest.fixture(scope="module")
def worlds(pair, tmp_path_factory):
    """mesh -> every rank's results, each variant run to convergence."""
    fixed, moving = torch.from_numpy(pair[0]), torch.from_numpy(pair[1])
    return run_worlds([dict(kind="register", name=name, config=config,
                            params=T.ICPParams(**p), fixed=fixed, moving=moving)
                       for name, (config, p) in _variants(T, 40).items()], tmp_path_factory)


@pytest.fixture(scope="module")
def jax_runs(pair):
    """(mesh, name) -> (JAX's sharded state, spread), the spread being
    (|dt| mm, dangle deg, |ds|) of the same run with the moving set moved one
    float32 ulp up, then down (the largest of the two)."""
    fixed, moving = pair[0], pair[1]
    out = {}
    for mesh in MESHES:
        jm = j_make_mesh(*mesh)
        for name, (config, p) in _variants(icp_tpu, 40).items():
            run = j_make_sharded_register(jm, config)
            prm = icp_tpu.ICPParams(**p).as_f32()
            base = run(jnp.asarray(fixed), jnp.asarray(moving), prm)
            spread = np.zeros(3)
            for d in (np.inf, -np.inf):
                st = run(jnp.asarray(fixed), jnp.asarray(np.nextafter(moving, np.float32(d))),
                         prm)
                spread = np.maximum(spread, diff(st, base))
            out[mesh, name] = (base, spread)
    return out


def diff(a, b) -> np.ndarray:
    """(|t_a - t_b| mm, angle between q_a and q_b in deg, |s_a - s_b|)."""
    dt = np.linalg.norm(np.asarray(a.t, np.float64) - np.asarray(b.t, np.float64))
    da = float(qangle_deg(qmul(jnp.asarray(np.asarray(a.q)), qconj(jnp.asarray(np.asarray(b.q))))))
    return np.array([dt, da, abs(float(a.s) - float(b.s))])


def state(out: dict):
    return SimpleNamespace(**{k: out[k].numpy() for k in FIELDS})


@pytest.mark.parametrize("mesh", MESHES)
def test_every_rank_ends_bitwise_equal(worlds, mesh):
    results = worlds[mesh]
    assert [r["coords"] for r in results] == [divmod(r, mesh[1]) for r in range(4)]
    for task, res0 in results[0]["tasks"].items():
        for r in results[1:]:
            for k, v in res0["out"].items():
                assert torch.equal(r["tasks"][task]["out"][k], v), (r["rank"], task, k)


@pytest.mark.parametrize("mesh", MESHES)
def test_cpu_world_launches_no_kernel(worlds, mesh):
    """On the CPU every wrapper takes its plain twin."""
    for r in worlds[mesh]:
        for task in r["tasks"].values():
            assert not any(task["launches"].values()), task["launches"]


@pytest.mark.parametrize("name", VARIANTS)
@pytest.mark.parametrize("mesh", MESHES)
def test_converged_matches_jax(worlds, jax_runs, mesh, name):
    got = state(worlds[mesh][0]["tasks"][name]["out"])
    want, spread = jax_runs[mesh, name]
    assert abs(int(got.k) - int(want.k)) <= 2, (int(got.k), int(want.k))
    assert max(int(got.k), int(want.k)) < 40
    bars = np.maximum([0.01, 2e-4, 1e-5], 4 * spread)
    err = diff(got, want)
    assert np.all(err <= bars), f"|dt|, dangle, |ds| {err}; reference spread {spread}; bars {bars}"


@pytest.fixture(scope="module")
def singles(pair):
    """name -> the port's single-device register of the pair."""
    fixed, moving = torch.from_numpy(pair[0]), torch.from_numpy(pair[1])
    return {name: T.register(fixed, moving, T.ICPParams(**p), config)
            for name, (config, p) in _variants(T, 40).items()}


@pytest.mark.parametrize("name", VARIANTS)
@pytest.mark.parametrize("mesh", MESHES)
def test_matches_single_device_and_truth(worlds, singles, pair, mesh, name):
    got = worlds[mesh][0]["tasks"][name]["out"]
    single = singles[name]
    t_bar, a_bar = SINGLE_BARS.get(name, (0.3, 0.02))
    dt, da, _ = diff(state(got), single)
    assert da < a_bar and dt <= t_bar, (dt, da)
    # tests/test_sharded.py's _check.
    q_true, t_true = pair[2], pair[3]
    q_err = qmul(jnp.asarray(got["q"].numpy()), qconj(jnp.asarray(q_true)))
    assert float(qangle_deg(q_err)) < 0.1
    np.testing.assert_allclose(got["t"].numpy(), t_true, atol=1.5)
    assert abs(float(got["s"]) - 1.0) < 2e-3


def test_make_sharded_register_rejects_uneven_splits():
    """The JAX package's ValueErrors, before any rank computes."""
    mesh = SimpleNamespace(shape={"dp": 3, "mp": 1})
    with pytest.raises(ValueError, match="m must divide evenly over the dp axis"):
        make_sharded_register(mesh, T.ICPConfig(m=4096, n_r=64))
    mesh = SimpleNamespace(shape={"dp": 1, "mp": 3})
    with pytest.raises(ValueError, match="n_r must divide evenly over the mp axis"):
        make_sharded_register(mesh, T.ICPConfig(m=4096, n_r=64))


@pytest.mark.parametrize("n_dp", [1, 2, 4, 8])
@pytest.mark.parametrize("m, n_r", [(4096, 64), (16384, 256), (1024, 16)])
def test_sharded_query_capacity_formula(m, n_r, n_dp):
    """The JAX package's per-rank capacity (icp_tpu/parallel/sharded.py:
    396-416): the single-device capacity over n_dp, floored at
    mu + 4 sqrt(mu) queries a bin, 8-aligned; n_dp 1 keeps the single-device
    capacity."""
    config = T.ICPConfig(m=m, n_r=n_r)
    mu = max((m // n_dp) // n_r, 1)
    cap = max(-(-config.query_capacity // n_dp), mu + int(4 * mu ** 0.5))
    want = max(-(-cap // 8) * 8, 8)
    assert sharded_query_capacity(config, n_dp) == want
    if n_dp == 1:
        assert want == max(-(-config.query_capacity // 8) * 8, 8)
