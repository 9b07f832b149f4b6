"""``icp_tpu_torch.parallel.distributed`` and ``mesh``: joining the process
group from arguments and from torchrun's environment, idempotence, the
raise when a rendezvous given by arguments fails, the global mesh's shapes
and errors, each rank's rows; then the scenarios of
tests/test_multiprocess.py as gloo worlds of CPU ranks (dp only, dp 2 x mp
2, mp across the process boundary), held against the JAX package's
single-device ``register`` with that test's bars; and the guard that keeps
the ranks from compiling the CUDA kernels.

Worlds run through the port's per-rank entry (``parallel.dryrun``): one
torch thread a rank, a 60 s rendezvous and collective timeout, 120 s to
finish.
"""

import tests.torch_one_thread  # noqa: F401  (torch on one CPU thread)
import logging
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

import icp_tpu_torch as T
from icp_tpu_torch.kernels import native
from icp_tpu_torch.parallel import initialize_multihost, make_global_mesh, make_mesh
from icp_tpu_torch.parallel.distributed import local_shard
from icp_tpu_torch.parallel.dryrun import free_port, launch_world
from icp_tpu_torch.parallel.mesh import psum_pytree, shard_points
from icp_tpu_torch.sensors.synthetic import synthetic_pair
from tests import test_torch_rank_tasks as rank_tasks
from tests.test_multiprocess import _single

ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


@pytest.fixture
def clean_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_no_arguments_no_env_warns_and_goes_on_single_process(clean_env, caplog):
    with caplog.at_level(logging.WARNING, logger="icp_tpu_torch.distributed"):
        initialize_multihost(backend="gloo")
    assert "continuing single-process" in caplog.text
    assert dist.is_initialized() and dist.get_world_size() == 1
    group = dist.group.WORLD
    initialize_multihost(backend="gloo")  # idempotent: the same world
    assert dist.group.WORLD is group and dist.get_world_size() == 1

    mesh = make_global_mesh(device="cpu")
    assert mesh.shape == {"dp": 1, "mp": 1} and (mesh.dp_index, mesh.mp_index) == (0, 0)
    x = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(local_shard(x, mesh), x) and torch.equal(shard_points(mesh, x), x)
    tree = {"a": torch.ones(3), "b": (torch.zeros(2, 2),)}
    assert psum_pytree(tree, ("dp", "mp"), mesh) is tree  # a world of one moves nothing
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        make_global_mesh(n_dp=2, device="cpu")
    with pytest.raises(ValueError, match="1 devices not divisible by mp=2"):
        make_global_mesh(n_mp=2, device="cpu")
    with pytest.raises(ValueError, match="need 4 devices, have 1"):
        make_mesh(2, 2, "cpu")
    with pytest.raises(ValueError, match="unknown mesh axis"):
        mesh.psum(x, "tp")


@pytest.mark.parametrize("source", ["arguments", "environment"])
def test_joins_a_world_from_arguments_or_environment(clean_env, monkeypatch, source):
    """A world of one joined at a rendezvous address given by the arguments,
    or by torchrun's variables; a second call changes nothing."""
    port = free_port()
    if source == "arguments":
        initialize_multihost(f"localhost:{port}", 1, 0, backend="gloo", timeout_s=30)
    else:
        for name, value in zip(ENV, ("localhost", str(port), "1", "0")):
            monkeypatch.setenv(name, value)
        initialize_multihost(backend="gloo", timeout_s=30)
    assert dist.is_initialized() and (dist.get_world_size(), dist.get_rank()) == (1, 0)
    group = dist.group.WORLD
    initialize_multihost(f"localhost:{free_port()}", 2, 1, backend="gloo")
    assert dist.group.WORLD is group and dist.get_world_size() == 1


def test_address_without_world_or_rank_raises(clean_env):
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        initialize_multihost(f"localhost:{free_port()}", backend="gloo")
    with pytest.raises(ValueError, match="without a coordinator address"):
        initialize_multihost(num_processes=2, process_id=0, backend="gloo")
    assert not dist.is_initialized()


def test_failed_rendezvous_raises(clean_env):
    """Rank 1 of 2 at an address nobody serves: with arguments given, the
    failure raises (within the timeout) instead of going on alone."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError):
        initialize_multihost(f"localhost:{free_port()}", 2, 1, backend="gloo", timeout_s=3)
    assert time.monotonic() - t0 < 60
    assert not dist.is_initialized()


def test_make_mesh_needs_a_process_group(clean_env):
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(1, 1, "cpu")


def test_local_shard_rows_and_errors():
    """Each dp row of a mesh takes its block of rows (the process-major
    layout of the JAX package's make_global_mesh)."""
    a = np.arange(24, dtype=np.float32).reshape(12, 2)
    for dp in range(3):
        mesh = SimpleNamespace(shape={"dp": 3, "mp": 2}, dp_index=dp)
        np.testing.assert_array_equal(local_shard(a, mesh), a[4 * dp:4 * dp + 4])
    with pytest.raises(ValueError, match="must divide evenly over dp=3"):
        local_shard(a, SimpleNamespace(shape={"dp": 3}, dp_index=0), axis=1)
    mesh = SimpleNamespace(shape={"dp": 2}, dp_index=1)
    np.testing.assert_array_equal(local_shard(a, mesh, axis=1), a[:, 1:])


# tests/test_multiprocess.py's scenarios: name -> (variant, mesh, rotation
# bar, translation bar (mm)).
SCENARIOS = {
    "point_dp": ("point", (2, 1), 5e-4, 0.2),
    "point_dp2_mp2": ("point", (2, 2), 5e-4, 0.2),
    "plane_dp2_mp2": ("plane", (2, 2), 2e-3, 0.3),
    "gicp_mp_across": ("gicp", (1, 2), 2e-3, 0.3),
}


def _config(variant: str):
    base = dict(m=4096, n_r=64, correspondence=T.Correspondence.RBC,
                estimate_scale=False, max_iterations=20)
    return {"point": T.ICPConfig(rotation=T.RotationMode.POWER,
                                 weighting=T.Weighting.WEIGHTED, **base),
            "plane": T.ICPConfig(objective=T.Objective.PLANE, **base),
            "gicp": T.ICPConfig(objective=T.Objective.GICP, **base)}[variant]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """mesh -> every rank's results: the scenarios on that mesh, and each
    rank's rows of a 12-row array. The ranks find their rendezvous in
    torchrun's environment."""
    fixed, moving = map(torch.from_numpy, synthetic_pair(4096, seed=7))
    params = T.ICPParams(alpha=2e2, angle_threshold_deg=0.0, translation_threshold=0.0)
    rows = torch.arange(24.0).reshape(12, 2)
    out = {}
    for mesh in ((2, 1), (2, 2), (1, 2)):
        tasks = [dict(kind="register", name=name, config=_config(variant), params=params,
                      fixed=fixed, moving=moving)
                 for name, (variant, m, _, _) in SCENARIOS.items() if m == mesh]
        tasks.append(dict(kind="call", fn=rank_tasks.shard, name="shard", x=rows))
        out[mesh] = launch_world({"mesh": mesh, "device": "cpu", "tasks": tasks},
                                 mesh[0] * mesh[1], tmp_path_factory.mktemp("world"),
                                 timeout=120.0, init_timeout=60.0)
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_world_matches_single_device(worlds, name):
    """Every rank computed the same replicated result, 20 steps, within
    tests/test_multiprocess.py's bars of JAX's single-device register."""
    variant, mesh, rot_bar, t_bar = SCENARIOS[name]
    results = worlds[mesh]
    outs = [r["tasks"][name]["out"] for r in results]
    for o in outs[1:]:
        assert all(torch.equal(o[k], outs[0][k]) for k in outs[0])
    assert [int(o["k"]) for o in outs] == [20] * len(outs)
    T_port = torch.cat([outs[0]["q"], outs[0]["t"], outs[0]["s"].reshape(1)]).numpy()
    T_single = _single(variant)
    np.testing.assert_allclose(T_port[:4], T_single[:4], atol=rot_bar)
    np.testing.assert_allclose(T_port[4:7], T_single[4:7], atol=t_bar)


@pytest.mark.parametrize("mesh", [(2, 1), (2, 2), (1, 2)])
def test_world_ranks_rows_and_coordinates(worlds, mesh):
    """Rank r sits at divmod(r, n_mp) and holds its dp row's block of rows
    (local_shard and shard_points agree)."""
    rows = torch.arange(24.0).reshape(12, 2)
    per = 12 // mesh[0]
    for r, res in enumerate(worlds[mesh]):
        assert res["rank"] == r and res["coords"] == divmod(r, mesh[1])
        dp = res["coords"][0]
        out = res["tasks"]["shard"]["out"]
        assert torch.equal(out["local_shard"], rows[dp * per:(dp + 1) * per])
        assert torch.equal(out["shard_points"], out["local_shard"])


def test_rank_never_builds_the_kernels(tmp_path):
    """A rank of a world loads the kernel library that its launching process
    built, or raises; it never runs the compiler (concurrent builds into one
    directory would race)."""
    try:
        launch_world({"mesh": (1, 1), "device": "cpu",
                      "tasks": [dict(kind="call", fn=rank_tasks.load_kernels, name="load")]},
                     1, tmp_path, timeout=120.0, init_timeout=60.0)
    except RuntimeError as e:
        assert "may not build it" in str(e), str(e)[-2000:]
        assert "nvcc" not in str(e)
    else:  # a library built earlier on this machine: the rank loaded it
        assert (tmp_path / "rank0.pt").exists()


def test_forbid_build_raises_instead_of_compiling(tmp_path, monkeypatch):
    """After forbid_build, a missing library raises and nothing compiles."""
    calls = []
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native, "_build", lambda *a: calls.append(a))
    monkeypatch.setattr(native, "_build_allowed", True)
    native.load_library.cache_clear()
    try:
        native.forbid_build()
        with pytest.raises(RuntimeError, match="may not build it"):
            native.load_library()
    finally:
        native.load_library.cache_clear()
    assert calls == []
    assert not any(tmp_path.iterdir())
