"""``icp_tpu_torch.parallel.make_sharded_register`` against
``icp_tpu.parallel.sharded.make_sharded_register`` where both run the same
steps: thresholds 0 and a fixed 8 steps, on tests/test_sharded.py's pair
and variants (see tests/test_torch_parallel.py, which holds the converged
runs), one gloo world of 4 CPU ranks per mesh shape (4, 1), (2, 2) and
(1, 4).

Below the float32 floor at convergence the states are well determined, so
they are held to the slice's tolerances (tests/test_torch_slice.py): t
within 0.01 mm, the angle within 2e-4 deg, the scale within 1e-5; every
rank's state ``torch.equal`` to rank 0's.
"""

import jax.numpy as jnp
import pytest
import torch

import icp_tpu
import icp_tpu_torch as T
from icp_tpu.parallel.mesh import make_mesh as j_make_mesh
from icp_tpu.parallel.sharded import make_sharded_register as j_make_sharded_register
from tests.test_torch_parallel import MESHES, VARIANTS, _variants, diff, pair, run_worlds, state

STEPS = 8
ZERO = dict(angle_threshold_deg=0.0, translation_threshold=0.0)
__all__ = ["pair"]  # the module fixture, shared with tests/test_torch_parallel.py


@pytest.fixture(scope="module")
def worlds(pair, tmp_path_factory):
    fixed, moving = torch.from_numpy(pair[0]), torch.from_numpy(pair[1])
    return run_worlds([dict(kind="register", name=name, config=config,
                            params=T.ICPParams(**p, **ZERO), fixed=fixed, moving=moving)
                       for name, (config, p) in _variants(T, STEPS).items()],
                      tmp_path_factory)


@pytest.fixture(scope="module")
def jax_runs(pair):
    return {(mesh, name): j_make_sharded_register(j_make_mesh(*mesh), config)(
                jnp.asarray(pair[0]), jnp.asarray(pair[1]),
                icp_tpu.ICPParams(**p, **ZERO).as_f32())
            for mesh in MESHES for name, (config, p) in _variants(icp_tpu, STEPS).items()}


@pytest.mark.parametrize("mesh", MESHES)
def test_every_rank_ends_bitwise_equal(worlds, mesh):
    results = worlds[mesh]
    for task, res0 in results[0]["tasks"].items():
        for r in results[1:]:
            for k, v in res0["out"].items():
                assert torch.equal(r["tasks"][task]["out"][k], v), (r["rank"], task, k)


@pytest.mark.parametrize("name", VARIANTS)
@pytest.mark.parametrize("mesh", MESHES)
def test_fixed_steps_match_jax(worlds, jax_runs, mesh, name):
    got = state(worlds[mesh][0]["tasks"][name]["out"])
    want = jax_runs[mesh, name]
    assert int(got.k) == int(want.k) == STEPS
    dt, da, ds = diff(got, want)
    assert dt <= 0.01 and da <= 2e-4 and ds <= 1e-5, (dt, da, ds)
