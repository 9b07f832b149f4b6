"""``icp_tpu_torch.register_batch`` against its own single ``register`` and
against ``icp_tpu.register_batch``, on the JAX test's three configurations
(tests/test_register_batch.py: m 1024, n_r 16; POINT, BRUTE POINT, PLANE).

Tolerances: each lane equals the port's ``register`` of its pair bitwise,
``k`` included (torch pinned to one thread, so the float32 sums run in one
order). Against JAX's lane: ``k`` equal, t within 0.01 mm, the angle
between the rotations within 2e-4 deg and the scale within 1e-5, the slice
tolerances of tests/test_torch_slice.py: after convergence each float32
step moves t by up to ~0.01 mm, so the last 0.01 mm depends on summation
order.
"""

import tests.torch_one_thread  # noqa: F401  (torch on one CPU thread)
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import icp_tpu
import icp_tpu_torch
from icp_tpu.icp.quaternion import qangle_deg, qconj, qmul
from icp_tpu_torch.icp import run as TRUN
from tests.test_icp_e2e import _make_pair

B, M = 3, 1024
FIELDS = ("q", "t", "s", "qk", "tk", "sk", "k")
CONFIGS = {
    "point": dict(m=M, n_r=16, estimate_scale=False),
    "brute": dict(m=M, n_r=16, correspondence="brute", estimate_scale=False),
    "plane": dict(m=M, n_r=16, objective="plane", estimate_scale=False),
}


def _configs(name):
    d = CONFIGS[name]
    enums = {"correspondence": (icp_tpu.Correspondence, icp_tpu_torch.Correspondence),
             "objective": (icp_tpu.Objective, icp_tpu_torch.Objective)}
    jd = {k: enums[k][0](v) if k in enums else v for k, v in d.items()}
    td = {k: enums[k][1](v) if k in enums else v for k, v in d.items()}
    return icp_tpu.ICPConfig(**jd), icp_tpu_torch.ICPConfig(**td)


def _batch(seed):
    """The JAX test's batch: pair i turned by up to 0.01 (i + 1) rad and
    moved by ~5 (i + 1) mm, as numpy arrays."""
    rng = np.random.default_rng(seed)
    pairs = [_make_pair(rng, M, angle=0.01 * (i + 1), trans=5.0 * (i + 1)) for i in range(B)]
    return (np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]),
            [p[2] for p in pairs], [p[3] for p in pairs])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_register_batch_lanes_equal_single_register(name):
    _, config = _configs(name)
    fixed, moving, _, _ = _batch(42)
    params = icp_tpu_torch.ICPParams(alpha=2e2)
    batch = icp_tpu_torch.register_batch(torch.from_numpy(fixed), torch.from_numpy(moving),
                                         params, config)
    for f in FIELDS:
        assert getattr(batch, f).shape[0] == B, f
    for i in range(B):
        single = icp_tpu_torch.register(torch.from_numpy(fixed[i]), torch.from_numpy(moving[i]),
                                        params, config)
        for f in FIELDS:
            assert torch.equal(getattr(batch, f)[i], getattr(single, f)), (i, f)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_register_batch_matches_jax(name):
    jconfig, config = _configs(name)
    fixed, moving, qs, ts = _batch(42)
    jb = icp_tpu.register_batch(jnp.asarray(fixed), jnp.asarray(moving),
                                icp_tpu.ICPParams(alpha=2e2).as_f32(), jconfig)
    tb = icp_tpu_torch.register_batch(torch.from_numpy(fixed), torch.from_numpy(moving),
                                      icp_tpu_torch.ICPParams(alpha=2e2), config)
    for i in range(B):
        assert int(tb.k[i]) == int(jb.k[i]), i
        assert np.linalg.norm(tb.t[i].numpy() - np.asarray(jb.t[i])) <= 0.01, i
        assert float(qangle_deg(qmul(jnp.asarray(tb.q[i].numpy()), qconj(jb.q[i])))) <= 2e-4
        assert abs(float(tb.s[i]) - float(jb.s[i])) <= 1e-5
        # Each lane recovers its own ground truth (the JAX test's bounds).
        assert float(qangle_deg(qmul(jnp.asarray(tb.q[i].numpy()),
                                     qconj(jnp.asarray(qs[i]))))) < 0.1
        np.testing.assert_allclose(tb.t[i].numpy(), ts[i], atol=1.0)


def test_register_batch_runs_one_loop_over_all_lanes(monkeypatch):
    """Every chunk steps every lane, frozen or not, and the loop ends with
    the chunk in which the last lane stopped: B * CHUNK * ceil(max k / CHUNK)
    steps, with lanes that stop at different k."""
    _, config = _configs("point")
    fixed, moving, _, _ = _batch(7)
    steps = []
    real = TRUN.icp_step
    monkeypatch.setattr(TRUN, "icp_step", lambda *a, **kw: steps.append(1) or real(*a, **kw))
    batch = icp_tpu_torch.register_batch(torch.from_numpy(fixed), torch.from_numpy(moving),
                                         icp_tpu_torch.ICPParams(alpha=2e2), config)
    ks = [int(k) for k in batch.k]
    assert len(set(ks)) > 1, ks
    assert len(steps) == B * TRUN.CHUNK * math.ceil(max(ks) / TRUN.CHUNK)


def test_register_batch_rejects_bad_shapes():
    config = icp_tpu_torch.ICPConfig(m=64, n_r=16)
    params = icp_tpu_torch.ICPParams()
    x = torch.zeros((2, 64, 8))
    for fixed, moving in ((x[0], x[0]), (x, x[:1]), (x.double(), x), (x[:0], x[:0])):
        with pytest.raises(ValueError):
            icp_tpu_torch.register_batch(fixed, moving, params, config)
