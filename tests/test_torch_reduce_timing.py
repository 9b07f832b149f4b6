"""The port's reductions, timing helpers, representative grid and
quaternion helpers against the JAX package, on the same seeded numpy
inputs.

Tolerances: ``reduce_min`` / ``reduce_max``, ``get_representatives`` and
``sample_representatives`` bitwise; ``reduce_sum`` bitwise on integer-valued float32 rows (every
partial sum exact, so no summation order can round), and within 2e-6 of
the row's sum of magnitudes on random rows, where the two libraries add in
different orders; ``reduce_sum_fd`` against numpy's float64 sum of the
float64 inputs to 1e-12 relative (it sums in native float64 and returns
float64). ``qaxis``, ``pack_T``, ``unpack_T``, ``transform_points_matrix``
and ``similarity_to_matrix`` within 1e-6 of JAX's, relative to each
output's largest entry (float32 rotations and products). The summary text
of ``ProfilingInfo`` equals JAX's.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from icp_tpu.icp import quaternion as JQ
from icp_tpu.ops import reduce as JR
from icp_tpu.ops import sampling as JS
from icp_tpu.ops.sampling import get_representatives as j_get_representatives
from icp_tpu.runtime import timing as JT
from icp_tpu_torch.icp import quaternion as TQ
from icp_tpu_torch.ops import reduce as TR
from icp_tpu_torch.ops import sampling as TS
from icp_tpu_torch.ops.sampling import get_representatives
from icp_tpu_torch.runtime import timing as TT
from tests.utils import make_cloud8, random_quat


def _rows(seed, shape=(7, 1000)):
    g = np.random.default_rng(seed)
    return (g.normal(size=shape) * 10.0 ** g.integers(-3, 4, size=shape)).astype(np.float32)


@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("name", ["reduce_min", "reduce_max"])
def test_reduce_min_max_bitwise(name, axis):
    x = _rows(0)
    x[2, 5] = np.inf
    x[3, 7] = -np.inf
    want = np.asarray(getattr(JR, name)(jnp.asarray(x), axis=axis))
    got = getattr(TR, name)(torch.from_numpy(x), axis=axis).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("axis", [-1, 0])
def test_reduce_sum(axis):
    ints = np.random.default_rng(1).integers(-1000, 1000, size=(7, 1000)).astype(np.float32)
    want = np.asarray(JR.reduce_sum(jnp.asarray(ints), axis=axis))
    got = TR.reduce_sum(torch.from_numpy(ints), axis=axis).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    x = _rows(2)
    want = np.asarray(JR.reduce_sum(jnp.asarray(x), axis=axis))
    got = TR.reduce_sum(torch.from_numpy(x), axis=axis).numpy()
    scale = np.sum(np.abs(x.astype(np.float64)), axis=axis)
    assert np.all(np.abs(got.astype(np.float64) - want) <= 2e-6 * scale)


@pytest.mark.parametrize("axis", [-1, 0])
def test_reduce_sum_fd_is_a_float64_sum(axis):
    """Near-equal weights plus a few large terms, where a float32 sum loses
    the low bits that the reference's double accumulation keeps."""
    g = np.random.default_rng(3)
    x = (1.0 + g.normal(size=(5, 16384)) * 1e-3).astype(np.float32)
    x[:, ::1000] = 3e4
    x = x if axis == -1 else x.T.copy()
    got = TR.reduce_sum_fd(torch.from_numpy(x), axis=axis)
    want = np.sum(x.astype(np.float64), axis=axis)
    assert got.dtype == torch.float64
    assert np.all(np.abs(got.numpy() - want) <= 1e-12 * np.abs(want))


@pytest.mark.parametrize("n_ry, n_rx", [(16, 16), (8, 16), (4, 4), (2, 8)])
def test_get_representatives_bitwise(n_ry, n_rx):
    lms = make_cloud8(np.random.default_rng(4), 128 * 128)
    want = np.asarray(j_get_representatives(jnp.asarray(lms), n_ry, n_rx))
    got = get_representatives(torch.from_numpy(lms), n_ry, n_rx).numpy()
    assert got.shape == (n_ry * n_rx, 8) and np.array_equal(got, want)


@pytest.mark.parametrize("n, n_r, grid", [(128 * 128, 256, None), (128 * 128, 128, (8, 16)),
                                          (64 * 64, 64, None), (5000, 64, None)])
def test_sample_representatives_bitwise(n, n_r, grid):
    """The organized grids (the 16384 landmarks, with and without an
    explicit (n_ry, n_rx), and a 64x64 one) and the 1-D rule of a set of
    another size."""
    pts = make_cloud8(np.random.default_rng(5), n)
    want = np.asarray(JS.sample_representatives(jnp.asarray(pts), n_r, grid))
    got = TS.sample_representatives(torch.from_numpy(pts), n_r, grid).numpy()
    assert got.shape == (n_r, 8) and np.array_equal(got, want)


def _close(got, want, tol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * max(np.max(np.abs(want)), 1.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quaternion_helpers_match_jax(seed):
    g = np.random.default_rng(seed)
    q = random_quat(g, 0.5)
    t = (g.normal(size=3) * 50).astype(np.float32)
    s = np.float32(1.0 + 0.01 * g.normal())
    pts = make_cloud8(g, 500)
    qt, tt, st = torch.from_numpy(q), torch.from_numpy(t), torch.tensor(s)
    _close(TQ.qaxis(qt), JQ.qaxis(jnp.asarray(q)))
    T_j = JQ.similarity_to_matrix(jnp.asarray(q), jnp.asarray(t), jnp.float32(s))
    T_t = TQ.similarity_to_matrix(qt, tt, st)
    _close(T_t, T_j)
    _close(TQ.transform_points_matrix(torch.from_numpy(pts), T_t),
           JQ.transform_points_matrix(jnp.asarray(pts), T_j))
    # The matrix form equals the quaternion form.
    _close(TQ.transform_points_matrix(torch.from_numpy(pts), T_t),
           TQ.transform_points(torch.from_numpy(pts), qt, tt, st), 1e-5)
    packed = TQ.pack_T(qt, tt, st)
    assert np.array_equal(packed.numpy(), np.asarray(JQ.pack_T(jnp.asarray(q), jnp.asarray(t),
                                                               jnp.float32(s))))
    for a, b in zip(TQ.unpack_T(packed), JQ.unpack_T(jnp.asarray(packed.numpy()))):
        _close(a, b, 0.0)


def test_qaxis_at_zero_angle_matches_jax():
    q = np.array([0.0, 0.0, 0.0, 1.0], np.float32)
    assert np.array_equal(TQ.qaxis(torch.from_numpy(q)).numpy(),
                          np.asarray(JQ.qaxis(jnp.asarray(q))))


def test_profiling_summary_matches_jax():
    records = [("search", 1.25), ("reduce", 0.5), ("search", 2.0), ("solve", 0.125)]
    jp, tp = JT.ProfilingInfo(label="icp"), TT.ProfilingInfo(label="icp")
    for phase, ms in records:
        jp.record(phase, ms)
        tp.record(phase, ms)
    assert tp.summary() == jp.summary()
    assert tp.total("search") == jp.total("search") and tp.mean("x") == jp.mean("x") == 0.0
    with tp.span("span"):
        pass
    assert len(tp.phases["span"]) == 1 and tp.phases["span"][0] >= 0.0


def test_timers_on_the_cpu(tmp_path):
    with TT.CPUTimer() as t:
        torch.ones(1000).sum()
    assert t.span_ms >= 0.0
    with TT.trace(str(tmp_path)) as d:
        torch.ones(100).cumsum(0)
    assert (tmp_path / "trace.json").is_file() and d == str(tmp_path)
