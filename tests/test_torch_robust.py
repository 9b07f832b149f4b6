"""icp_tpu_torch's robust weights (ops/moments.py), K3's twin with a robust
factor and K4's twin, against icp_tpu on the same numpy inputs. The JAX
side runs its XLA twins, as its own tests run them on the CPU."""

import tests.torch_one_thread  # noqa: F401  (torch on one CPU thread)
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from icp_tpu.kernels import fused_step as JF
from icp_tpu.ops import moments as JM
from icp_tpu.rbc import construct as JC
from icp_tpu.rbc import search as JR
from icp_tpu_torch.interop import index_from_numpy
from icp_tpu_torch.kernels import fused_step as TF
from icp_tpu_torch.ops import moments as TM
from icp_tpu_torch.rbc import search as TR
from tests.test_torch_kernels import ALPHA, _moment_inputs
from tests.utils import make_cloud8, random_quat


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def test_compute_weights_matches_jax(rng):
    d = rng.uniform(0, 1e4, 1000).astype(np.float32)
    np.testing.assert_allclose(TM.compute_weights(_t(d)).numpy(),
                               np.asarray(JM.compute_weights(jnp.asarray(d))),
                               rtol=1e-6)


@pytest.mark.parametrize("kind", ["none", "huber", "tukey", "trimmed"])
def test_robust_factor_matches_jax(rng, kind):
    """Random d^2 around the scale, plus the breakpoints: 0 (Huber's rsqrt
    guard), exactly delta^2 (TRIMMED keeps it), a negative input (clamped)
    and +inf (an empty bin: a clean 0)."""
    delta = np.float32(10.0)
    d2 = np.concatenate([rng.uniform(0, 400, 500),
                         [0.0, 100.0, -3.0, np.inf, 1e8]]).astype(np.float32)
    want = np.asarray(JM.robust_factor(jnp.asarray(d2), kind, jnp.float32(delta)))
    got = TM.robust_factor(_t(d2), kind, float(delta)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if kind != "none":
        # The factor acts on part of the pairs and keeps others.
        assert (got[:500] < 1.0).any() and (got[:500] > 0.0).any()
        assert got[-2] == 0.0 or kind == "huber"


def test_robust_factor_rejects_unknown_kind():
    with pytest.raises(ValueError):
        TM.robust_factor(torch.ones(3), "cauchy", 1.0)


@pytest.mark.parametrize("n, valid_frac", [(1001, 0.7), (1000, 0.5), (1, 1.0),
                                           (64, 0.0)])
def test_masked_median_matches_jax(rng, n, valid_frac):
    """The same element (the lower median), 0 when the mask is empty."""
    x = rng.uniform(0, 100, n).astype(np.float32)
    mask = rng.uniform(size=n) < valid_frac
    want = np.asarray(JM.masked_median(jnp.asarray(x), jnp.asarray(mask)))
    got = TM.masked_median(_t(x), _t(mask))
    assert got.dim() == 0
    assert float(got) == float(want)
    if mask.any():
        assert float(got) in x[mask]
    else:
        assert float(got) == 0.0
    want_all = np.asarray(JM.masked_median(jnp.asarray(x), None))
    assert float(TM.masked_median(_t(x), None)) == float(want_all)


@pytest.mark.parametrize("kind", ["huber", "tukey", "trimmed"])
def test_adaptive_robust_delta_matches_jax(rng, kind):
    d2 = rng.uniform(0, 900, 2048).astype(np.float32)
    d2[::7] = np.inf
    mask = np.isfinite(d2)
    want = np.asarray(JM.adaptive_robust_delta(jnp.asarray(d2), jnp.asarray(mask), kind))
    got = TM.adaptive_robust_delta(_t(d2), _t(mask), kind)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # All-zero residuals keep the 1e-3 floor.
    zero = TM.adaptive_robust_delta(torch.zeros(16), torch.ones(16, dtype=torch.bool),
                                    kind)
    assert float(zero) == pytest.approx(1e-3)


def _median_delta(args):
    d2 = TF.bin_min_dists_ref(*map(_t, args), ALPHA).numpy()
    return float(np.sqrt(np.median(d2[np.isfinite(d2)])))


@pytest.mark.parametrize("robust", ["huber", "tukey", "trimmed"])
@pytest.mark.parametrize("weighted", [True, False])
def test_bin_point_moments_robust_twin_matches_jax(rng, robust, weighted):
    args = _moment_inputs(rng)
    delta = _median_delta(args)
    j_args = tuple(map(jnp.asarray, args)) + (jnp.float32(ALPHA),)
    want = np.asarray(JF.bin_point_moments_ref(*j_args, weighted=weighted,
                                               robust=robust,
                                               robust_delta=jnp.float32(delta)))
    got = TF.bin_point_moments(*map(_t, args), ALPHA, weighted=weighted,
                               robust=robust, robust_delta=delta).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    # The factor really cut the weights: sum(w) at [3, 3] drops.
    plain = TF.bin_point_moments(*map(_t, args), ALPHA, weighted=weighted).numpy()
    assert got[:, 3, 3].sum() < 0.95 * plain[:, 3, 3].sum()
    assert TF.bin_point_moments.launches == 0


def test_bin_min_dists_twin_matches_jax(rng):
    """The same +inf slots (empty slot, zero-geometry row, empty bin) and
    finite values within 1e-5 relative."""
    args = _moment_inputs(rng)
    want = np.asarray(JF.bin_min_dists_ref(*map(jnp.asarray, args),
                                           jnp.float32(ALPHA)))
    got = TF.bin_min_dists(*map(_t, args), ALPHA).numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert 0 < fin.sum() < fin.size and not fin[2].any()
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)
    assert TF.bin_min_dists.launches == 0


def test_bin_min_dists_reads_strided_rows(rng):
    """K4's wrapper takes lanes 0:8 of a wider grouped table (the 11-wide
    (moving8 | normal) table of PLANE / GICP) as it takes packed rows."""
    args = list(map(_t, _moment_inputs(rng)))
    wide = torch.cat([args[0], torch.randn(args[0].shape[:2] + (3,))], dim=-1)
    view = wide[..., :8]
    assert not view.is_contiguous()
    a = TF.bin_min_dists(view, *args[1:], ALPHA)
    b = TF.bin_min_dists(*args, ALPHA)
    assert torch.equal(a, b)


@pytest.mark.parametrize("robust, weighted", [("huber", True), ("trimmed", False),
                                              ("tukey", True)])
def test_rbc_point_moments_adaptive_on_jax_index(rng, robust, weighted):
    """The port's POINT front half with an adaptive robust scale (K4, the
    median, K3) on the JAX-built index gives the JAX package's Horn
    inputs."""
    db = make_cloud8(rng, 512)
    db[7:19] = 0.0
    reps = db[rng.choice(np.arange(20, 512), 16, replace=False)]
    jidx = JC.rbc_construct(jnp.asarray(db), jnp.asarray(reps), jnp.float32(ALPHA), 64)
    tidx = index_from_numpy(jax.tree.map(np.asarray, jidx._asdict()), device="cpu")
    moving = make_cloud8(rng, 512)
    moving[30:40] = 0.0
    q = random_quat(rng, 0.05)
    t = (rng.normal(size=3) * 10).astype(np.float32)
    kw = dict(weighted=weighted, robust=robust, robust_delta=50.0,
              robust_adaptive=True)
    want = JR.rbc_point_moments(jidx, jnp.asarray(moving), jnp.asarray(q),
                                jnp.asarray(t), jnp.float32(1.0), jnp.float32(ALPHA),
                                jnp.float32(1e-6), 64, use_pallas=False, **kw)
    got = TR.rbc_point_moments(tidx, _t(moving), _t(q), _t(t), torch.tensor(1.0),
                               ALPHA, 1e-6, 64, **kw)
    for name, g, w in zip(("S11", "mean_f", "mean_m", "sum_w"), got, want):
        w = np.asarray(w)
        atol = 1e-5 * np.abs(w).max() if name == "S11" else 0.0
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=atol, err_msg=name)
