"""The port's prefix scans and version against ``icp_tpu.ops.scan`` and
``icp_tpu.__version__``. Tolerance: integer scans bitwise; float32 scans
within 1e-5 of the largest partial sum (each package's own cumulative-sum
order)."""

import tests.torch_one_thread  # noqa: F401  (torch on one CPU thread)
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import icp_tpu
import icp_tpu_torch
from icp_tpu.ops import scan as JS
from icp_tpu_torch import ops as TO


@pytest.mark.parametrize("axis", [-1, 0, 1])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_scans_match_jax(axis, dtype):
    rng = np.random.default_rng(7)
    x = (rng.integers(-50, 50, (5, 17, 3)) if dtype == np.int32
         else rng.normal(size=(5, 17, 3))).astype(dtype)
    for name in ("inclusive_scan", "exclusive_scan"):
        want = np.asarray(getattr(JS, name)(jnp.asarray(x), axis=axis))
        got = getattr(TO, name)(torch.from_numpy(x), axis=axis).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        if dtype == np.int32:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_exclusive_scan_is_shifted_inclusive():
    x = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    assert TO.exclusive_scan(x).tolist() == [[0, 1, 3, 6], [0, 5, 11, 18]]
    assert TO.inclusive_scan(x, axis=0).tolist() == [[1, 2, 3, 4], [6, 8, 10, 12]]


def test_version_matches_jax_package():
    assert icp_tpu_torch.__version__ == icp_tpu.__version__
    assert "__version__" in icp_tpu_torch.__all__
