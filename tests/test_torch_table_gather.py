"""K2's gather form (``icp_tpu_torch.kernels.table_build.bin_table`` with
``order=``: the padded bin table straight from the unsorted row sources)
against icp_tpu on the same numpy inputs: bit-identical to the twin of the
gathered, concatenated rows and to JAX's table of those rows (its XLA twin,
and its Pallas kernel in interpret mode on 8-lane rows, as the JAX tests run
it); and the groupings built on it (``group_rows_by_bin``,
``gather_grouped``) equal to JAX's at widths 3, 4, 8, 11 and 12 with one to
three sources, column slices among them.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from icp_tpu.kernels import table_build as JT
from icp_tpu.rbc import grouping as JG
from icp_tpu_torch.kernels import table_build as TT
from icp_tpu_torch.rbc import grouping as TG

WIDTHS = [(8,), (3,), (3, 1), (8, 3), (8, 1, 3)]  # d 8, 3, 4, 11, 12


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _sources(rng, n, widths):
    """Sources of the given widths; the 3-wide ones are column slices of a
    wider array (a row stride other than their width)."""
    out = []
    for d in widths:
        wide = rng.normal(size=(n, d + 5)).astype(np.float32)
        out.append(_t(wide)[:, 2:2 + d])
    return out


def _layout(rng, n, n_bins):
    ids = rng.integers(0, n_bins, n).astype(np.int32)
    ids[ids == 1] = 2  # an empty bin
    counts = np.bincount(ids, minlength=n_bins)
    starts = (np.cumsum(counts) - counts).astype(np.int32)
    return ids, np.argsort(ids, kind="stable").astype(np.int32), starts


@pytest.mark.parametrize("widths", WIDTHS, ids=lambda w: "x".join(map(str, w)))
def test_bin_table_gather_form_bitwise(rng, widths):
    n, n_bins, cap = 1500, 24, 80
    _, order, starts = _layout(rng, n, n_bins)
    srcs = _sources(rng, n, widths)
    got = TT.bin_table(tuple(srcs), _t(starts), capacity=cap, order=_t(order)).numpy()
    gathered = np.concatenate([s.numpy() for s in srcs], axis=1)[order]
    assert got.shape == (n_bins, cap, sum(widths))
    want = TT.bin_table_ref(_t(gathered), _t(starts), capacity=cap).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    ref = np.asarray(JT.bin_table_ref(jnp.asarray(gathered), jnp.asarray(starts),
                                      capacity=cap))
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    if sum(widths) == 8:  # the Pallas kernel's own tests run it on 8-lane rows
        pal = np.asarray(JT.bin_table_pallas(jnp.asarray(gathered), jnp.asarray(starts),
                                             capacity=cap, interpret=True))
        np.testing.assert_array_equal(got.view(np.int32), pal.view(np.int32))
    assert TT.bin_table.launches == 0


@pytest.mark.parametrize("widths", WIDTHS, ids=lambda w: "x".join(map(str, w)))
def test_group_rows_by_bin_any_width_matches_jax(rng, widths):
    """One to three sources (and a zero-width one): the same counts,
    offsets, validity and grouped tables as JAX's."""
    n, n_bins, cap = 2000, 32, 72
    ids, _, _ = _layout(rng, n, n_bins)
    srcs = _sources(rng, n, widths)
    rows = (srcs[0], torch.zeros((n, 0)), *srcs[1:])
    j = JG.group_rows_by_bin(jnp.asarray(ids), n_bins, cap,
                             tuple(jnp.asarray(r.numpy()) for r in rows))
    t = TG.group_rows_by_bin(_t(ids), n_bins, cap, rows)
    for name in ("counts", "offsets", "valid"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), err_msg=name)
    for x, y in zip(t.grouped, j.grouped):
        assert tuple(x.shape) == y.shape
        np.testing.assert_array_equal(x.numpy().view(np.int32),
                                      np.asarray(y).view(np.int32))


@pytest.mark.parametrize("d", [3, 4, 8, 11])
def test_gather_grouped_any_width_matches_jax(rng, d):
    n, n_bins, cap = 1000, 16, 40  # capacity overflow
    ids = rng.integers(0, n_bins - 3, n).astype(np.int32)
    rows = _sources(rng, n, (d,))[0]
    j = JG.group_by_bin(jnp.asarray(ids), n_bins, cap)
    t = TG.group_by_bin(_t(ids), n_bins, cap)
    got = TG.gather_grouped(t, rows).numpy()
    want = np.asarray(JG.gather_grouped(j, jnp.asarray(rows.numpy())))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
