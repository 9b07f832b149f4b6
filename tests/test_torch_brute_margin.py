"""K6's tensor-core filter (``icp_tpu_torch/csrc/brute_nn.cu``), checked on
the CPU by emulation.

The kernel scores every pair approximately, s~ = sq_db - 2 acc with acc the
3xTF32 product on the tensor cores, and re-scores exactly (the twin's
lane-order float32) only the pairs with NOT (s~ > U + eps), U a bound on
the query's minimum. It is exact if the margin eps (:func:`margin`, the
formula the kernel evaluates on the device) bounds |s~ - s| for every pair.

- TF32 round-to-nearest-away (``cvt.rna.tf32.f32``) is emulated on the
  float32 bits; the split x = hi + lo leaves less than 2^-22 |x|.
- s~ is emulated in float64, where the 24 part products are exact and
  their sum errs by < 24 * 2^-53 of their magnitudes; to |s~_64 - s_twin|
  the checks add the model's worst case for what float64 does not see: the
  tensor cores' accumulation as truncation (each of the three mma, 10
  truncations of < 2^-23 of its terms' magnitudes), and the rounding of
  fmaf(-2, acc, sq_db). That sum must stay at or under eps, no tolerance.
- The filter rule, emulated with the kernel's threads (four database
  splits x four quad lanes per query, stages of 256 rows in order, a
  1-stage pilot, the bound pooled every 2 stages) on
  s~ pushed to the worst edge of the model (the minimum and its ties up,
  every other pair down), picks brute_nn_ref's index and score bitwise.
"""

import tests.torch_one_thread  # noqa: F401  (torch on one CPU thread)
import importlib

import numpy as np
import pytest
import torch

from icp_tpu_torch import ICPConfig, ICPParams, icp_step
from icp_tpu_torch.icp.state import identity_state
from icp_tpu_torch.ops import distance
from icp_tpu_torch.runtime.config import Correspondence
from icp_tpu_torch.sensors.synthetic import synthetic_pair, wavy_surface_pair
from icp_tpu_torch.sensors.brute_sets import ALPHA, ADVERSARIAL, adversarial, lane_order_scores

# The module, not the wrapper the package exports under its name.
TB = importlib.import_module("icp_tpu_torch.kernels.brute_nn")

U32 = 2.0 ** -24
# csrc/brute_nn.cu's layout: rows per stage, n8 tiles per database split,
# stages of the pilot, stages between exchanges of the bound.
STAGE, SPLITS, PILOT, SHARE_EVERY = 256, 4, 1, 2


class _Captured(Exception):
    pass


def brute_step_args(fixed: np.ndarray, moving: np.ndarray, cfg, device="cpu"):
    """What the first BRUTE step (identity state) hands K6 for this pair:
    both sets centered on the database centroid by nearest_neighbor_brute.
    The step stops at K6's call, so the twin never sweeps the pair."""
    seen = []

    def spy(*args):
        seen.append(args)
        raise _Captured

    real = distance.brute_nn
    distance.brute_nn = spy
    dev = torch.device(device)
    try:
        icp_step(identity_state(torch.float32, dev), torch.from_numpy(moving).to(dev),
                 torch.from_numpy(fixed).to(dev), ICPParams(alpha=ALPHA).to(dev), cfg)
    except _Captured:
        pass
    finally:
        distance.brute_nn = real
    return seen[0]


def margin(qw: np.ndarray, db: np.ndarray, sq_db: np.ndarray) -> np.ndarray:
    """(m,) float32 eps_i = KAPPA 2^-20 (S + 2 A_i) + MARGIN_FLOOR with
    S = max_j |sq_db_j| and A_i = sum_k |qw_ik| max_j |db_jk|: the margin
    that csrc/brute_nn.cu derives and evaluates on the device (there with
    fused multiply-adds; the roundings differ by a few float32 ulps of eps,
    far inside the derivation's slack). An inf or NaN anywhere in the inputs
    makes eps inf or NaN."""
    qw, db, sq_db = map(torch.from_numpy, (qw, db, sq_db))
    M = torch.amax(torch.abs(db), dim=0)
    S = torch.amax(torch.abs(sq_db))
    A = torch.sum(torch.abs(qw) * M, dim=-1)
    return (TB.KAPPA * 2.0 ** -20 * (S + 2.0 * A) + TB.MARGIN_FLOOR).numpy()


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero: half a TF32 ulp added to the magnitude's bits,
    then the 13 low bits cut."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def tf32_split(x: np.ndarray):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)  # x - hi is exact in float32


def emulated_score(qw, db, sq_db):
    """(s~ in float64, the model's error beyond it) for every pair."""
    q_hi, q_lo = (a.astype(np.float64) for a in tf32_split(qw))
    b_hi, b_lo = (a.astype(np.float64) for a in tf32_split(db))
    acc = np.zeros((qw.shape[0], db.shape[0]))
    mag = np.zeros_like(acc)
    for k in range(8):
        for a, b in ((q_lo, b_hi), (q_hi, b_lo), (q_hi, b_hi)):
            p = a[:, None, k] * b[None, :, k]
            acc += p
            mag += np.abs(p)
    sq = sq_db.astype(np.float64)[None, :]
    tensor = 2.0 * 3 * 10 * 2.0 ** -23 * mag * (1 + 2.0 ** -20)
    f64 = 2.0 * 24 * 2.0 ** -53 * mag
    fma = U32 * (np.abs(sq) + 2.0 * mag)
    return sq - 2.0 * acc, tensor + f64 + fma


def _sample(args, n_q):
    """n_q of the queries (the emulation holds several (n_q, n) float64
    arrays), against the whole database."""
    qw, db, sq = (a.numpy() for a in args)
    rows = np.random.default_rng(0).choice(qw.shape[0], n_q, replace=False)
    return np.ascontiguousarray(qw[rows]), db, sq


def _flagship():
    fixed, moving = synthetic_pair(16384)
    return _sample(brute_step_args(fixed, moving, ICPConfig(
        correspondence=Correspondence.BRUTE)), 256)


def _wavy():
    fixed, moving = wavy_surface_pair(4096)[:2]
    return _sample(brute_step_args(fixed, moving, ICPConfig(
        m=4096, n_r=64, correspondence=Correspondence.BRUTE)), 1024)


SETS = ("flagship", "wavy") + ADVERSARIAL


@pytest.fixture(scope="module")
def sets():
    out = {"flagship": _flagship(), "wavy": _wavy()}
    out.update({name: adversarial(name) for name in ADVERSARIAL})
    return out


def test_tf32_rna_rounds_to_nearest_away():
    """Ten explicit mantissa bits, nearest, ties away from zero (both
    signs), exact on TF32 values; the split's rest is under 2^-22 |x|."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    x = np.array([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 + 2.0 ** -23,
                  1.0 + 2.0 ** -11 - 2.0 ** -23, -(1.0 + 2.0 ** -11), 3.0 + 2.0 ** -9],
                 np.float32)
    want = np.array([one, one + ulp, one + ulp, one, -(one + ulp), 3.0 + 2.0 ** -9],
                    np.float32)
    np.testing.assert_array_equal(tf32_rna(x), want)
    v = np.random.default_rng(0).normal(size=100000).astype(np.float32) * 1e3
    hi, lo = tf32_split(v)
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    assert (np.abs(v.astype(np.float64) - hi) <= 2.0 ** -11 * np.abs(v)).all()
    rest = np.abs(v.astype(np.float64) - hi - lo)
    assert (rest <= 2.0 ** -22 * np.abs(v)).all()


@pytest.mark.parametrize("name", SETS)
def test_margin_bounds_the_tensor_core_score(sets, name):
    """|s~ - s_twin| plus the model's accumulation and rounding terms stays
    within the margin's eps on every pair, with room to spare (the
    kernel's threshold roundings need ~4 u S + 4.1 u A more, inside the
    derivation's slack)."""
    qw, db, sq = sets[name]
    s_twin = lane_order_scores(qw, db, sq).astype(np.float64)
    s_tl, model = emulated_score(qw, db, sq)
    eps = margin(qw, db, sq).astype(np.float64)[:, None]
    worst = (np.abs(s_tl - s_twin) + model) / eps
    assert np.isfinite(worst).all()
    assert worst.max() <= 1.0, worst.max()


def filter_pick(s_tl, s_twin, eps):
    """The kernel's rule on approximate scores s_tl (float64) and exact
    float32 scores s_twin: (idx, score, re-scored pairs) per query."""
    m, n = s_twin.shape
    f32 = np.float32
    n_stages = -(-n // STAGE)
    n_pilot = min(PILOT, n_stages)
    # The pilot's approximate minimum over its stages, pooled; U = m~ + eps.
    pilot_cols = np.arange(min(n, n_pilot * STAGE))
    m_t = s_tl[:, pilot_cols].min(axis=1).astype(f32)
    u_pool = (m_t + eps).astype(f32)
    tiles_per_split = STAGE // 8 // SPLITS
    streams = [(sp, t) for sp in range(SPLITS) for t in range(4)]
    u = {k: u_pool.copy() for k in streams}
    best = {k: np.full(m, np.inf, f32) for k in streams}
    idx = {k: np.zeros(m, np.int64) for k in streams}
    count = np.zeros(m, np.int64)
    rows = np.arange(m)
    for st in range(n_stages):
        for col in range(st * STAGE, min(n, (st + 1) * STAGE)):
            key = (((col % STAGE) // 8) // tiles_per_split, (col % 8) // 2)
            thr = (u[key] + eps).astype(f32)
            cand = ~(s_tl[:, col] > thr)
            sc = s_twin[:, col]
            count += cand
            better = cand & (sc < best[key])  # a stream's columns rise
            best[key] = np.where(better, sc, best[key])
            idx[key] = np.where(better, col, idx[key])
            u[key] = np.where(cand, np.minimum(u[key], sc), u[key])
        if (st + 1) % SHARE_EVERY == 0:
            pooled = np.minimum.reduce([u[k] for k in streams])
            u = {k: pooled.copy() for k in streams}
    out_s = np.full(m, np.inf, f32)
    out_i = np.zeros(m, np.int64)
    for k in streams:
        take = (best[k] < out_s) | ((best[k] == out_s) & (idx[k] < out_i))
        out_s = np.where(take, best[k], out_s)
        out_i = np.where(take, idx[k], out_i)
    return out_i[rows], out_s[rows], count


@pytest.mark.parametrize("name", SETS)
def test_filter_rule_picks_the_twins_bits(sets, name):
    """On the model's worst-case s~ (each pair's approximate score pushed
    by the model's full error against the exact answer), the rule keeps
    the twin's first minimum: idx equal and score bitwise."""
    qw, db, sq = sets[name]
    s_twin = lane_order_scores(qw, db, sq)
    s_tl, model = emulated_score(qw, db, sq)
    at_min = s_twin == s_twin.min(axis=1, keepdims=True)
    s_adv = s_tl + np.where(at_min, model, -model)
    idx, score, count = filter_pick(s_adv, s_twin, margin(qw, db, sq))
    idx_t, score_t = TB.brute_nn_ref(*map(torch.from_numpy, (qw, db, sq)))
    np.testing.assert_array_equal(idx, idx_t.numpy())
    np.testing.assert_array_equal(score.view(np.int32), score_t.numpy().view(np.int32))
    assert (count >= 1).all() and (count <= db.shape[0]).all()
    if name in ("flagship", "wavy"):  # a filter, not a sweep: few re-scores
        assert count.mean() <= 64, count.mean()


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_margin_of_a_bad_input_admits_every_pair(sets, bad):
    """An inf or NaN in the database makes every eps inf or NaN, and the
    rule NOT (s~ > U + eps) then re-scores every pair."""
    qw, db, sq = (a.copy() for a in sets["duplicates"])
    db[100, 2] = bad
    eps = margin(qw, db, sq)
    assert not np.isfinite(eps).any()
    s = np.float32(1e30)
    assert not (s > np.float32(-1e30) + eps).any()
