"""Tie sets of K5 (``icp_tpu_torch.kernels.bin_search``) for the checks of
its (score, slot) merge, made in numpy from a seed. The CPU tests, the
card's tests and ``chip_smoke.py`` share them.

Every set is ``(qg_w, bins_c, sq_b_masked, vals)``: (n_r, cq, 8)
metric-weighted rep-centered queries, (n_r, cb, 8) rep-centered bin points,
their (n_r, cb) masked |b|^2 and an (n_r, cb, V) payload, float32.
"""

import numpy as np

ALPHA = 2e2  # the benchmark's blend
W8 = np.array([1, 1, 1, 0, ALPHA, ALPHA, ALPHA, 0], np.float32)
# Bin-like magnitudes: xyz ~40 mm from the rep, rgb ~0.3, lane 7 one.
SCALE = np.array([40, 40, 40, 0, 0.3, 0.3, 0.3, 1], np.float32)


def all_equal(n_r: int, cq: int, cb: int, v: int, seed: int = 0):
    """Every live slot of a bin holds the same point, so each query's
    scores tie on all of them and the first live slot must win, whichever
    warp or staged tile searched it. About 30 % of the slots are +inf
    holes, the first three of every bin among them (the winner is never
    slot 0); bin 1 is empty; bin 0 is dead past a third of its slots; in bin
    2 the first quarter of the slots is dead, and in bin 3 the first 600
    (past one 512-slot tile where cb allows it). The payload differs from
    slot to slot, so it shows which slot won."""
    g = np.random.default_rng(seed)
    qc = g.normal(size=(n_r, cq, 8)).astype(np.float32) * SCALE
    point = g.normal(size=(n_r, 1, 8)).astype(np.float32) * SCALE
    bins_c = np.repeat(point, cb, axis=1)
    sq_b = np.sum((bins_c * W8) * bins_c, axis=-1, dtype=np.float32)
    sq_b[g.uniform(size=sq_b.shape) < 0.3] = np.inf
    sq_b[:, :3] = np.inf
    sq_b[1 % n_r] = np.inf
    sq_b[0, cb // 3:] = np.inf
    if n_r > 2:
        sq_b[2, :cb // 4] = np.inf
    if n_r > 3:
        sq_b[3, :min(600, cb - 1)] = np.inf
    vals = (g.normal(size=(n_r, cb, v)) * 1000).astype(np.float32)
    return (qc * W8).astype(np.float32), bins_c.astype(np.float32), sq_b, vals


def min_dists_all_equal(n_r: int, cq: int, cb: int, seed: int = 0):
    """K4's arguments (``icp_tpu_torch.kernels.fused_step.bin_min_dists``,
    alpha apart) on the bins of :func:`all_equal`: (mg, qvalid, reps,
    bins_c, sq_b_masked, G, b_row). The raw query rows take G the identity
    and every rep and b_row 0, so qc is the row itself; about 20 % of the
    slots have qvalid 0 and every seventh row zero geometry, both +inf.
    Every live slot of a bin ties, so the d2 is the same whichever slot
    wins; the set holds the search's merges to the twin's bits when all
    partial minima are equal."""
    _, bins_c, sq_b, _ = all_equal(n_r, cq, cb, 8, seed)
    g = np.random.default_rng(seed + 1)
    mg = (g.normal(size=(n_r, cq, 8)) * SCALE).astype(np.float32)
    mg[..., 3] = mg[..., 7] = 1.0
    mg[:, ::7, :3] = 0.0
    qvalid = (g.uniform(size=(n_r, cq)) > 0.2).astype(np.float32)
    return (mg, qvalid, np.zeros((n_r, 8), np.float32), bins_c, sq_b,
            np.eye(8, dtype=np.float32), np.zeros((1, 8), np.float32))
