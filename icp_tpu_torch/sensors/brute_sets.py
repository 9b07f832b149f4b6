"""Adversarial inputs of K6 (``icp_tpu_torch.kernels.brute_nn``) for the
checks of its tensor-core filter, made in numpy from a seed. The CPU tests,
the card's tests and ``chip_smoke.py`` share them.

Every set is ``(qw, db, sq_db)``: (m, 8) metric-weighted queries, the (n, 8)
database and its (n,) weighted squared norms, float32.
"""

import numpy as np

ALPHA = 2e2  # the benchmark's blend
W8 = np.array([1, 1, 1, 0, ALPHA, ALPHA, ALPHA, 0], np.float32)
ADVERSARIAL = ("offset", "duplicates", "shells", "ulps")


def _cloud(rng, n, lo=(-500.0, -400.0, 1000.0), hi=(500.0, 400.0, 2000.0)):
    """Kinect-like 8-D points: xyz in mm, rgb in [0, 1), lanes 3 and 7 one."""
    out = np.ones((n, 8), np.float32)
    out[:, :3] = rng.uniform(lo, hi, (n, 3))
    out[:, 4:7] = rng.uniform(0, 1, (n, 3))
    return out


def _weighted(q, db):
    db = np.ascontiguousarray(db, np.float32)
    return ((q * W8).astype(np.float32), db,
            np.sum((db * W8) * db, axis=-1, dtype=np.float32))


def adversarial(name: str, seed: int = 0):
    """One adversarial set, at sizes off every tile of the kernel (128
    queries a block, 256 database rows a stage, 8 a tensor-core tile).

    - "offset": uncentred coordinates, +-1e4 mm from the origin, so S and
      the margin are ~1000x the centered flagship's;
    - "duplicates": database rows copied exactly to other indices (other
      stages, database splits and quad lanes of the kernel) and queries on
      them: exact ties, the first index wins;
    - "shells": database points on spheres of radius 3 and 6 mm around
      query centers (integer coordinates, so every score is exact and those
      on a sphere equal): exact ties;
    - "ulps": one database row repeated with |b|^2 entries 0-4 ulps apart,
      the minimum planted at several indices.
    """
    rng = np.random.default_rng(seed)
    if name == "offset":
        off = np.array([1e4, -1e4, 1e4, 0, 0, 0, 0, 0], np.float32)
        return _weighted(_cloud(rng, 300) + off, _cloud(rng, 3001) + off)
    if name == "duplicates":
        db = _cloud(rng, 3001)
        for dst, src in ((2900, 5), (1500, 130), (70, 10), (18, 16), (1027, 1026)):
            db[dst] = db[src]
        q = _cloud(rng, 300)
        for k, src in enumerate((5, 130, 10, 16, 1026)):
            q[8 * k:8 * k + 8] = db[src]
        return _weighted(q, db)
    if name == "shells":
        db = np.round(_cloud(rng, 2000))
        db[:, 4:7] = 0.5
        dirs = np.array([[s0 * a, s1 * b, s2 * c] for a, b, c in
                         ((1, 2, 2), (2, 1, 2), (2, 2, 1))
                         for s0 in (-1, 1) for s1 in (-1, 1) for s2 in (-1, 1)],
                        np.float32)  # 24 directions of length 3
        q = np.round(_cloud(rng, 129))
        q[:, 4:7] = 0.5
        for k, center in enumerate((q[0], q[50])):
            slots = rng.choice(2000, len(dirs), replace=False)
            db[slots, :3] = center[:3] + (k + 1) * dirs
            q[1 + 8 * k:8 + 8 * k] = center  # more queries on the center
        return _weighted(q, db)
    if name == "ulps":
        q = _cloud(rng, 64)
        db = np.repeat(_cloud(rng, 1), 2000, axis=0)
        qw, db, sq = _weighted(q, db)
        steps = rng.integers(1, 5, sq.shape[0])
        steps[[3, 700, 1999]] = 0
        sq = sq[0] + steps * np.spacing(sq[0])
        return qw, db, sq.astype(np.float32)
    raise ValueError(name)


def lane_order_scores(qw, db, sq_db):
    """(m, n) float32 sq_db - 2 qw . db, lane by lane with one rounding per
    multiply and per add: the twin's (and the kernel's re-score) bits."""
    cross = qw[:, None, 0] * db[None, :, 0]
    for k in range(1, 8):
        cross = cross + qw[:, None, k] * db[None, :, k]
    return sq_db[None, :] - np.float32(2.0) * cross
