"""Adversarial inputs of K8 (``icp_tpu_torch.kernels.knn_moments``) for the
checks of its exact k-th-value select, and K9's top-2 sets (:func:`top2`),
made in numpy from a seed. The CPU tests, the card's tests and
``chip_smoke.py`` share them.

Every set is ``(qp, bins, reps, bvalid, k)``: (n_r, cq, 3) raw queries,
(n_r, cb, 3) raw candidates (NaN for invalid points), (n_r, 3)
representatives and (n_r, cb) bool slot occupancy, float32, and the
neighbourhood size.
"""

import numpy as np

ADVERSARIAL = ("ties", "invalid", "k1", "k40", "far", "wide")


def _gauss(rng, n_r, cq, cb, spread=40.0, offset=100.0):
    reps = (rng.normal(size=(n_r, 3)) * offset).astype(np.float32)
    qp = reps[:, None, :] + (rng.normal(size=(n_r, cq, 3)) * spread).astype(np.float32)
    bins = reps[:, None, :] + (rng.normal(size=(n_r, cb, 3)) * spread).astype(np.float32)
    return qp, bins, reps, np.ones((n_r, cb), bool)


def _lattice(rng, n_r, cq, cb, copies):
    """Integer coordinates within 6 of integer reps: every d2 is an exact
    integer (the bf16 parts are exact), so equal distances tie exactly.
    Each candidate point is repeated ``copies`` times at scattered slots,
    and half of the queries sit on a candidate."""
    reps = rng.integers(-300, 300, size=(n_r, 3)).astype(np.float32)
    pts = rng.integers(-6, 7, size=(n_r, -(-cb // copies), 3))
    bins = np.repeat(pts, copies, axis=1)[:, :cb]
    bins = np.stack([b[rng.permutation(cb)] for b in bins]).astype(np.float32)
    qp = rng.integers(-6, 7, size=(n_r, cq, 3)).astype(np.float32)
    qp[:, ::2] = bins[:, rng.choice(cb, (cq + 1) // 2)]
    return qp + reps[:, None, :], bins + reps[:, None, :], reps, np.ones((n_r, cb), bool)


def adversarial(name: str, seed: int = 0):
    """One adversarial set (cb 100 or 1024: not a multiple of the kernel's
    32-lane strips, or past 48 KB of shared memory with every warp).

    - "ties": lattice bins (cb 100, k 12), every point 5 times: the k-th
      distance is tied with up to 4 more slots, and other points tie with it
      on its sphere;
    - "invalid": an all-invalid bin, a bin of NaN candidates, a bin with 5
      valid slots (n_fin < k), NaN queries and a query with one NaN
      coordinate (k 16);
    - "k1": lattice bins with k 1, queries on 5-fold candidates (v = 0,
      tied 5 times);
    - "k40": Gaussian bins at cb 1024 with k 40 (the selection's path past
      32), duplicates and a bin with 30 valid slots;
    - "far": queries and candidates ~3000 mm from their representative,
      queries duplicated among the candidates: d2 of coincident points is
      rounding noise, often negative, and in bin 0 every finite d2 is
      (the max of the staged slots is then below the twin's 0);
    - "wide": Gaussian bins at cb 1024, k 16.
    """
    rng = np.random.default_rng(seed)
    if name == "ties":
        return (*_lattice(rng, 6, 40, 100, 5), 12)
    if name == "k1":
        return (*_lattice(rng, 6, 40, 100, 5), 1)
    if name == "invalid":
        qp, bins, reps, bvalid = _gauss(rng, 6, 40, 100)
        bvalid[0] = False
        bins[1] = np.nan
        bvalid[2, 5:] = False
        qp[3, ::3] = np.nan
        qp[4, 7, 1] = np.nan
        bvalid[5, rng.choice(100, 60, replace=False)] = False
        return qp, bins, reps, bvalid, 16
    if name == "k40":
        qp, bins, reps, bvalid = _gauss(rng, 4, 48, 1024)
        bins[:, 500:600] = bins[:, 100:200]
        qp[:, :8] = bins[:, 500:508]
        bvalid[3, 30:] = False
        return qp, bins, reps, bvalid, 40
    if name == "far":
        qp, bins, reps, bvalid = _gauss(rng, 6, 40, 100, spread=3.0)
        shift = np.array([3000.0, -2000.0, 1500.0], np.float32)
        qp, bins = qp + shift, bins + shift
        qp[:, :20] = bins[:, :20]
        bins[:, 50:70] = bins[:, :20]
        # Bin 0: one point in every occupied slot and under every query,
        # its d2 -102 (so every finite d2 is negative), half the slots empty.
        qp[0] = bins[0] = reps[0] + shift + np.array([-2.67, -1.36, -2.97], np.float32)
        bvalid[0, 50:] = False
        return qp, bins, reps, bvalid, 16
    if name == "wide":
        return (*_gauss(rng, 4, 64, 1024), 16)
    raise ValueError(name)


TOP2 = ("normal", "ties", "split", "split wide")


def top2(name: str):
    """One of K9's (p (m, 3), reps (n_r, 3)) float32 sets:

    - "normal": the reference test's data (tests/test_knn_normals.py), 2048
      Gaussian points at 100 mm and 64 of them as reps;
    - "ties": integer points and reps (exact scores, many equal ones),
      three equal reps, three reps far out and four zero (invalid) points;
    - "split" (4096 points) and "split wide" (65536, where the kernel takes
      8 points a thread, not 4): integer points against 600 integer reps
      (three 256-rep chunks, the last one short), where reps r, r + 32 and
      r + 300 (r < 32) are one point, as are reps 100 + j and 520 + j
      (j < 20). In the kernel's layout (32 reps a warp and chunk) each
      copy lies in another warp or chunk, so exact ties meet only in the
      merge of the warps' lists. Points sit on the copied reps (their i1
      and i2 tie exactly), and four are zero.
    """
    g = np.random.default_rng(0)
    if name in ("split", "split wide"):
        m = 65536 if name == "split wide" else 4096
        p = g.integers(-12, 13, size=(m, 3)).astype(np.float32)
        reps = g.integers(-12, 13, size=(600, 3)).astype(np.float32)
        reps[32:64] = reps[300:332] = reps[:32]
        reps[520:540] = reps[100:120]
        on = np.concatenate([np.arange(32), np.arange(100, 120)])
        p[4:4 + 8 * on.size] = np.repeat(reps[on], 8, axis=0)
        p[:4] = 0.0
        return p, reps
    if name == "normal":
        p = (g.normal(size=(2048, 3)) * 100).astype(np.float32)
        return p, p[g.choice(2048, 64, replace=False)]
    if name == "ties":
        p = g.integers(-4, 5, size=(1024, 3)).astype(np.float32)
        reps = g.integers(-3, 4, size=(16, 3)).astype(np.float32)
        reps[5] = reps[11] = reps[2]
        reps[[0, 7, 13]] = [[10, 0, 0], [0, 10, 0], [0, 0, 10]]
        p[:4] = 0.0
        return p, reps
    raise ValueError(name)
