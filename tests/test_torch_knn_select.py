"""K8's exact k-th-value select (``icp_tpu_torch/csrc/bin_knn_moments.cu``),
emulated here in plain torch and numpy, against the twin's 18 counting
passes (``kernels/knn_moments.py::_knn_math``, the golden, held to JAX in
``test_torch_knn.py``).

The emulation follows the kernel step by step: the bin's live candidates
(occupied, finite |c|^2) compacted in slot order, lane strips of 32, the
count of -inf values, the upper bound U (the kk-th smallest lane minimum
when kk <= 32), the exact rank among the finite d2 <= U, 18 halvings on
scalars with float32 rounding, and the admitted slots' W-sums in slot
order. hi and n must equal the twin's bit for bit, the components within
1e-5 of each query's largest.
"""

import numpy as np
import pytest
import torch

from icp_tpu_torch.kernels import knn_moments as TK
from icp_tpu_torch.kernels.fused_step import _bf16_round, dot3, lane_dot
from icp_tpu_torch.sensors import knn_sets

F32 = np.float32


def _twin_d2(qp, bins, reps, bvalid):
    """d2, the centred NaN-zeroed candidates and sq_b, as _knn_math makes
    them."""
    qp = qp - reps[:, None, :]
    bins = bins - reps[:, None, :]
    sq_b = lane_dot(bins, bins)
    sq_b = torch.where(bvalid & torch.isfinite(sq_b), sq_b, float("inf"))
    bins = torch.where(torch.isfinite(bins), bins, 0.0)
    cross = dot3(qp[:, :, None, :], bins[:, None, :, :])
    return lane_dot(qp, qp)[..., None] - 2.0 * cross + sq_b[:, None, :], bins, sq_b


def _twin_hi(d2, k):
    """The twin's bisection (_knn_math), line for line: its threshold hi."""
    finite = torch.isfinite(d2)
    k_eff = torch.clamp(finite.sum(-1, dtype=d2.dtype), max=float(k))
    hi = torch.amax(torch.where(finite, d2, 0.0), dim=-1) + 1.0
    lo = torch.full_like(hi, -1.0)
    for _ in range(TK.BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        take_hi = (d2 <= mid[..., None]).sum(-1, dtype=d2.dtype) >= k_eff
        hi = torch.where(take_hi, mid, hi)
        lo = torch.where(take_hi, lo, mid)
    return hi


def _select_then_halve(row: np.ndarray, k: int, cb: int):
    """The kernel's threshold for one query: ``row`` holds the d2 of the
    bin's live slots in slot order (float32), ``cb`` the bin's slot count.
    Returns (hi, the admitted positions in ``row``)."""
    n = row.size
    fin = np.isfinite(row)
    n_fin, n_ninf = int(fin.sum()), int((row == -np.inf).sum())
    mx = np.where(fin, row, F32(0)).max() if n else F32(-np.inf)
    if n < cb:  # slots left out of staging: the twin's 0
        mx = max(mx, F32(0))
    kk = min(k, n_fin) - n_ninf
    v = F32(0)
    if kk > 0:
        lmin = [row[lane::32][fin[lane::32]].min(initial=np.inf) for lane in range(32)]
        u = F32(sorted(lmin)[kk - 1]) if kk <= 32 else F32(np.inf)
        s = row[fin & (row <= u)]
        assert s.size >= kk
        less = (s[None, :] < s[:, None]).sum(1)
        v = s[less < kk].max()
    hi, lo = F32(mx) + F32(1), F32(-1)
    for _ in range(TK.BISECT_ITERS):
        with np.errstate(over="ignore"):
            mid = F32(0.5) * (lo + hi)
        if kk <= 0 or v <= mid:
            hi = mid
        else:
            lo = mid
    return hi, np.nonzero(fin & (row <= hi))[0]


def _wsum(x: torch.Tensor) -> np.float32:
    """Sum over the admitted slots as the kernel's lanes do: hi and lo bf16
    parts apart, group g of 3 over the slots t = g mod 3 in slot order (one
    float32 rounding per add), the groups joined as (g0 + g1) + g2."""
    x_hi = _bf16_round(x)
    x_lo = _bf16_round(x - x_hi)

    def part(p):
        g = [np.add.accumulate(np.concatenate([[F32(0)], p.numpy()[i::3]]), dtype=F32)[-1]
             for i in range(3)]
        return F32(F32(g[0] + g[1]) + g[2])

    return F32(part(x_hi) + part(x_lo))


def _emulate(qp, bins, reps, bvalid, k):
    """The kernel's (components (6, n_r, cq), n (n_r, cq), hi (n_r, cq))."""
    d2, bc, sq_b = _twin_d2(qp, bins, reps, bvalid)
    n_r, cq, cb = d2.shape
    comps = np.zeros((6, n_r, cq), F32)
    cnt = np.zeros((n_r, cq), F32)
    his = np.zeros((n_r, cq), F32)
    for b in range(n_r):
        live = torch.nonzero(torch.isfinite(sq_b[b]))[:, 0]
        c = bc[b, live]
        for i in range(cq):
            hi, adm = _select_then_halve(d2[b, i, live].numpy(), k, cb)
            n = F32(max(adm.size, 1))
            a = torch.from_numpy(adm)
            s1 = [_wsum(c[a, j]) for j in range(3)]
            for u, (p, q) in enumerate(zip([0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2])):
                m2 = _wsum(c[a, p] * c[a, q])
                comps[u, b, i] = m2 - (s1[p] * s1[q]) / n
            cnt[b, i], his[b, i] = n, hi
    return comps, cnt, his


def _reference_inputs():
    """The reference test's K8 inputs (tests/test_knn_normals.py): underfull
    bins, a NaN candidate; and a NaN query."""
    g = np.random.default_rng(0)
    n_r, cq, cb = 8, 16, 128
    reps = (g.normal(size=(n_r, 3)) * 100).astype(F32)
    qp = reps[:, None, :] + (g.normal(size=(n_r, cq, 3)) * 40).astype(F32)
    bins = reps[:, None, :] + (g.normal(size=(n_r, cb, 3)) * 40).astype(F32)
    bvalid = np.ones((n_r, cb), bool)
    for r in range(n_r):
        bvalid[r, int(g.integers(4, cb)):] = False
    bins[2, 1] = np.nan
    qp[3, 5] = np.nan
    return qp, bins, reps, bvalid, 12


def _rows(name):
    """Adversarial d2 rows (every slot live), with k."""
    g = np.random.default_rng(1)
    rows = np.abs(g.normal(size=(40, 77)).astype(F32) * 100)
    rows[::4, :3] *= -0.01  # a few small negative d2
    if name == "ties":  # exact ties at the k-th value and beside it
        rows = np.round(rows / 50).astype(F32) * 50
        return rows, 12
    if name == "negative":  # all below lo = -1: hi falls to ~-1
        return -rows - 5, 16
    if name == "nonfinite":  # +inf and NaN slots, rows of few finite values
        rows[:, ::3] = np.inf
        rows[:, 1::5] = np.nan
        rows[:10, 2:] = np.nan
        return rows, 16
    if name == "ninf":  # -inf d2 counts in the twin but is never admitted
        rows[:, ::7] = -np.inf
        rows[:5] = -np.inf
        return rows, 12
    if name == "overflow":  # mx near float32's top: mid reaches +inf
        rows[:, :30] = F32(3e38)
        rows[:, 30:] = F32(2.5e38)
        rows[::2, 5] = F32(1.0)
        return rows, 3
    if name == "k_past_32":
        rows[::4, 10:] = np.inf
        return rows, 45
    raise ValueError(name)


CASES = ["reference", *knn_sets.ADVERSARIAL]
ROW_CASES = ["ties", "negative", "nonfinite", "ninf", "overflow", "k_past_32"]


@pytest.mark.parametrize("case", [("set", c) for c in CASES] + [("rows", c) for c in ROW_CASES],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_select_then_halve_equals_the_twins_bisection(case):
    kind, name = case
    if kind == "rows":
        rows, k = _rows(name)
        want = _twin_hi(torch.from_numpy(rows), k).numpy()
        for r in range(rows.shape[0]):
            hi, adm = _select_then_halve(rows[r], k, rows.shape[1])
            assert hi.view(np.int32) == want[r].view(np.int32), (r, hi, want[r])
            fin = np.isfinite(rows[r])
            assert adm.size == int((fin & (rows[r] <= want[r])).sum())
        return
    args = _reference_inputs() if name == "reference" else knn_sets.adversarial(name)
    *arrays, k = args
    tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    # The kernel's d2 cross sums products of bf16 parts with FMAs: each
    # product must be exact in float32 (equal to its float64 value).
    q = torch.nan_to_num(tensors[0] - tensors[2][:, None, :])
    c = torch.nan_to_num(tensors[1] - tensors[2][:, None, :])
    for a in (_bf16_round(q), _bf16_round(q - _bf16_round(q))):
        for b in (_bf16_round(c), _bf16_round(c - _bf16_round(c))):
            a4, b4 = a[:, :, None, :], b[:, None, :, :]
            assert torch.equal((a4 * b4).double(), a4.double() * b4.double())
    comps, cnt, hi = _emulate(*tensors, k)
    want_c, want_n = TK._knn_math(*tensors, k)
    d2 = _twin_d2(*tensors)[0]
    np.testing.assert_array_equal(hi.view(np.int32), _twin_hi(d2, k).numpy().view(np.int32))
    np.testing.assert_array_equal(cnt, want_n.numpy())
    want = torch.stack(want_c).numpy()
    scale = np.maximum(np.abs(want).max(axis=0), 1e-30)
    assert np.all(np.abs(comps - want) <= 1e-5 * scale)
    if name in ("ties", "k1"):  # the k-th value is tied: extras are admitted
        assert np.any(cnt > k)
