"""The work splits of K9 (rep_top2_counts) and K5 (bin_search), emulated
step by step in torch on the CPU and held bitwise against the plain twins
and the JAX package's interpret-mode Pallas kernels.

- K9 (``icp_tpu_torch/csrc/rep_top2_counts.cu``): the warps of a block
  split each chunk of representatives; each keeps a running top 2 with
  strict compares over its increasing ids, from (+inf, 0); the warps'
  lists then merge in lexicographic (score, id) order. That must equal the
  reference's two first-minimum passes (the second masking only the first
  choice's id) on every tie pattern.
- K5 (``icp_tpu_torch/csrc/bin_search.cu``): each bin is cut after its last
  slot whose masked |b|^2 is finite, staged in tiles, the warps split each
  tile's slots, each keeps a running strict-< minimum from (+inf, 0), and
  the warps' minima merge as (lower score, then lower slot).

The scores are the twins' (``fused_step.dot3``); the kernels compute the
same bits with exact-product FMAs (tests/test_torch_exact_fma.py).
"""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from icp_tpu.kernels import knn_moments as JK
from icp_tpu.kernels.bin_search import bin_search_pallas
from icp_tpu_torch.kernels import knn_moments as TK
from icp_tpu_torch.kernels.fused_step import dot3, lane_dot
from icp_tpu_torch.sensors import knn_sets, search_sets

# The module, not the wrapper the package exports under its name.
TB = importlib.import_module("icp_tpu_torch.kernels.bin_search")

INF = float("inf")
# The kernels' layouts: K9 stages 256 reps a chunk for 8 warps; K5 stages
# 512 bin slots a tile for 8 warps. The small layouts put the same rules to
# work on small inputs.
K9_LAYOUTS = {"kernel": (256, 8), "small": (8, 4)}
K5_LAYOUTS = {"kernel": (512, 8), "small": (5, 4)}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---- K9 ---------------------------------------------------------------------


def _k9_scores(p, reps):
    return lane_dot(reps, reps)[None, :] - 2.0 * dot3(p[:, None, :], reps[None, :, :])


def _insert2(v, r, B1, R1, B2, R2):
    """Insert (v, r) into each row's lexicographic (score, id) top 2."""
    first = (v < B1) | ((v == B1) & (r < R1))
    second = ~first & ((v < B2) | ((v == B2) & (r < R2)))
    B2n = torch.where(first, B1, torch.where(second, v, B2))
    R2n = torch.where(first, R1, torch.where(second, r, R2))
    return torch.where(first, v, B1), torch.where(first, r, R1), B2n, R2n


def k9_emulated(p, reps, chunk, warps):
    """K9's split and merge: (i1, i2, counts)."""
    m, n_r = p.shape[0], reps.shape[0]
    scores = _k9_scores(p, reps)
    span = chunk // warps
    lists = []
    for w in range(warps):
        b1 = torch.full((m,), INF)
        b2 = torch.full((m,), INF)
        r1 = torch.zeros(m, dtype=torch.long)
        r2 = torch.zeros(m, dtype=torch.long)
        for c0 in range(0, n_r, chunk):
            for r in range(c0 + w * span, min(c0 + (w + 1) * span, n_r)):
                s = scores[:, r]
                lt1, lt2 = s < b1, s < b2
                b2 = torch.where(lt1, b1, torch.where(lt2, s, b2))
                r2 = torch.where(lt1, r1, torch.where(lt2, torch.full_like(r2, r), r2))
                b1 = torch.where(lt1, s, b1)
                r1 = torch.where(lt1, torch.full_like(r1, r), r1)
        lists.append((b1, r1, b2, r2))
    B1, R1, B2, R2 = lists[0]
    for b1, r1, b2, r2 in lists[1:]:
        B1, R1, B2, R2 = _insert2(b1, r1, B1, R1, B2, R2)
        B1, R1, B2, R2 = _insert2(b2, r2, B1, R1, B2, R2)
    i1, i2 = R1.to(torch.int32), R2.to(torch.int32)
    counts = torch.stack([TK.bin_counts(i1, n_r), TK.bin_counts(i2, n_r)])
    return i1, i2, counts


def _k9_case(name):
    """(p (m, 3), reps (n_r, 3)) float32 numpy."""
    if name == "split":  # sensors/knn_sets.py: copies in other warps and chunks
        return knn_sets.top2(name)
    g = np.random.default_rng(3)
    if name == "ties":  # small integers: exact scores, many equal ones
        p = g.integers(-4, 5, size=(512, 3)).astype(np.float32)
        reps = g.integers(-3, 4, size=(37, 3)).astype(np.float32)
        reps[5] = reps[11] = reps[30] = reps[2]
        reps[[0, 7, 13]] = [[10, 0, 0], [0, 10, 0], [0, 0, 10]]
        p[:4] = 0.0
        return p, reps
    p = (g.normal(size=(512, 3)) * 100).astype(np.float32)
    if name == "n_r=1":
        return p, p[[17]]
    if name == "n_r=2":
        return p, p[[17, 300]]
    if name == "repeated reps":  # every rep twice, a few three times
        base = p[g.choice(512, 20, replace=False)]
        return p, np.concatenate([base, base, base[:5]])
    if name == "zero points":  # invalid points ride as zeros, reps include 0
        p[::3] = 0.0
        reps = p[g.choice(512, 40, replace=False)]
        return p, reps
    if name == "off the chunk":  # several chunks, the last one short
        return p, p[g.choice(512, 300, replace=False)]
    raise ValueError(name)


K9_CASES = ["ties", "n_r=1", "n_r=2", "repeated reps", "zero points", "off the chunk",
            "split"]


@pytest.mark.parametrize("layout", list(K9_LAYOUTS))
@pytest.mark.parametrize("name", K9_CASES)
def test_k9_split_and_merge_is_the_twin(name, layout):
    """The emulated K9 gives the twin's i1, i2 and counts bit for bit."""
    p, reps = map(_t, _k9_case(name))
    got = k9_emulated(p, reps, *K9_LAYOUTS[layout])
    want = TK.rep_top2_counts_ref(p, reps)
    for g, w in zip(got, want):
        assert torch.equal(g, w), name
    if name == "n_r=1":  # the second pass sees only +inf: id 0
        assert bool((got[1] == 0).all())


@pytest.mark.parametrize("name", K9_CASES)
def test_k9_split_and_merge_is_the_pallas_kernel(name):
    """The emulated K9 (the kernel's layout) against the interpret-mode
    Pallas kernel: ids and counts equal."""
    p, reps = _k9_case(name)
    want = JK.rep_top2_counts_pallas(jnp.asarray(p), jnp.asarray(reps), block_m=256,
                                     interpret=True)
    got = k9_emulated(_t(p), _t(reps), *K9_LAYOUTS["kernel"])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_k9_ties_across_warps():
    """Equal scores in two warps' ranges: the merge takes the lower ids, as
    the reference's first-minimum passes do."""
    p = torch.zeros((1, 3))
    reps = torch.tensor([[5.0, 0, 0], [0, 0, 3.0], [0, 3.0, 0], [3.0, 0, 0]])
    # Scores 25, 9, 9, 9; in the small layout (2 reps a warp) warp 0 holds
    # ids 0, 1 and warp 1 ids 2, 3.
    i1, i2, _ = k9_emulated(p, reps, 8, 4)
    want = TK.rep_top2_counts_ref(p, reps)
    assert (int(i1[0]), int(i2[0])) == (int(want[0][0]), int(want[1][0])) == (1, 2)


# ---- K5 ---------------------------------------------------------------------

W8 = np.array([1, 1, 1, 0, 150, 150, 150, 0], np.float32)


def k5_emulated(qg_w, bins_c, sq_b, vals, tile, warps):
    """K5's live-slot search: (best (n_r, cq), matched (n_r, cq, V))."""
    n_r, cq, _ = qg_w.shape
    cb = bins_c.shape[1]
    bt = min(cb, tile)
    best = torch.full((n_r, cq), INF)
    slot = torch.zeros((n_r, cq), dtype=torch.long)
    for b in range(n_r):
        live = torch.nonzero(sq_b[b] < INF)[:, 0]  # +inf and NaN are not live
        n_live = int(live[-1]) + 1 if live.numel() else 0
        run_s = torch.full((warps, cq), INF)
        run_c = torch.zeros((warps, cq), dtype=torch.long)
        for base in range(0, n_live, bt):
            n_t = min(bt, n_live - base)
            span = -(-n_t // warps)
            for w in range(warps):
                for c in range(base + w * span, base + min(n_t, (w + 1) * span)):
                    s = sq_b[b, c] - 2.0 * dot3(qg_w[b], bins_c[b, c][None, :])
                    better = s < run_s[w]
                    run_s[w] = torch.where(better, s, run_s[w])
                    run_c[w] = torch.where(better, c, run_c[w])
        bs, bc = run_s[0], run_c[0]
        for w in range(1, warps):
            take = (run_s[w] < bs) | ((run_s[w] == bs) & (run_c[w] < bc))
            bs = torch.where(take, run_s[w], bs)
            bc = torch.where(take, run_c[w], bc)
        best[b], slot[b] = bs, bc
    matched = torch.gather(vals, 1, slot[..., None].expand(-1, -1, vals.shape[2]))
    return best, matched


# sensors/search_sets.py's all-equal bins (n_r, cq, cb): within one staged
# tile of the kernel, and over three.
K5_TIE_SHAPES = {"all equal, one tile": (4, 40, 128), "all equal, tiles": (4, 24, 1100)}


def _k5_case(name, v=8):
    """(qg_w, bins_c, sq_b_masked, vals) float32 numpy: 6 bins of 40 slots,
    24 query slots, or a set of ``search_sets.all_equal``."""
    if name in K5_TIE_SHAPES:
        return search_sets.all_equal(*K5_TIE_SHAPES[name], v)
    g = np.random.default_rng(7)
    n_r, cq, cb = 6, 24, 40
    qc = np.zeros((n_r, cq, 8), np.float32)
    qc[..., :3] = g.normal(size=(n_r, cq, 3)) * 20
    qc[..., 4:7] = g.uniform(-0.5, 0.5, (n_r, cq, 3))
    bins_c = np.zeros((n_r, cb, 8), np.float32)
    bins_c[..., :3] = g.normal(size=(n_r, cb, 3)) * 20
    bins_c[..., 4:7] = g.uniform(-0.5, 0.5, (n_r, cb, 3))
    if name == "all equal":  # every live slot the same point: all scores tie
        bins_c[:] = bins_c[:, :1]
    sq_b = np.sum(bins_c * W8 * bins_c, axis=-1).astype(np.float32)
    if name in ("holes", "all equal"):
        sq_b[g.uniform(size=sq_b.shape) < 0.3] = np.inf  # holes inside bins
        sq_b[0, 25:] = np.inf  # a dead tail
        sq_b[3, :-1] = np.inf  # only the last slot live
    if name == "empty bins":
        sq_b[[1, 4]] = np.inf
        sq_b[2, 1:] = np.inf  # only slot 0 live
    vals = (g.normal(size=(n_r, cb, v)) * 1000).astype(np.float32)
    return (qc * W8).astype(np.float32), bins_c, sq_b, vals


K5_CASES = [("holes", 8), ("empty bins", 8), ("all equal", 8), ("holes", 12),
            ("empty bins", 12), ("all equal, one tile", 8), ("all equal, tiles", 12)]


@pytest.mark.parametrize("layout", list(K5_LAYOUTS))
@pytest.mark.parametrize("name, v", K5_CASES)
def test_k5_live_slot_search_is_the_twin(name, v, layout):
    """The emulated K5 gives the twin's scores and payloads bit for bit."""
    args = tuple(map(_t, _k5_case(name, v)))
    got = k5_emulated(*args, *K5_LAYOUTS[layout])
    want = TB.bin_search_ref(*args)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), name
    if name == "empty bins":
        assert bool(torch.isinf(got[0][[1, 4]]).all())
        assert torch.equal(got[1][1], args[3][1, :1].expand(24, -1))
    if name in K5_TIE_SHAPES:  # every query takes its bin's first live slot
        cq = args[0].shape[1]
        for b in range(args[0].shape[0]):
            live = torch.nonzero(args[2][b] < INF)[:, 0]
            first = int(live[0]) if live.numel() else 0
            assert torch.equal(got[1][b], args[3][b, first:first + 1].expand(cq, -1)), b


@pytest.mark.parametrize("name, v", K5_CASES)
def test_k5_live_slot_search_is_the_pallas_kernel(name, v):
    """The emulated K5 (the kernel's layout) against the interpret-mode
    Pallas kernel: the payloads (so the winning slots) bitwise; the scores
    to the twin's tolerance against it (the Pallas kernel adds its bf16x3
    partial sums in another order, <= 1 ulp), +inf in the same places."""
    args = _k5_case(name, v)
    s_p, m_p = map(np.asarray, bin_search_pallas(*map(jnp.asarray, args), interpret=True))
    s_e, m_e = k5_emulated(*map(_t, args), *K5_LAYOUTS["kernel"])
    np.testing.assert_array_equal(m_e.numpy(), m_p)
    fin = np.isfinite(s_p)
    np.testing.assert_array_equal(np.isfinite(s_e.numpy()), fin)
    np.testing.assert_allclose(s_e.numpy()[fin], s_p[fin], rtol=1e-6, atol=1e-3)
