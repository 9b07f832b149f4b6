"""``icp_tpu_torch.slam.pose_graph`` against ``icp_tpu.slam.pose_graph``,
mirroring tests/test_pose_graph.py (less its two sharded cases, which come
with the port of ``parallel``) on the same graphs, built by the JAX test's
own fixtures and handed to the port as numpy arrays.

Tolerances:
- ``demo_ring_graph``: q within 1e-6, t within 1e-4 mm at radius 400.
- Jacobians: within 1e-5 of ``jax.jacfwd``'s, absolute on poses with unit
  translations, and of each edge's largest entry where the translations
  reach 400 mm (float32 carries ~7 digits of those entries).
- Both optimizers solve float32 systems whose condition reaches ~1e7 (mm
  and radians mixed, 400 mm lever arms), so two correct solves of the same
  system differ far above their inputs' rounding, and once one LM step is
  accepted on one side and rejected on the other the paths part. On the
  small graphs the two packages' costs agree within 1e-4 relative and
  their quaternions within 1e-4 (~1e-3 on the circle). Their final poses
  sit where two solves that sum in another order land: the order in which
  the host's vector code sums moves them by 0.01-0.7 mm on these graphs
  (ATen's default capability against AVX2 or AVX-512, XLA:CPU at one
  thread against four). So three tests hold the poses, and the ATE against
  the graph's ground truth, to the reference's own spread, measured on the
  host they run on: JAX's solve once more with the graph's measurements
  moved one float32 ulp up, then down, and its initial poses likewise; the
  t and ATE bars are the larger of the former fixed t bar (0.005 mm dense,
  0.05 mm PCG, 0.5 mm on the 64-node circle) and four times the largest of
  those spreads. The cost (1e-4 relative) and q (1e-4 dense, 1e-3
  otherwise) keep their fixed bars, but for the circle's q: its rotations
  are the least determined of these graphs, and the one-ulp moves shift
  the reference's own q by ~1e-3 there, so q takes the same rule. The
  dense solve of the PCG test is held to JAX's at 12 iterations: at 6-8 one LM
  accept / reject is decided by rounding (the one-ulp moves shift the
  reference's own cost by 7e-3 at 6, 1.6e-4 at 8, and by under 1.5e-5 from
  10 on);
  on the 96-node ring within 2 mm, 1 % of the cost and 5e-3 in q (its
  rotation residuals, in radians beside residuals in mm, weigh ~1e3 times
  less, so its rotations are the least determined). The 256-node chain,
  ten iterations from a far start, is held to the JAX test's bounds in
  each package, not to the other's poses.
"""

import tests.torch_one_thread  # noqa: F401  (torch on one CPU thread)
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import icp_tpu_torch
from icp_tpu.slam import pose_graph as JP
from icp_tpu.slam import se3 as J3
from icp_tpu_torch.slam import pose_graph as TP
from icp_tpu_torch.slam import se3 as T3
from tests.test_pose_graph import _chain_with_loop, _circle_graph
from tests.utils import random_quat


def _to_torch(graph) -> TP.PoseGraph:
    """A JAX PoseGraph as the port's, on the CPU (indices int64)."""
    out = []
    for x in graph:
        a = np.array(x)
        out.append(torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a))
    return TP.PoseGraph(*out)


def _cost(graph) -> float:
    return float(TP.graph_cost(graph)) if isinstance(graph.q, torch.Tensor) \
        else float(JP.graph_cost(graph))


def _nextafter(x, direction):
    return jnp.asarray(np.nextafter(np.asarray(x), np.float32(direction)))


def _ate(t, gt) -> float:
    """RMS position error (mm) of node positions ``t`` against ``gt``."""
    return float(np.sqrt(np.mean(np.sum((np.asarray(t, np.float64) - gt) ** 2, -1))))


def _spread(jg, solve, gt):
    """The reference's own spread on ``jg``: (JAX's solve of ``jg``, max |dt|
    mm, max |dq|, max relative |dcost|, max |dATE| mm) of JAX's solve of the
    graph with its measurements moved one float32 ulp up, then down, and
    with its initial poses moved likewise, against the solve of ``jg``
    itself."""
    base = solve(jg)
    moved = [jg._replace(meas_q=_nextafter(jg.meas_q, d), meas_t=_nextafter(jg.meas_t, d))
             for d in (np.inf, -np.inf)]
    moved += [jg._replace(q=_nextafter(jg.q, d), t=_nextafter(jg.t, d))
              for d in (np.inf, -np.inf)]
    outs = [solve(g) for g in moved]
    dt = max(float(np.abs(np.asarray(o.t) - np.asarray(base.t)).max()) for o in outs)
    dq = max(float(np.abs(np.asarray(o.q) - np.asarray(base.q)).max()) for o in outs)
    c = _cost(base)
    dc = max(abs(_cost(o) - c) / c for o in outs)
    da = max(abs(_ate(o.t, gt) - _ate(base.t, gt)) for o in outs)
    return base, dt, dq, dc, da


def _close_to_spread(tout, jg, solve, gt, t_bar, cost_rel, q_bar=1e-3, q_spread=False):
    """:func:`_close` with t held to max(t_bar, 4 x the reference's t
    spread) (:func:`_spread`) and the ATE against ``gt`` to max(t_bar, 4 x
    its ATE spread); q to ``q_bar`` (with ``q_spread``, to max(q_bar, 4 x
    its q spread)) and the relative cost to ``cost_rel``."""
    jout, dt, dq, dc, da = _spread(jg, solve, gt)
    t_tol, ate_tol = max(t_bar, 4 * dt), max(t_bar, 4 * da)
    q_tol = max(q_bar, 4 * dq) if q_spread else q_bar
    msg = (f"reference spread: t {dt} mm, q {dq}, cost {dc}, ATE {da} mm; bars t {t_tol} "
           f"mm, q {q_tol}, cost {cost_rel}, ATE {ate_tol} mm")
    np.testing.assert_allclose(tout.t.numpy(), np.asarray(jout.t), rtol=0, atol=t_tol,
                               err_msg=msg)
    np.testing.assert_allclose(tout.q.numpy(), np.asarray(jout.q), rtol=0, atol=q_tol,
                               err_msg=msg)
    a_t, a_j = _ate(tout.t.numpy(), gt), _ate(jout.t, gt)
    assert abs(a_t - a_j) <= ate_tol, (a_t, a_j, msg)
    cj, ct = _cost(jout), _cost(tout)
    assert abs(ct - cj) <= cost_rel * cj, (ct, cj, msg)


def _gt_t(gt) -> np.ndarray:
    return np.stack([np.asarray(p.t, np.float64) for p in gt])


def _circle_gt(n=64, radius=400.0) -> np.ndarray:
    """_circle_graph's ground-truth positions, node 0 moved to the origin
    (where the graph's first pose sits; the rotations are the identity)."""
    a = 2 * np.pi * np.arange(n) / n
    ts = np.stack([radius * np.cos(a), np.zeros(n), radius * np.sin(a)], 1)
    return ts.astype(np.float32).astype(np.float64) - ts.astype(np.float32)[0]


def _close(tout, jout, t_tol, cost_rel, q_tol=1e-3):
    np.testing.assert_allclose(tout.t.numpy(), np.asarray(jout.t), rtol=0, atol=t_tol)
    np.testing.assert_allclose(tout.q.numpy(), np.asarray(jout.q), rtol=0, atol=q_tol)
    cj, ct = _cost(jout), _cost(tout)
    assert abs(ct - cj) <= cost_rel * cj, (ct, cj)


def test_demo_ring_graph_matches_jax():
    jg = JP.demo_ring_graph()
    tg = TP.demo_ring_graph(device="cpu")
    np.testing.assert_array_equal(tg.edge_i.numpy(), np.asarray(jg.edge_i))
    np.testing.assert_array_equal(tg.edge_j.numpy(), np.asarray(jg.edge_j))
    np.testing.assert_array_equal(tg.weight.numpy(), np.asarray(jg.weight))
    for tq, jq in ((tg.q, jg.q), (tg.meas_q, jg.meas_q)):
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-6)
    for tt, jt in ((tg.t, jg.t), (tg.meas_t, jg.meas_t)):
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-4)


@pytest.mark.parametrize("scale", [1.0, 400.0])
def test_edge_jacobians_match_jax(scale):
    """Residuals and both 6x6 Jacobians at xi = 0 of random edges."""
    rng = np.random.default_rng(3)
    e = 16
    qs = [np.stack([random_quat(rng, 1.0) for _ in range(e)]) for _ in range(3)]
    ts = [(rng.normal(size=(e, 3)) * scale).astype(np.float32) for _ in range(3)]
    r_t, ji_t, jj_t = torch.func.vmap(TP._edge_jacobians)(
        *(torch.from_numpy(a) for a in (qs[0], ts[0], qs[1], ts[1], qs[2], ts[2])))
    r_j, ji_j, jj_j = jax.vmap(JP._edge_jacobians)(
        J3.Pose(jnp.asarray(qs[0]), jnp.asarray(ts[0])),
        J3.Pose(jnp.asarray(qs[1]), jnp.asarray(ts[1])),
        J3.Pose(jnp.asarray(qs[2]), jnp.asarray(ts[2])))
    for got, want in ((r_t, r_j), (ji_t, ji_j), (jj_t, jj_j)):
        want = np.asarray(want)
        scale_e = np.maximum(np.abs(want).reshape(e, -1).max(1), 1.0)
        err = np.abs(got.numpy() - want).reshape(e, -1).max(1)
        assert np.all(err <= 1e-5 * scale_e), (err / scale_e).max()
    # The port's batched residual is the vmapped one's.
    zero = torch.zeros(6)
    r_b = TP.edge_residual(zero, zero, T3.Pose(torch.from_numpy(qs[0]), torch.from_numpy(ts[0])),
                           T3.Pose(torch.from_numpy(qs[1]), torch.from_numpy(ts[1])),
                           T3.Pose(torch.from_numpy(qs[2]), torch.from_numpy(ts[2])))
    np.testing.assert_allclose(r_b.numpy(), r_t.numpy(), rtol=0, atol=1e-5 * scale)


def test_optimize_reduces_cost_and_matches_jax():
    jg, gt = _chain_with_loop(np.random.default_rng(42))
    tg = _to_torch(jg)
    c0 = _cost(tg)
    assert abs(c0 - _cost(jg)) <= 1e-5 * c0
    out = TP.optimize(tg, iterations=10)
    c1 = _cost(out)
    assert c1 < c0 * 0.2, (c0, c1)
    c2 = _cost(TP.optimize(tg, iterations=20))
    assert c2 <= c1 * 1.01
    _close_to_spread(out, jg, lambda g: JP.optimize(g, iterations=10), _gt_t(gt),
                     t_bar=0.005, cost_rel=1e-4, q_bar=1e-4)


def test_optimize_perfect_graph_is_fixed_point():
    """A graph whose measurements match its poses exactly must not move."""
    rng = np.random.default_rng(42)
    poses = [T3.Pose.identity(device="cpu")]
    for _ in range(4):
        step = T3.Pose(torch.from_numpy(random_quat(rng, 0.2)),
                       torch.from_numpy(rng.normal(size=3).astype(np.float32) * 50))
        poses.append(T3.compose(poses[-1], step))
    edges = [(i, i + 1) for i in range(4)] + [(0, 4)]
    meas = [T3.relative(poses[i], poses[j]) for i, j in edges]
    graph = TP.graph_from_poses([p.q for p in poses], [p.t for p in poses], edges, meas)
    out = TP.optimize(graph, iterations=5)
    np.testing.assert_allclose(out.t.numpy(), graph.t.numpy(), atol=1e-2)


def test_optimize_closes_loop():
    jg, _ = _chain_with_loop(np.random.default_rng(42), n=8, noise=0.03)
    tg = _to_torch(jg)
    out = TP.optimize(tg, iterations=15)

    def endpoint_err(g):
        pi, pj = T3.Pose(g.q[-1], g.t[-1]), T3.Pose(g.q[0], g.t[0])
        z = T3.Pose(g.meas_q[-1], g.meas_t[-1])
        r = T3.log(T3.compose(T3.inverse(z), T3.compose(T3.inverse(pi), pj)))
        return float(torch.linalg.vector_norm(r[:3]))

    assert endpoint_err(out) < endpoint_err(tg) * 0.25
    _close(out, JP.optimize(jg, iterations=15), t_tol=0.005, cost_rel=1e-4, q_tol=1e-4)


def test_anchor_fixed():
    tg = _to_torch(_chain_with_loop(np.random.default_rng(42))[0])
    for out in (TP.optimize(tg, iterations=5), TP.optimize_pcg(tg, iterations=5)):
        np.testing.assert_allclose(out.t[0].numpy(), np.zeros(3), atol=1e-3)
        np.testing.assert_allclose(out.q[0].numpy(), np.array([0, 0, 0, 1.0]), atol=1e-4)


def test_pcg_matches_dense_and_jax():
    """Matrix-free PCG lands where the dense solve lands, in the port as in
    JAX, and each agrees with JAX's."""
    jg, gt = _chain_with_loop(np.random.default_rng(42), n=8, noise=0.02)
    tg = _to_torch(jg)
    dense = TP.optimize(tg, iterations=8)
    pcg = TP.optimize_pcg(tg, iterations=8, cg_iterations=64, damping=1e-6)
    np.testing.assert_allclose(pcg.t.numpy(), dense.t.numpy(), atol=0.5)
    assert _cost(pcg) <= _cost(dense) * 1.05
    _close_to_spread(pcg, jg, lambda g: JP.optimize_pcg(g, iterations=8, cg_iterations=64,
                                                        damping=1e-6),
                     _gt_t(gt), t_bar=0.05, cost_rel=1e-4)
    # Against JAX where both take the same LM path (see the module's
    # docstring): 12 iterations.
    _close_to_spread(TP.optimize(tg, iterations=12), jg, lambda g: JP.optimize(g, iterations=12),
                     _gt_t(gt), t_bar=0.005, cost_rel=1e-4, q_bar=1e-4)


def test_lm_survives_divergent_graph():
    """The 64-node circle on which undamped GN diverged to NaN: the LM
    accept / reject stays finite and converges, as JAX's does."""
    jg = _circle_graph(np.random.default_rng(42))
    tg = _to_torch(jg)
    c0 = _cost(tg)
    out = TP.optimize(tg, iterations=10)
    assert not bool(torch.isnan(out.q).any() | torch.isnan(out.t).any())
    c1 = _cost(out)
    assert np.isfinite(c1) and c1 < c0 * 0.2, (c0, c1)
    _close_to_spread(out, jg, lambda g: JP.optimize(g, iterations=10), _circle_gt(),
                     t_bar=0.5, cost_rel=1e-4, q_spread=True)


def test_lm_pcg_survives_divergent_graph():
    jg = _circle_graph(np.random.default_rng(42))
    tg = _to_torch(jg)
    out = TP.optimize_pcg(tg, iterations=10, cg_iterations=64)
    c1 = _cost(out)
    assert np.isfinite(c1) and c1 < _cost(tg) * 0.2
    _close(out, JP.optimize_pcg(jg, iterations=10, cg_iterations=64), t_tol=0.5,
           cost_rel=1e-4)


@pytest.mark.parametrize("solver", ["optimize", "optimize_pcg"])
def test_demo_ring_graph_optimizers_match_jax(solver):
    """The shared ring fixture (96 nodes, 12 closures), ten iterations."""
    jg = JP.demo_ring_graph()
    tg = TP.demo_ring_graph(device="cpu")
    out = getattr(TP, solver)(tg, iterations=10)
    assert _cost(out) < _cost(tg) * 0.01
    _close(out, getattr(JP, solver)(jg, iterations=10), t_tol=2.0, cost_rel=1e-2, q_tol=5e-3)


def test_pcg_scales_to_large_graph():
    """A 256-node loop with closures: PCG reduces the cost sharply without
    forming the dense system, in both packages."""
    jg, _ = _chain_with_loop(np.random.default_rng(42), n=256, noise=0.01)
    tg = _to_torch(jg)
    c0 = _cost(tg)
    for out in (TP.optimize_pcg(tg, iterations=10, cg_iterations=96),
                JP.optimize_pcg(jg, iterations=10, cg_iterations=96)):
        assert _cost(out) < c0 * 0.2, (c0, _cost(out))
        np.testing.assert_allclose(np.asarray(out.t[0]), np.zeros(3), atol=1e-2)


def test_pad_nodes_and_edges_are_inert():
    """Padded (edge-free identity) nodes and zero-weight self-edges leave
    the real nodes' solution as it is, and the padded nodes stay put
    (tests/test_slam_engine.py::test_pad_nodes_is_inert)."""
    rng = np.random.default_rng(42)
    q0 = torch.tensor([0.0, 0.0, 0.0, 1.0])
    qs, ts, edges, meas = [], [], [], []
    for i in range(5):
        qs.append(q0)
        ts.append(torch.from_numpy(np.array([10.0 * i, 0, 0], np.float32)
                                   + rng.normal(0, 1.0, 3).astype(np.float32)))
        if i > 0:
            edges.append((i - 1, i))
            meas.append(T3.Pose(q0, torch.tensor([10.0, 0.0, 0.0])))
    g = TP.graph_from_poses(qs, ts, edges, meas)
    padded = TP.pad_edges(TP.pad_nodes(g, 8), 16)
    assert padded.q.shape[0] == 8 and padded.edge_i.shape[0] == 16
    assert float(padded.weight[4:].abs().sum()) == 0.0
    for solver in (TP.optimize, TP.optimize_pcg):
        out_plain = solver(g, iterations=5)
        out_pad = solver(padded, iterations=5)
        np.testing.assert_allclose(out_pad.t[:5].numpy(), out_plain.t.numpy(), atol=1e-3)
        np.testing.assert_allclose(out_pad.q[:5].numpy(), out_plain.q.numpy(), atol=1e-5)
        np.testing.assert_allclose(out_pad.t[5:].numpy(), 0.0, atol=1e-5)
    # JAX's padding gives the same padded graph.
    jpad = JP.pad_edges(JP.pad_nodes(JP.graph_from_poses(
        [jnp.asarray(q.numpy()) for q in qs], [jnp.asarray(t.numpy()) for t in ts], edges,
        [J3.Pose(jnp.asarray(m.q.numpy()), jnp.asarray(m.t.numpy())) for m in meas]), 8), 16)
    for a, b in zip(padded, jpad):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_graph_builders_keep_the_device_and_tf32_is_off():
    """The graph lives on its poses' device; the solvers' products run in
    full float32 (importing the port turns TF32 off)."""
    g = TP.demo_ring_graph(8, n_loops=1, span=3, device="cpu")
    assert all(x.device.type == "cpu" for x in g)
    assert g.edge_i.dtype == torch.int64 and g.weight.dtype == torch.float32
    assert icp_tpu_torch is not None
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
