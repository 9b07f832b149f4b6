"""The sharded medians and the sharded SLAM solvers of the port on gloo
worlds of CPU ranks, against their single-device counterparts and the JAX
package's sharded ones: the mirrors of tests/test_sharded.py's median
cases, of the sharded pose-graph solvers of tests/test_pose_graph.py's
graphs (the chain with its loop, the 64-node circle) and of
tests/test_sharded_ba.py.

Two worlds, one per mesh shape, launched through the port's per-rank entry
(``parallel.dryrun``; one torch thread a rank, a 60 s rendezvous and
collective timeout, 120 s to finish): (2, 1) runs the solvers and the
medians, (2, 2) the medians.

Tolerances:
- the medians: within the JAX test's resolution bound of ``masked_median``
  (max(2 % of it, 1e-3)) and within one float32 ulp of JAX's sharded median
  on the same mesh shape; exact where every rank's slice is the same; 0 with
  nothing valid;
- the pose graph: the cost within 1e-4 relative, and the ATE against the
  graph's ground truth within the larger of the t bars of
  tests/test_torch_pose_graph.py (0.005 mm dense, 0.05 mm PCG, 0.5 mm on
  the circle) and four times the reference's own ATE spread under a
  one-ulp move of the graph (its ``_spread``), of the single-device solver
  and of JAX's sharded solver;
- BA: poses and points within 5e-2 of ``ba_solve`` and of JAX's
  ``make_sharded_ba`` (tests/test_sharded_ba.py's bound);
- every rank's result ``torch.equal`` to rank 0's.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from icp_tpu.ops.moments import masked_median as j_masked_median
from icp_tpu.ops.moments import masked_median_sharded as j_masked_median_sharded
from icp_tpu.parallel.mesh import DP_AXIS, MP_AXIS
from icp_tpu.parallel.mesh import make_mesh as j_make_mesh
from icp_tpu.slam import bundle_adjustment as JB
from icp_tpu.slam import pose_graph as JP
from icp_tpu_torch.ops.moments import masked_median
from icp_tpu_torch.parallel.dryrun import ba_shards, launch_world
from icp_tpu_torch.slam import bundle_adjustment as TB
from icp_tpu_torch.slam import make_sharded_ba
from icp_tpu_torch.slam import pose_graph as TP
from tests.test_bundle_adjustment import _make_problem
from tests.test_pose_graph import _chain_with_loop, _circle_graph
from tests.test_sharded_ba import _localize
from tests.test_torch_bundle_adjustment import _to_torch as _ba_to_torch
from tests.test_torch_pose_graph import _ate, _circle_gt, _gt_t, _spread, _to_torch
from tests import test_torch_rank_tasks as rank_tasks


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def _median_data():
    """tests/test_sharded.py's populations: a lognormal-ish residual set
    with a gross-outlier tail and a structured mask (one dp slice loses half
    of its values), and a tile every dp slice repeats."""
    rng = np.random.default_rng(3)
    n = 8192
    x = (rng.gamma(2.0, 5.0, n) ** 1.5).astype(np.float32)
    x[rng.choice(n, n // 10, replace=False)] *= 100.0
    mask = rng.uniform(size=n) < 0.8
    mask[: n // 16] = False
    tile = np.random.default_rng(4).uniform(0, 50, 512).astype(np.float32)
    return x, mask, tile


def _median_tasks(n_dp):
    x, mask, tile = _median_data()
    return [dict(kind="call", fn=rank_tasks.median, name="median", x=torch.from_numpy(x),
                 mask=torch.from_numpy(mask)),
            dict(kind="call", fn=rank_tasks.median, name="median_none_valid",
                 x=torch.from_numpy(x),
                 mask=torch.zeros(x.shape[0], dtype=torch.bool)),
            dict(kind="call", fn=rank_tasks.median, name="median_same_slices",
                 x=torch.from_numpy(np.tile(tile, n_dp)), mask=None)]


GRAPHS = {  # name -> (JAX graph, ground-truth positions, solver, kwargs, t bar mm)
    "dense_chain": (lambda: _chain_with_loop(np.random.default_rng(42))[0],
                    lambda: _gt_t(_chain_with_loop(np.random.default_rng(42))[1]),
                    "optimize", {"iterations": 10}, 0.005),
    "pcg_chain": (lambda: _chain_with_loop(np.random.default_rng(42), n=8, noise=0.02)[0],
                  lambda: _gt_t(_chain_with_loop(np.random.default_rng(42), n=8,
                                                 noise=0.02)[1]),
                  "optimize_pcg", {"iterations": 8, "cg_iterations": 64, "damping": 1e-6},
                  0.05),
    "dense_circle": (lambda: _circle_graph(np.random.default_rng(42)), _circle_gt,
                     "optimize", {"iterations": 10}, 0.5),
    "pcg_circle": (lambda: _circle_graph(np.random.default_rng(42)), _circle_gt,
                   "optimize_pcg", {"iterations": 10, "cg_iterations": 64}, 0.5),
}


@pytest.fixture(scope="module")
def graphs():
    return {name: (make(), gt(), solver, kw, bar)
            for name, (make, gt, solver, kw, bar) in GRAPHS.items()}


@pytest.fixture(scope="module")
def ba_problem():
    problem, _, _ = _make_problem(np.random.default_rng(42), n_cams=4, n_pts=48,
                                  perturb=0.01)
    return problem


@pytest.fixture(scope="module")
def worlds(graphs, ba_problem, tmp_path_factory):
    """mesh -> every rank's results."""
    solver_tasks = [dict(kind=solver, name=name,
                         graph=TP.pad_edges(_to_torch(jg), 2), kwargs=kw)
                    for name, (jg, _, solver, kw, _) in graphs.items()]
    solver_tasks.append(dict(kind="ba", name="ba",
                             problem=ba_shards(_ba_to_torch(ba_problem), 2, 8), n_cams=4,
                             kwargs={"iterations": 6}))
    jobs = {(2, 1): solver_tasks + _median_tasks(2), (2, 2): _median_tasks(2)}
    return {mesh: launch_world({"mesh": mesh, "device": "cpu", "tasks": tasks},
                               mesh[0] * mesh[1], tmp_path_factory.mktemp("world"),
                               timeout=120.0, init_timeout=60.0)
            for mesh, tasks in jobs.items()}


@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)])
def test_every_rank_ends_bitwise_equal(worlds, mesh):
    results = worlds[mesh]
    for task, res0 in results[0]["tasks"].items():
        for r in results[1:]:
            for k, v in res0["out"].items():
                assert torch.equal(r["tasks"][task]["out"][k], v), (r["rank"], task, k)


def _jax_median(mesh, x, mask):
    jm = j_make_mesh(*mesh)
    specs = (P(DP_AXIS),) if mask is None else (P(DP_AXIS), P(DP_AXIS))

    @partial(shard_map, mesh=jm, in_specs=specs, out_specs=P(), check_vma=False)
    def dist_med(*args):
        xl, ml = (args[0], None) if mask is None else args
        return j_masked_median_sharded(xl, ml, (DP_AXIS, MP_AXIS))

    args = (jnp.asarray(x),) if mask is None else (jnp.asarray(x), jnp.asarray(mask))
    return float(jax.block_until_ready(dist_med(*args)))


@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)])
def test_masked_median_sharded_matches_global(worlds, mesh):
    """tests/test_sharded.py::test_masked_median_sharded_matches_global."""
    x, mask, _ = _median_data()
    got = float(worlds[mesh][0]["tasks"]["median"]["out"]["median"])
    want = float(masked_median(torch.from_numpy(x), torch.from_numpy(mask)))
    assert want == float(j_masked_median(jnp.asarray(x), jnp.asarray(mask)))
    assert abs(got - want) <= max(0.02 * want, 1e-3), (got, want)
    j_got = _jax_median(mesh, x, mask)
    assert abs(got - j_got) <= np.spacing(np.float32(j_got)), (got, j_got)
    assert float(worlds[mesh][0]["tasks"]["median_none_valid"]["out"]["median"]) == 0.0


@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)])
def test_masked_median_sharded_exact_when_degenerate(worlds, mesh):
    """tests/test_sharded.py::test_masked_median_sharded_exact_when_degenerate:
    every dp slice holds the same values, so the local medians agree and the
    distributed median is the exact shared element."""
    _, _, tile = _median_data()
    got = float(worlds[mesh][0]["tasks"]["median_same_slices"]["out"]["median"])
    want = float(masked_median(torch.from_numpy(tile), None))
    assert got == want == float(j_masked_median(jnp.asarray(tile), None))
    assert got == _jax_median(mesh, np.tile(tile, mesh[0]), None)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_sharded_pose_graph_matches_single_and_jax(worlds, graphs, name):
    """Both sharded solvers on 2 ranks against the port's single-device
    solver and JAX's sharded solver on a (2, 1) mesh, by cost and ATE."""
    jg, gt, solver, kw, t_bar = graphs[name]
    tg = _to_torch(jg)
    out = worlds[(2, 1)][0]["tasks"][name]["out"]
    got = tg._replace(q=out["q"], t=out["t"])
    single = getattr(TP, solver)(tg, **kw)
    make = JP.make_sharded_optimize if solver == "optimize" else JP.make_sharded_optimize_pcg
    j_sharded = make(j_make_mesh(2, 1), n_nodes=jg.q.shape[0], **kw)(JP.pad_edges(jg, 2))
    _, _, _, _, da = _spread(jg, lambda g: getattr(JP, solver)(g, **kw), gt)
    ate_tol = max(t_bar, 4 * da)
    c = float(TP.graph_cost(got))
    assert c < float(TP.graph_cost(tg)) * 0.2
    for other, c_other in (
            (single.t.numpy(), float(TP.graph_cost(single))),
            (np.asarray(j_sharded.t),
             float(JP.graph_cost(jg._replace(q=j_sharded.q, t=j_sharded.t))))):
        msg = f"reference ATE spread {da} mm; bars: cost 1e-4, ATE {ate_tol} mm"
        assert abs(c - c_other) <= 1e-4 * c_other, (c, c_other, msg)
        assert abs(_ate(out["t"].numpy(), gt) - _ate(other, gt)) <= ate_tol, msg


def test_sharded_ba_matches_single_device_and_jax(worlds, ba_problem):
    """tests/test_sharded_ba.py::test_sharded_ba_matches_single_device on 2
    ranks (the landmarks split in two blocks)."""
    out = worlds[(2, 1)][0]["tasks"]["ba"]["out"]
    problem = _ba_to_torch(ba_problem)
    single = TB.ba_solve(problem, iterations=6)
    assert float(TB.ba_cost(single)) < float(TB.ba_cost(problem)) * 1e-3
    np.testing.assert_allclose(out["pose_t"].numpy(), single.pose_t.numpy(), atol=5e-2)
    np.testing.assert_allclose(out["points"].numpy(), single.points.numpy(), atol=5e-2)
    j_out = JB.make_sharded_ba(j_make_mesh(2, 1), n_cams=4, iterations=6)(
        _localize(ba_problem, 2))
    np.testing.assert_allclose(out["pose_t"].numpy(), np.asarray(j_out.pose_t), atol=5e-2)
    np.testing.assert_allclose(out["points"].numpy(), np.asarray(j_out.points), atol=5e-2)


def test_ba_shards_layout_and_errors():
    """ba_shards lays a problem of uneven degrees out by make_sharded_ba's
    contract: equal runs, local indices, zero-weight padding within
    max_degree; make_sharded_ba refuses uneven splits."""
    problem = TB.demo_problem(8, 64, 5, device="cpu")
    shards = ba_shards(problem, 2, 5)
    o = shards.obs_cam.shape[0]
    assert o % 2 == 0 and o >= problem.obs_cam.shape[0]
    assert torch.equal(shards.points, problem.points)
    for b in range(2):
        run = slice(b * o // 2, (b + 1) * o // 2)
        pts = shards.obs_point[run]
        assert int(pts.min()) >= 0 and int(pts.max()) < 32
        assert int(torch.bincount(pts, minlength=32).max()) <= 5
        real = shards.obs_w[run] > 0
        assert int(real.sum()) == int(((problem.obs_point >= 32 * b)
                                       & (problem.obs_point < 32 * (b + 1))).sum())
    with pytest.raises(ValueError, match="divide evenly"):
        ba_shards(problem, 3, 5)

    class Mesh2:
        shape = {"dp": 2, "mp": 1}
        dp_index = 0
        device = torch.device("cpu")

    with pytest.raises(ValueError, match="divide evenly"):
        make_sharded_ba(Mesh2(), 8)(problem._replace(obs_cam=problem.obs_cam[:-1]))
