"""The port's ``SlamEngine`` at many keyframes against the JAX package's,
mirroring tests/test_slam_scale.py at its own size (M 512 landmarks,
n_r 16): the grid-hash candidate gate, one batched verification per
keyframe, the padding of its batches, and the backend on the engine's
graph.

Both engines get the same camera-frame clouds, made with the JAX test's
own helpers and handed over as numpy arrays. The circle is the JAX test's
220-frame circle, cut to its first 48 frames: on the CPU the port's
``register_batch`` steps its lanes one after another, ~1.1 s a keyframe
at this circle's ~12 candidates (262 s for all 220 frames on one core),
where JAX's ``vmap`` takes 29 s for the whole circle. The 600-keyframe
case (tests/test_slam_scale.py::test_slam_600_keyframes_closures_and_sharded_backend)
has no CPU twin: the card runs ``optimize_pcg`` on a 600-node graph in
``chip_smoke.py`` in its place (and the sharded PCG on it, over 2 ranks);
its sharded-backend half runs here on the 48-frame circle's graph.

Tolerances: keyframe counts, verified-pair counts, verification batch
sizes and loop-closure sets equal; poses within 0.05 mm and 1e-5 in q
(each registration within the slice tolerances, composed along the
chain); after ``optimize_map`` within 0.5 mm and 5e-3 in q (the dense LM
solve in float32, tests/test_torch_pose_graph.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import icp_tpu
import icp_tpu_torch
from icp_tpu.parallel.mesh import make_mesh as j_make_mesh
from icp_tpu.slam import mapping as JM
from icp_tpu.slam import pose_graph as JP
from icp_tpu.slam.odometry import KeyframePolicy as JK
from icp_tpu_torch.parallel.dryrun import launch_world
from icp_tpu_torch.slam import mapping as TM
from icp_tpu_torch.slam import pose_graph as TP
from icp_tpu_torch.slam.odometry import KeyframePolicy as TK
from tests.test_slam_scale import M, N_FRAMES, _camera_frame, _loop_poses, _world_cloud

N_CUT = 48  # frames of the 220-frame circle (see the module docstring)


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def _frames(n_circle, n_take):
    world = _world_cloud(np.random.default_rng(42))
    return [np.array(_camera_frame(world, q, t)) for q, t in _loop_poses(n_circle)[:n_take]]


def _engines(**loop):
    je = JM.SlamEngine(params=icp_tpu.ICPParams(alpha=2e2),
                       config=icp_tpu.ICPConfig(m=M, n_r=16, estimate_scale=False),
                       policy=JK(max_gap=1), loop_config=JM.LoopClosureConfig(**loop))
    te = TM.SlamEngine(params=icp_tpu_torch.ICPParams(alpha=2e2),
                       config=icp_tpu_torch.ICPConfig(m=M, n_r=16, estimate_scale=False),
                       policy=TK(max_gap=1), loop_config=TM.LoopClosureConfig(**loop))
    return je, te


def _run(frames, **loop):
    je, te = _engines(**loop)
    for f in frames:
        je.process_frame(jnp.asarray(f))
        te.process_frame(torch.from_numpy(f))
    return je, te


def _same(je, te, t_tol, q_tol):
    assert len(te.map.keyframes) == len(je.map.keyframes)
    assert te.map.loop_closures == je.map.loop_closures
    assert te.n_pairs_verified == je.n_pairs_verified
    assert set(te._verify_fns) == set(je._verify_fns)
    for a, b in zip(te.map.keyframes, je.map.keyframes):
        np.testing.assert_allclose(a.pose.t.numpy(), np.asarray(b.pose.t), rtol=0, atol=t_tol)
        np.testing.assert_allclose(np.abs(a.pose.q.numpy()), np.abs(np.asarray(b.pose.q)),
                                   rtol=0, atol=q_tol)


@pytest.fixture(scope="module")
def circle():
    """Both engines over the first 48 frames of the 220-frame circle, and
    each engine's pose graph before any backend moved it."""
    je, te = _run(_frames(N_FRAMES, N_CUT), max_distance=25.0, max_angle_deg=20.0, min_gap=10)
    kfs = je.map.keyframes
    j_graph = JP.graph_from_poses([k.pose.q for k in kfs], [k.pose.t for k in kfs],
                                  je.map.edges, je.map.measurements,
                                  np.asarray(je.map.weights, np.float32))
    return je, te, j_graph, te._graph()


def test_engine_scale_circle_matches_jax(circle):
    """The first 48 frames of the 220-frame circle, every frame a
    keyframe: bounded verification work, power-of-two batches, closures
    where the arc comes within 25 mm, and the backend on the result."""
    poses = _loop_poses(N_FRAMES)
    je, te = circle[:2]
    n_kf = len(te.map.keyframes)
    assert n_kf == N_CUT
    assert len(te.map.loop_closures) > 0, "no loop closures found"
    # The grid gate keeps the verified pairs to the spatial neighborhood
    # (~12 a keyframe here), nowhere near the all-pairs scan.
    assert te.n_pairs_verified < 20 * n_kf, te.n_pairs_verified
    assert len(te._verify_fns) <= int(np.log2(n_kf)) + 1, sorted(te._verify_fns)
    _same(je, te, 0.05, 1e-5)

    je.optimize_map(iterations=5)
    te.optimize_map(iterations=5)
    assert len(te._kf_pos) == n_kf
    t_first = te.map.keyframes[0].pose.t.numpy()
    t_last = te.map.keyframes[-1].pose.t.numpy()
    true_gap = np.linalg.norm(np.asarray(poses[N_CUT - 1][1]) - np.asarray(poses[0][1]))
    assert abs(np.linalg.norm(t_last - t_first) - true_gap) < 10.0
    _same(je, te, 0.5, 5e-3)


def test_sharded_backend_on_the_engine_graph(circle, tmp_path):
    """tests/test_slam_scale.py's part (d) at this file's cut: the
    edge-sharded matrix-free backend, on a gloo world of 2 CPU ranks (one
    torch thread a rank, a 60 s rendezvous and collective timeout, 120 s to
    finish), consumes the engine's graph and lands in the single-device
    optimum, within that test's bound (1.25 x the single-device cost); its
    poses lie within this file's post-backend tolerances (0.5 mm, 5e-3 in
    q) of those JAX's sharded backend reaches on JAX's engine graph; both
    ranks end bitwise equal."""
    _, _, j_graph, graph = circle
    single = TP.optimize_pcg(graph, iterations=6)
    res = launch_world({"mesh": (2, 1), "device": "cpu", "tasks": [
        dict(kind="optimize_pcg", name="pcg", graph=TP.pad_edges(graph, 2),
             kwargs={"iterations": 6})]}, 2, tmp_path, timeout=120.0, init_timeout=60.0)
    out = [r["tasks"]["pcg"]["out"] for r in res]
    assert torch.equal(out[0]["q"], out[1]["q"]) and torch.equal(out[0]["t"], out[1]["t"])
    c_single = float(TP.graph_cost(single))
    c_shard = float(TP.graph_cost(graph._replace(q=out[0]["q"], t=out[0]["t"])))
    assert np.isfinite(c_shard) and c_shard <= c_single * 1.25, (c_single, c_shard)
    run = JP.make_sharded_optimize_pcg(j_make_mesh(2, 1), n_nodes=j_graph.q.shape[0],
                                       iterations=6)
    j_out = run(JP.pad_edges(j_graph, 2))
    np.testing.assert_allclose(out[0]["t"].numpy(), np.asarray(j_out.t), rtol=0, atol=0.5)
    np.testing.assert_allclose(np.abs(out[0]["q"].numpy()), np.abs(np.asarray(j_out.q)),
                               rtol=0, atol=5e-3)


def test_candidate_gate_matches_bruteforce():
    """The grid-hash candidate set equals the brute-force pose gate, and
    JAX's candidate set."""
    je, te = _run(_frames(40, 40), max_distance=30.0, max_angle_deg=30.0, min_gap=5)
    lc = te.loop_config
    kf_idx = len(te.map.keyframes) - 1
    cur = te.map.keyframes[kf_idx]
    got = te._candidate_ids(kf_idx, cur.pose)

    want = []
    t_cur, q_cur = cur.pose.t.numpy(), cur.pose.q.numpy()
    for j in range(kf_idx - lc.min_gap):
        kf = te.map.keyframes[j]
        d = np.linalg.norm(kf.pose.t.numpy() - t_cur)
        dot = np.clip(abs(float(kf.pose.q.numpy() @ q_cur)), 0, 1)
        if d <= lc.max_distance and np.degrees(2 * np.arccos(dot)) <= lc.max_angle_deg:
            want.append(j)
    assert got == want, (got, want)
    assert got == je._candidate_ids(kf_idx, je.map.keyframes[kf_idx].pose)
    _same(je, te, 0.05, 1e-5)


def test_verify_pad_to_single_compile():
    """verify_pad_to collapses every verification to ONE batch size,
    whatever the candidate count."""
    je, te = _run(_frames(40, 40), max_distance=30.0, max_angle_deg=30.0, min_gap=5,
                  verify_pad_to=8)
    assert len(te.map.loop_closures) > 0
    assert set(te._verify_fns) == {8}, sorted(te._verify_fns)
    _same(je, te, 0.05, 1e-5)
