"""Pose-graph optimization, Levenberg-Marquardt on SE(3) (port of
``icp_tpu.slam.pose_graph``).

Graph: nodes are keyframe poses, edges relative-pose measurements (the
odometry chain and the loop closures, both from ICP). Residual of an edge
(i, j) with measurement Z (= measured pose_i^-1 pose_j):

    r_ij = log( Z^-1 X_i^-1 X_j )   in R^6  ([rho, phi])

The 6x6 Jacobians come from forward-mode autodiff
(``torch.func.vmap(torch.func.jacfwd(...))``) at xi = 0. Damping is
adaptive with an accept / reject per iteration: a candidate step is kept
only if it lowers the (finite) total cost, else lambda grows x10 and the
next iteration re-linearizes at the same point. Plain GN with a fixed tiny
damping is not safe on loop-closure graphs: on a 600-node circle with
50-node closures its first step overshoots by meters and diverges to NaN.
The accept / reject is two ``torch.where`` selects and the solves are the
``_ex`` forms, so a whole optimization is enqueued with no host read.

Two inner solvers:
  * the dense 6N x 6N normal system (:func:`optimize`), for 10^1-10^2
    nodes, one LU solve;
  * matrix-free block-Jacobi PCG (:func:`optimize_pcg`) for larger graphs.

Assembly: the JAX package scatter-adds each edge's blocks onto the nodes.
Floating-point scatter-adds on CUDA sum in the order the atomics land, so
their bits change from run to run, and the accept / reject could flip with
them. Here every sum onto the nodes is a product with the (E, N) edge
incidence matrices (one 1.0 per row): the dense system is A^T W A of the
(6E, 6N) edge Jacobian A, the PCG's gradient, preconditioner blocks and
Hv products are incidence^T times per-edge terms. Matrix products and
reductions are deterministic, so both optimizers repeat bit for bit. The
incidence matrices take O(E N) memory.

The sharded solvers (:func:`make_sharded_optimize`,
:func:`make_sharded_optimize_pcg`) split the EDGES over a mesh's ``dp``
ranks and keep the poses replicated: each rank sums its edges' partials
with the same incidence products, one all-reduce a step combines them, and
every rank runs the same solve on the same bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from icp_tpu_torch.icp.quaternion import qidentity
from icp_tpu_torch.slam import se3

# LM trust-region schedule. Reject multiplies lambda by _LM_UP (fast escape
# from an overshooting step), accept multiplies by _LM_DOWN (gentle enough
# not to oscillate). Lambda is dimensionless: it scales diag(H) (Marquardt
# scaling), so the same schedule works across graph scales and units.
_LM_UP = 10.0
_LM_DOWN = 1.0 / 3.0
_LM_MIN = 1e-9
_LM_MAX = 1e8
# Floor for the Marquardt diagonal: padded / edge-free nodes have diag(H)
# 0; the floor makes their damped update exactly -b/lam = 0 (b is 0 too).
_DIAG_FLOOR = 1e-3


class PoseGraph(NamedTuple):
    """Struct-of-arrays pose graph, on one device.

    Attributes:
      q: (N, 4) node orientations.
      t: (N, 3) node positions.
      edge_i: (E,) int64 source node index.
      edge_j: (E,) int64 target node index.
      meas_q: (E, 4) measured relative orientation (i_from_j convention:
        Z = X_i^-1 X_j).
      meas_t: (E, 3) measured relative translation.
      weight: (E,) scalar information weight per edge.
    """

    q: torch.Tensor
    t: torch.Tensor
    edge_i: torch.Tensor
    edge_j: torch.Tensor
    meas_q: torch.Tensor
    meas_t: torch.Tensor
    weight: torch.Tensor


def graph_from_poses(poses_q, poses_t, edges, meas, weights=None) -> PoseGraph:
    """Build a PoseGraph from sequences of pose tensors, (i, j) pairs and
    measurement Poses (host-side convenience), on the poses' device."""
    q = torch.stack(list(poses_q))
    t = torch.stack(list(poses_t))
    dev = t.device
    edge_i = torch.as_tensor(np.asarray([e[0] for e in edges], np.int64), device=dev)
    edge_j = torch.as_tensor(np.asarray([e[1] for e in edges], np.int64), device=dev)
    meas_q = torch.stack([m.q for m in meas])
    meas_t = torch.stack([m.t for m in meas])
    w = (torch.ones((len(edges),), dtype=torch.float32, device=dev) if weights is None
         else torch.as_tensor(weights, dtype=torch.float32, device=dev))
    return PoseGraph(q, t, edge_i, edge_j, meas_q, meas_t, w)


def demo_ring_graph(n_nodes: int = 96, n_loops: int = 12, span: int = 24,
                    radius: float = 400.0, seed: int = 3,
                    device="cuda") -> PoseGraph:
    """Deterministic loop-closure ring graph (a fixture shared by
    the tests and chip_smoke.py): a circle of ``n_nodes`` poses with noisy odometry edges plus
    ``span``-node loop closures; the initial guess is the drifted odometry
    chain. Built on the CPU, then moved to ``device``, so every device gets
    the same graph bit for bit."""
    rng = np.random.default_rng(seed)
    ts = np.stack([[radius * np.cos(2 * np.pi * i / n_nodes), 0.0,
                    radius * np.sin(2 * np.pi * i / n_nodes)]
                   for i in range(n_nodes)]).astype(np.float32)
    q_id = qidentity(torch.float32, "cpu")
    gt = [se3.Pose(q_id, torch.from_numpy(ts[i])) for i in range(n_nodes)]
    edges = [(i, i + 1) for i in range(n_nodes - 1)]
    edges += [(int(i), int(i) + span)
              for i in rng.integers(0, n_nodes - span - 1, n_loops)]
    meas = []
    for (i, j) in edges:
        xi = np.concatenate([rng.normal(0, 0.5, 3),
                             0.05 * np.pi / 180 * rng.normal(0, 1, 3)])
        meas.append(se3.compose(se3.exp(torch.from_numpy(xi.astype(np.float32))),
                                se3.relative(gt[i], gt[j])))
    init = [se3.Pose.identity(device="cpu")]
    for k in range(n_nodes - 1):
        init.append(se3.compose(init[-1], meas[k]))
    graph = graph_from_poses([p.q for p in init], [p.t for p in init], edges, meas)
    return PoseGraph(*(x.to(device) for x in graph))


def edge_residual(xi_i, xi_j, pose_i: se3.Pose, pose_j: se3.Pose,
                  meas: se3.Pose) -> torch.Tensor:
    """Residual of one edge (or a batch), parameterized by local updates xi
    around the current linearization points (left-multiplicative
    retraction)."""
    Xi = se3.retract(pose_i, xi_i)
    Xj = se3.retract(pose_j, xi_j)
    return se3.log(se3.compose(se3.inverse(meas),
                               se3.compose(se3.inverse(Xi), Xj)))


def _edge_jacobians(q_i, t_i, q_j, t_j, meas_q, meas_t):
    """(r0 (6,), Ji (6, 6), Jj (6, 6)) of one edge at xi = 0, by
    forward-mode autodiff."""
    def residual(xi_i, xi_j):
        r = edge_residual(xi_i, xi_j, se3.Pose(q_i, t_i), se3.Pose(q_j, t_j),
                          se3.Pose(meas_q, meas_t))
        return r, r

    zero = torch.zeros((6,), dtype=t_i.dtype, device=t_i.device)
    (Ji, Jj), r0 = jacfwd(residual, argnums=(0, 1), has_aux=True)(zero, zero)
    return r0, Ji, Jj


def _linearize(graph: PoseGraph, q, t):
    """(r0 (E, 6), Ji (E, 6, 6), Jj (E, 6, 6)) at the given node poses."""
    ei, ej = graph.edge_i, graph.edge_j
    return vmap(_edge_jacobians)(q[ei], t[ei], q[ej], t[ej], graph.meas_q, graph.meas_t)


def _residuals(graph: PoseGraph, q, t) -> torch.Tensor:
    """(E, 6) edge residuals at the given node poses."""
    ei, ej = graph.edge_i, graph.edge_j
    zero = torch.zeros((6,), dtype=t.dtype, device=t.device)
    return edge_residual(zero, zero, se3.Pose(q[ei], t[ei]), se3.Pose(q[ej], t[ej]),
                         se3.Pose(graph.meas_q, graph.meas_t))


def _cost(graph: PoseGraph, q, t) -> torch.Tensor:
    r = _residuals(graph, q, t)
    return torch.sum(r * r * graph.weight[:, None])


def _incidence(edge: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """(E, n) matrix with a 1.0 at (e, edge[e]): incidence^T x sums
    per-edge rows onto the nodes, deterministically."""
    return (edge[:, None] == torch.arange(n, device=edge.device)[None, :]).to(dtype)


def _assemble_system(graph: PoseGraph, q, t, inc_i, inc_j):
    """Dense GN normal system: (H (6n, 6n), b (6n,), cost), as A^T W A and
    A^T W r of the (6E, 6n) edge Jacobian A (Ji in node i's columns, Jj in
    node j's)."""
    r0, Ji, Jj = _linearize(graph, q, t)
    e, n = inc_i.shape
    A = (Ji[:, :, None, :] * inc_i[:, None, :, None]
         + Jj[:, :, None, :] * inc_j[:, None, :, None]).reshape(6 * e, 6 * n)
    WA = A * graph.weight.repeat_interleave(6)[:, None]
    H = WA.T @ A
    b = WA.T @ r0.reshape(6 * e)
    cost = torch.sum(r0 * r0 * graph.weight[:, None])
    return H, b, cost


def _solve_dense(H, b, n: int, lam, fix_first: bool):
    """Dense gauge-anchored LM solve: dx = -(H + lam*diag(H))^-1 b.

    Marquardt scaling (lambda scales the diagonal of H, floored) makes
    lambda dimensionless and keeps padded zero-diagonal nodes exactly
    stationary."""
    # Marquardt scale from diagonal(H) BEFORE the gauge anchor: the anchor
    # enters the system separately, not the scale (as in the PCG path's
    # _finish_precond; with the anchor included node 0 would receive an
    # extra lam*1e12 damping term, up to 1e20 near the float32 range).
    d = torch.clamp_min(torch.diagonal(H), _DIAG_FLOOR)
    if fix_first:
        idx = torch.arange(6 * n, device=H.device)
        H = H + torch.diag(torch.where(idx < 6, 1e12, 0.0).to(H.dtype))
    H = H + lam * torch.diag(d)
    x, _ = torch.linalg.solve_ex(H, b)
    return -x.reshape(n, 6)


def _retract_all(q, t, dx):
    new = se3.retract(se3.Pose(q, t), dx)
    return new.q, new.t


def _lm_select(ok, q_new, t_new, q, t, lam):
    """Accept / reject shared by both LM loops: two selects and the
    clipped lambda schedule."""
    q = torch.where(ok, q_new, q)
    t = torch.where(ok, t_new, t)
    lam = torch.clamp(torch.where(ok, lam * _LM_DOWN, lam * _LM_UP), _LM_MIN, _LM_MAX)
    return q, t, lam


def optimize(graph: PoseGraph, iterations: int = 10,
             damping: float = 1e-4, fix_first: bool = True) -> PoseGraph:
    """Levenberg-Marquardt pose-graph optimization (dense inner solve).

    The first node is gauge-fixed (anchored) by default. Each iteration
    builds the dense 6N x 6N normal system, solves it with LU
    (``solve_ex``: no host read) and keeps the candidate step only if it
    lowers the finite total cost. ``damping`` is the initial
    dimensionless lambda. Runs ``iterations`` iterations with no host read.
    """
    q, t = _lm_dense(graph, graph.q.shape[0], iterations, damping, fix_first)
    return graph._replace(q=q, t=t)


def one_device_psum(tree):
    """The ``psum`` hook of a solve on one device: its partials are already
    the whole sums."""
    return tree


def _lm_dense(graph: PoseGraph, n: int, iterations: int, damping: float,
              fix_first: bool, psum=one_device_psum):
    """The dense LM loop over ``graph``'s edges; ``psum`` sums the system's
    partials and the candidate's cost over the ranks that hold the other
    edges (the identity on one device). Returns (q, t)."""
    q, t = graph.q, graph.t
    inc_i = _incidence(graph.edge_i, n, t.dtype)
    inc_j = _incidence(graph.edge_j, n, t.dtype)
    lam = torch.full((), damping, dtype=t.dtype, device=t.device)
    for _ in range(iterations):
        H, b, cost = psum(_assemble_system(graph, q, t, inc_i, inc_j))
        dx = _solve_dense(H, b, n, lam, fix_first)
        q_new, t_new = _retract_all(q, t, dx)
        new_cost = psum(_cost(graph, q_new, t_new))
        ok = torch.isfinite(new_cost) & (new_cost < cost)
        q, t, lam = _lm_select(ok, q_new, t_new, q, t, lam)
    return q, t


def _edge_partials(graph: PoseGraph, q, t, inc_i, inc_j):
    """Per-edge linearization (r0, Ji, Jj) and the gradient b = J^T W r
    summed onto the nodes (n, 6)."""
    r0, Ji, Jj = _linearize(graph, q, t)
    wr = r0 * graph.weight[:, None]
    b = (inc_i.T @ torch.einsum("ekr,ek->er", Ji, wr)
         + inc_j.T @ torch.einsum("ekr,ek->er", Jj, wr))
    return r0, Ji, Jj, b


def _hvp(graph: PoseGraph, Ji, Jj, inc_i, inc_j):
    """Matrix-free J^T W J v: one gather a side, two batched 6x6 products
    and one incidence product a side, no damping or anchor terms."""
    w = graph.weight[:, None]

    def hvp(v):
        yi = torch.einsum("ekr,er->ek", Ji, v[graph.edge_i])
        yj = torch.einsum("ekr,er->ek", Jj, v[graph.edge_j])
        wy = (yi + yj) * w
        return (inc_i.T @ torch.einsum("ekr,ek->er", Ji, wy)
                + inc_j.T @ torch.einsum("ekr,ek->er", Jj, wy))

    return hvp


def _diag_blocks(graph: PoseGraph, Ji, Jj, inc_i, inc_j):
    """Diagonal 6x6 blocks of J^T W J (no damping), (n, 6, 6)."""
    w = graph.weight[:, None, None]
    Hii = torch.matmul(Ji.transpose(1, 2), Ji * w).reshape(-1, 36)
    Hjj = torch.matmul(Jj.transpose(1, 2), Jj * w).reshape(-1, 36)
    return (inc_i.T @ Hii + inc_j.T @ Hjj).reshape(-1, 6, 6)


def _finish_precond(D, lam, anchor: float, first):
    """From the diagonal blocks D: the Marquardt diagonal scale dscale
    (n, 6) and the damped, anchored block-Jacobi inverse Minv."""
    dscale = torch.clamp_min(torch.diagonal(D, dim1=1, dim2=2), _DIAG_FLOOR)
    eye = torch.eye(6, dtype=D.dtype, device=D.device)
    Dd = D + lam * torch.diag_embed(dscale)
    Dd = Dd + torch.where(first[:, :, None], anchor * eye, 0.0)
    # dscale excludes the anchor: it enters the hvp separately, not the scale.
    Minv, _ = torch.linalg.inv_ex(Dd)
    return dscale, Minv


def _pcg(hvp, Minv, b, iters: int):
    """Fixed-iteration preconditioned CG for H x = -b (x0 = 0): a static
    trip count and no data-dependent control flow, so no host read."""
    def apply_M(r):
        return torch.einsum("nij,nj->ni", Minv, r)

    x = torch.zeros_like(b)
    r = -b  # residual of H x + b at x = 0
    z = apply_M(r)
    p = z
    for _ in range(iters):
        Hp = hvp(p)
        rz = torch.sum(r * z)
        denom = torch.sum(p * Hp)
        alpha = rz / torch.where(torch.abs(denom) > 1e-30, denom, 1.0)
        x = x + alpha * p
        r_new = r - alpha * Hp
        z_new = apply_M(r_new)
        beta = torch.sum(r_new * z_new) / torch.where(torch.abs(rz) > 1e-30, rz, 1.0)
        p = z_new + beta * p
        r, z = r_new, z_new
    return x


def optimize_pcg(graph: PoseGraph, iterations: int = 10,
                 cg_iterations: int = 32, damping: float = 1e-4,
                 fix_first: bool = True,
                 anchor_weight: float = 1e6) -> PoseGraph:
    """Levenberg-Marquardt with a matrix-free PCG inner solve.

    Never forms the 6N x 6N system: each CG iteration is a gather, batched
    6x6 products and incidence products. Block-Jacobi preconditioning keeps
    CG iteration counts low on chain + loop graphs. The same adaptive
    accept / reject as :func:`optimize`, with no host read.
    """
    q, t = _lm_pcg(graph, graph.q.shape[0], iterations, cg_iterations, damping,
                   fix_first, anchor_weight)
    return graph._replace(q=q, t=t)


def _lm_pcg(graph: PoseGraph, n: int, iterations: int, cg_iterations: int,
            damping: float, fix_first: bool, anchor_weight: float,
            psum=one_device_psum):
    """The LM-PCG loop over ``graph``'s edges; ``psum`` sums the gradient,
    the preconditioner blocks, the costs and each J^T W J v partial over the
    ranks that hold the other edges (the identity on one device). Damping
    and the anchor are added once, after it. Returns (q, t)."""
    q, t = graph.q, graph.t
    anchor = anchor_weight if fix_first else 0.0
    inc_i = _incidence(graph.edge_i, n, t.dtype)
    inc_j = _incidence(graph.edge_j, n, t.dtype)
    first = (torch.arange(n, device=t.device) == 0)[:, None]
    lam = torch.full((), damping, dtype=t.dtype, device=t.device)
    for _ in range(iterations):
        r0, Ji, Jj, b = _edge_partials(graph, q, t, inc_i, inc_j)
        cost = torch.sum(r0 * r0 * graph.weight[:, None])
        D = _diag_blocks(graph, Ji, Jj, inc_i, inc_j)
        b, D, cost = psum((b, D, cost))
        dscale, Minv = _finish_precond(D, lam, anchor, first)
        raw = _hvp(graph, Ji, Jj, inc_i, inc_j)

        def hvp(v, raw=raw, dscale=dscale, lam=lam):
            out = psum(raw(v)) + lam * dscale * v
            return torch.where(first, out + anchor * v, out)

        dx = _pcg(hvp, Minv, b, cg_iterations)
        q_new, t_new = _retract_all(q, t, dx)
        new_cost = psum(_cost(graph, q_new, t_new))
        ok = torch.isfinite(new_cost) & (new_cost < cost)
        q, t, lam = _lm_select(ok, q_new, t_new, q, t, lam)
    return q, t


def pad_edges(graph: PoseGraph, multiple: int) -> PoseGraph:
    """Pad the edge arrays to a multiple with zero-weight identity
    self-edges on node 0: they contribute nothing."""
    e = graph.edge_i.shape[0]
    pad = -(-e // multiple) * multiple - e
    if pad == 0:
        return graph
    dev = graph.t.device
    zq = qidentity(graph.q.dtype, dev).repeat(pad, 1)
    zi = torch.zeros((pad,), dtype=graph.edge_i.dtype, device=dev)
    return graph._replace(
        edge_i=torch.cat([graph.edge_i, zi]),
        edge_j=torch.cat([graph.edge_j, zi]),
        meas_q=torch.cat([graph.meas_q, zq]),
        meas_t=torch.cat([graph.meas_t, torch.zeros((pad, 3), dtype=graph.t.dtype,
                                                     device=dev)]),
        weight=torch.cat([graph.weight, torch.zeros((pad,), dtype=graph.weight.dtype,
                                                     device=dev)]),
    )


def pad_nodes(graph: PoseGraph, multiple: int) -> PoseGraph:
    """Pad the node arrays to a multiple with identity poses touched by no
    edge: their normal-equation block is damping only, so their update is
    exactly zero and the solve over the real nodes is unaffected (the
    incremental smoother then sees one graph size per power of two)."""
    n = graph.q.shape[0]
    pad = -(-n // multiple) * multiple - n
    if pad == 0:
        return graph
    dev = graph.t.device
    iq = qidentity(graph.q.dtype, dev).repeat(pad, 1)
    return graph._replace(q=torch.cat([graph.q, iq]),
                          t=torch.cat([graph.t, torch.zeros((pad, 3), dtype=graph.t.dtype,
                                                            device=dev)]))


def _edge_shard(graph: PoseGraph, mesh) -> PoseGraph:
    """This dp rank's block of the edges (the poses whole), on its device."""
    n_dp = mesh.shape["dp"]
    e = graph.edge_i.shape[0]
    if e % n_dp != 0:
        raise ValueError(f"{e} edges must divide evenly over dp={n_dp}: pad_edges first")
    per = e // n_dp
    lo = mesh.dp_index * per
    return PoseGraph(graph.q.to(mesh.device), graph.t.to(mesh.device),
                     *(x[lo:lo + per].to(mesh.device) for x in graph[2:]))


def make_sharded_optimize(mesh, n_nodes: int, iterations: int = 10,
                          damping: float = 1e-4, fix_first: bool = True):
    """Distributed dense LM: the EDGES split over the mesh's dp ranks, each
    rank's normal-system partials (H, b and the cost) combined by ONE psum
    a step, the solve and the update replicated. The candidate's cost is
    psummed too, so every rank takes the same accept / reject.

    Returns ``run(graph) -> PoseGraph``, called by every rank with the same
    whole graph, whose edge count divides evenly over dp (see
    :func:`pad_edges`); every rank returns the same poses.
    """
    from icp_tpu_torch.parallel.mesh import DP_AXIS, psum_pytree

    def run(graph: PoseGraph) -> PoseGraph:
        q, t = _lm_dense(_edge_shard(graph, mesh), n_nodes, iterations, damping, fix_first,
                         psum=lambda tree: psum_pytree(tree, DP_AXIS, mesh))
        return PoseGraph(q, t, *(x.to(mesh.device) for x in graph[2:]))

    return run


def make_sharded_optimize_pcg(mesh, n_nodes: int, iterations: int = 10,
                              cg_iterations: int = 32, damping: float = 1e-4,
                              fix_first: bool = True,
                              anchor_weight: float = 1e6):
    """Distributed matrix-free LM-PCG: the edges split over dp, the poses
    replicated. Each LM step psums the gradient, the block-diagonal
    preconditioner blocks and the cost in one all-reduce; each CG step
    psums one (n, 6) J^T W J v partial, O(n) floats where the dense path
    moves the (6n)^2 system.

    Returns ``run(graph) -> PoseGraph`` as :func:`make_sharded_optimize`.
    """
    from icp_tpu_torch.parallel.mesh import DP_AXIS, psum_pytree

    def run(graph: PoseGraph) -> PoseGraph:
        q, t = _lm_pcg(_edge_shard(graph, mesh), n_nodes, iterations, cg_iterations,
                       damping, fix_first, anchor_weight,
                       psum=lambda tree: psum_pytree(tree, DP_AXIS, mesh))
        return PoseGraph(q, t, *(x.to(mesh.device) for x in graph[2:]))

    return run


def graph_cost(graph: PoseGraph) -> torch.Tensor:
    """Total weighted squared residual of the graph (diagnostic)."""
    return _cost(graph, graph.q, graph.t)
