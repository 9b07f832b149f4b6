"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``; they skip where ``torch.cuda.is_available()`` is False.
The file imports neither jax nor the repo's conftest helpers, so on a
machine with a GPU and no jax it runs as

    python -m pytest tests/test_torch_gpu.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_pair

pytestmark = pytest.mark.cuda

M, N_R = 16384, 256


@pytest.fixture(scope="module")
def flagship():
    """First-iteration tensors of the flagship pair on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from icp_tpu_torch import ICPConfig, ICPParams
    from icp_tpu_torch.icp.run import build_index
    from icp_tpu_torch.icp.state import identity_state
    from icp_tpu_torch.kernels import fused_step as fs

    dev = torch.device("cuda", 0)
    fixed, moving = (torch.from_numpy(a).to(dev) for a in _synthetic_pair(M))
    cfg = ICPConfig()
    params = ICPParams(alpha=2e2).to(dev)
    index = build_index(fixed, params, cfg)
    st = identity_state(torch.float32, dev)
    G, b_row = fs.prep_similarity(st.q, st.t, st.s)
    C, srow = fs.prep_rep_assign(index.reps, params.alpha, G, b_row)
    return dict(dev=dev, cfg=cfg, params=params, index=index, moving=moving,
                fixed=fixed, G=G.contiguous(), b_row=b_row, C=C.contiguous(),
                srow=srow)


def test_rep_assign_counts_kernel_matches_twin(flagship):
    from icp_tpu_torch.kernels import fused_step as fs

    f = flagship
    before = fs.rep_assign_counts.launches
    rid, counts = fs.rep_assign_counts(f["moving"], f["C"], f["srow"])
    rid_t, counts_t = fs.rep_assign_counts_ref(f["moving"], f["C"], f["srow"])
    torch.cuda.synchronize()
    assert fs.rep_assign_counts.launches == before + 1
    assert torch.equal(counts, torch.bincount(rid, minlength=N_R).to(torch.int32))
    assert int(counts.sum()) == M
    # Same rounding as the twin (lane order, bf16x3): the same picks.
    assert torch.equal(rid, rid_t) and torch.equal(counts, counts_t)


def test_bin_table_kernel_bitwise(flagship):
    from icp_tpu_torch.kernels import table_build as tb

    f = flagship
    g = torch.Generator(device="cpu").manual_seed(0)
    for d, cap in ((8, f["cfg"].query_capacity), (9, f["cfg"].bin_capacity)):
        rows = torch.randn(M, d, generator=g).to(f["dev"])
        counts = torch.bincount(torch.randint(0, N_R, (M,), generator=g),
                                minlength=N_R).to(f["dev"])
        starts = (torch.cumsum(counts, 0) - counts).to(torch.int32)
        got = tb.bin_table(rows, starts, capacity=cap)
        want = tb.bin_table_ref(rows, starts, capacity=cap)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("weighted", [True, False])
def test_bin_point_moments_kernel_matches_twin(flagship, weighted):
    from icp_tpu_torch.kernels import fused_step as fs
    from icp_tpu_torch.rbc.grouping import group_rows_by_bin

    f = flagship
    rid, counts = fs.rep_assign_counts(f["moving"], f["C"], f["srow"])
    gl = group_rows_by_bin(rid, N_R, f["cfg"].query_capacity, (f["moving"],),
                           counts=counts)
    args = (gl.grouped[0], gl.valid.to(torch.float32), f["index"].reps,
            f["index"].bins_centered, f["index"].sq_b_masked, f["G"],
            f["b_row"], f["params"].alpha)
    P = fs.bin_point_moments(*args, weighted=weighted)
    P_t = fs.bin_point_moments_ref(*args, weighted=weighted)
    torch.cuda.synchronize()
    assert float((P - P_t).abs().max()) <= 1e-4 * float(P_t.abs().max())
    assert torch.equal(P, fs.bin_point_moments(*args, weighted=weighted))


def test_register_on_card_matches_cpu(flagship):
    from icp_tpu_torch import ICPConfig, ICPParams, register
    from icp_tpu_torch.icp.quaternion import qangle_deg, qconj, qmul

    f = flagship
    st = register(f["fixed"], f["moving"], ICPParams(alpha=2e2), ICPConfig())
    cpu = register(f["fixed"].cpu(), f["moving"].cpu(), ICPParams(alpha=2e2),
                   ICPConfig())
    assert abs(int(st.k) - int(cpu.k)) <= 1
    assert float(np.linalg.norm(st.t.cpu().numpy() - cpu.t.numpy())) <= 0.01
    assert float(qangle_deg(qmul(st.q.cpu(), qconj(cpu.q)))) <= 0.001


# ---- slice 2: K4, K7 and robust K3 on the rendered gate pair ---------------


@pytest.fixture(scope="module")
def rendered():
    """First-iteration tensors of bench.py's rendered gate pair on the card,
    with a PLANE index (normals, K7's payload) and the 11-wide grouped
    (moving8 | rotated normal) query table."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from icp_tpu_torch import ICPConfig, ICPParams, Objective
    from icp_tpu_torch.icp.quaternion import qrotate
    from icp_tpu_torch.icp.run import build_index
    from icp_tpu_torch.icp.state import identity_state
    from icp_tpu_torch.kernels import fused_step as fs
    from icp_tpu_torch.ops.normals import normals_for
    from icp_tpu_torch.ops.sampling import get_landmarks
    from icp_tpu_torch.rbc.grouping import group_rows_by_bin
    from icp_tpu_torch.sensors import synthetic

    dev = torch.device("cuda", 0)
    scene = synthetic.default_scene()
    q_b = torch.tensor([0.0, np.sin(0.004), 0.0, np.cos(0.004)], dtype=torch.float32)
    pose_b = synthetic.CameraPose(q_b, torch.tensor([10.0, -6.0, 8.0]))
    fixed, moving = (get_landmarks(synthetic.render_cloud(scene, p).reshape(-1, 8))
                     .contiguous() for p in (synthetic.CameraPose.identity(), pose_b))
    cfg = ICPConfig(objective=Objective.PLANE, estimate_scale=False)
    params = ICPParams(alpha=2e2).to(dev)
    fixed_d, moving_d = fixed.to(dev), moving.to(dev)
    index = build_index(fixed_d, params, cfg)
    st = identity_state(torch.float32, dev)
    G, b_row = fs.prep_similarity(st.q, st.t, st.s)
    G = G.contiguous()
    C, srow = fs.prep_rep_assign(index.reps, params.alpha, G, b_row)
    rid, counts = fs.rep_assign_counts(moving_d, C.contiguous(), srow)
    mnr = qrotate(st.q, normals_for(moving_d, "auto"))
    gl = group_rows_by_bin(rid, N_R, cfg.query_capacity, (moving_d, mnr), counts=counts)
    search = (index.reps, index.bins_centered, index.sq_b_masked, G, b_row, params.alpha)
    return dict(dev=dev, cfg=cfg, params=params, index=index, fixed=fixed,
                moving=moving, fixed_d=fixed_d, moving_d=moving_d, mg=gl.grouped[0],
                nm=gl.grouped[1], qvalid=gl.valid.to(torch.float32), search=search)


def test_bin_min_dists_kernel_matches_twin(rendered):
    from icp_tpu_torch.kernels import fused_step as fs

    r = rendered
    args = (r["mg"], r["qvalid"]) + r["search"]
    before = fs.bin_min_dists.launches
    got = fs.bin_min_dists(*args)  # strided rows of the 11-wide table
    want = fs.bin_min_dists_ref(*args)
    torch.cuda.synchronize()
    assert fs.bin_min_dists.launches == before + 1
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert float((got[fin] - want[fin]).abs().max()) <= 1e-6 * float(want[fin].max())


@pytest.mark.parametrize("mode", ["plane", "plane_sym", "gicp"])
def test_bin_gn_moments_kernel_matches_twin(rendered, mode):
    from icp_tpu_torch.kernels import fused_gn as fg

    r = rendered
    args = (r["mg"], None if mode == "plane" else r["nm"], r["qvalid"],
            r["index"].reps, r["index"].bins_vals12, r["index"].sq_b_masked,
            *r["search"][3:])
    kw = dict(mode=mode, weighted=True, gicp_eps=1e-3)
    got = fg.bin_gn_moments(*args, **kw)
    want = fg.bin_gn_moments_ref(*args, **kw)
    again = fg.bin_gn_moments(*args, **kw)
    torch.cuda.synchronize()
    if mode != "gicp":
        got, want, again = (got,), (want,), (again,)
    for g, w, a in zip(got, want, again):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
        assert torch.equal(g, a)  # the fixed-order reduction repeats bitwise


@pytest.mark.parametrize("robust, weighted", [("huber", True), ("trimmed", False),
                                              ("tukey", True)])
def test_bin_point_moments_robust_kernel_matches_twin(rendered, robust, weighted):
    from icp_tpu_torch.kernels import fused_step as fs

    r = rendered
    args = (r["mg"].contiguous(), r["qvalid"]) + r["search"]
    kw = dict(weighted=weighted, robust=robust, robust_delta=12.0)
    got = fs.bin_point_moments(*args, **kw)
    want = fs.bin_point_moments_ref(*args, **kw)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_plane_register_on_card_matches_cpu(rendered):
    from icp_tpu_torch import ICPParams, register
    from icp_tpu_torch.icp.quaternion import qangle_deg, qconj, qmul

    r = rendered
    st = register(r["fixed_d"], r["moving_d"], ICPParams(alpha=2e2), r["cfg"])
    cpu = register(r["fixed"], r["moving"], ICPParams(alpha=2e2), r["cfg"])
    assert abs(int(st.k) - int(cpu.k)) <= 1
    assert float(np.linalg.norm(st.t.cpu().numpy() - cpu.t.numpy())) <= 0.05
    assert float(qangle_deg(qmul(st.q.cpu(), qconj(cpu.q)))) <= 0.005
