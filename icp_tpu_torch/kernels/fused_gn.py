"""The fused Gauss-Newton hot loop of PLANE / GICP (port of
``icp_tpu.kernels.fused_gn``, its "sublane" layout).

Every GN row of the normal-consuming objectives has the form

    v = [u, m x u, u . (m - f), 1]          (8 lanes)

for a direction u and a per-row weight g: the point-to-plane row has u = n_f
(or the symmetric n_f + n_m), g = 1. GICP's Mahalanobis weight
M^{-1} = (2I - e(n_f n_f^T + n_m n_m^T))^{-1} splits exactly into
I/2 + g_s s s^T + g_t t t^T with s = n_f + n_m, t = n_f - n_m, c = n_f . n_m,
e = 1 - eps, g_s = e / (4(2 - e(1 + c))) and g_t = e / (4(2 - e(1 - c))), so
GICP is two data rows plus an isotropic term, which the kernel carries as a
second moment P_z = sum w z z^T over z = [m, d, 1, 0];
:func:`gicp_const_moment` expands it outside the kernel.

:func:`bin_gn_moments` (K7, ``csrc/bin_gn_moments.cu``) searches each bin
as K3 does and reduces the rows to one 8x8 matrix per bin,
P_b = sum_i (w_i g_i) v_i v_i^T, with m centered on the bin's
representative. :func:`gn_v_total` moves the bins to the common frame
(V = sum_b T_b P_b T_b^T, linear in P, hoisted into
:func:`gn_translation_tensor` at index build) and :func:`gn_system_from_V`
reads the balanced 6x6 system off V for ``icp.plane.solve_plane_system``.
"""

from __future__ import annotations

import torch

from icp_tpu_torch.kernels import native
from icp_tpu_torch.kernels.fused_step import (
    device_scalars,
    match_weights_ref,
    robust_kind,
    search_ref,
)

GN_MODES = ("plane", "plane_sym", "gicp")


def _gn_rows(m: torch.Tensor, d: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(..., 8) rows v = [u, m x u, u . d, 1] from (..., 3) m, d and u."""
    mx, my, mz = m.unbind(-1)
    ux, uy, uz = u.unbind(-1)
    jx = my * uz - mz * uy
    jy = mz * ux - mx * uz
    jz = mx * uy - my * ux
    r = d[..., 0] * ux + d[..., 1] * uy + d[..., 2] * uz
    return torch.stack([ux, uy, uz, jx, jy, jz, r, torch.ones_like(r)], dim=-1)


def _moment(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bqi,bqj->bij", v * w[..., None], v)


def bin_gn_moments_ref(mg: torch.Tensor, nm: torch.Tensor | None,
                       qvalid: torch.Tensor, reps: torch.Tensor,
                       bins_vals: torch.Tensor, sq_b_masked: torch.Tensor,
                       G: torch.Tensor, b_row: torch.Tensor, alpha, *,
                       mode: str, weighted: bool, robust: str = "none",
                       robust_delta=0.0, gicp_eps=0.0):
    """Plain twin of :func:`bin_gn_moments` (the JAX package's ``_gn_math``
    in its "sublane" layout); same return convention."""
    if mode not in GN_MODES:
        raise ValueError(f"mode must be one of {GN_MODES}, got {mode!r}")
    qc, best_score, best_slot, sq_q, valid0 = search_ref(
        mg, qvalid, reps, bins_vals, sq_b_masked, G, b_row, alpha)
    w = match_weights_ref(best_score, sq_q, valid0, weighted=weighted,
                          robust=robust, robust_delta=robust_delta)
    matched = torch.gather(bins_vals, 1, best_slot[..., None].expand(
        -1, -1, bins_vals.shape[2]))
    m = qc[..., :3]
    d = m - matched[..., :3]
    nf = matched[..., 8:11]
    if mode == "plane":
        return _moment(_gn_rows(m, d, nf), w)
    nmv = nm[..., :3]
    if mode == "plane_sym":
        # Rusinkiewicz's symmetric objective: the averaged fixed + moving
        # normal (zero moving normals fall back to the one-sided row).
        return _moment(_gn_rows(m, d, nf + nmv), w)
    e = 1.0 - torch.as_tensor(gicp_eps, dtype=mg.dtype, device=mg.device)
    cth = torch.sum(nf * nmv, dim=-1)
    gs = e / (4.0 * (2.0 - e * (1.0 + cth)))
    gt = e / (4.0 * (2.0 - e * (1.0 - cth)))
    P = (_moment(_gn_rows(m, d, nf + nmv), w * gs)
         + _moment(_gn_rows(m, d, nf - nmv), w * gt))
    ones = torch.ones_like(m[..., :1])
    z = torch.cat([m, d, ones, torch.zeros_like(ones)], dim=-1)
    return P, _moment(z, w)


def bin_gn_moments(mg: torch.Tensor, nm: torch.Tensor | None,
                   qvalid: torch.Tensor, reps: torch.Tensor,
                   bins_vals: torch.Tensor, sq_b_masked: torch.Tensor,
                   G: torch.Tensor, b_row: torch.Tensor, alpha, *, mode: str,
                   weighted: bool, robust: str = "none", robust_delta=0.0,
                   gicp_eps=0.0):
    """Fused per-bin search + weighting + GN-row moment reduction; K7,
    replacing ``icp_tpu.kernels.fused_gn.bin_gn_moments_pallas``.

    Args:
      mg: (n_r, cq, 8) bin-grouped RAW moving rows. On CUDA its rows may be
        lanes 0:8 of a wider grouped table (row stride read from the view).
      nm: (n_r, cq, 3) grouped moving normals rotated into the fixed frame
        ("plane_sym" / "gicp"; None for "plane"), likewise strided.
      qvalid: (n_r, cq) float32 slot validity.
      reps: (n_r, 8) representatives.
      bins_vals: (n_r, cb, 12) ``[bins_centered | bin_normals | 0]``.
      sq_b_masked: (n_r, cb) masked |b|^2_w.
      G, b_row: accumulated similarity (``fused_step.prep_similarity``).
      alpha, robust_delta, gicp_eps: floats or 0-d tensors (read on the
        device).
      mode: "plane" | "plane_sym" | "gicp".
      weighted, robust: residual weighting as in K3.
    Returns:
      (n_r, 8, 8) per-bin GN moments; "gicp" returns the pair (P, P_z).
    """
    if mode not in GN_MODES:
        raise ValueError(f"mode must be one of {GN_MODES}, got {mode!r}")
    if mode != "plane" and nm is None:
        raise ValueError(f"mode {mode!r} needs the moving normals nm")
    if mg.device.type == "cpu":
        return bin_gn_moments_ref(mg, nm, qvalid, reps, bins_vals,
                                  sq_b_masked, G, b_row, alpha, mode=mode,
                                  weighted=weighted, robust=robust,
                                  robust_delta=robust_delta, gicp_eps=gicp_eps)
    native.require_cuda(mg, "mg")
    dev = mg.device
    n_r, cq, _ = mg.shape
    cb = bins_vals.shape[1]
    f32 = torch.float32
    ld_mg = native.require_rows(mg, "mg", (n_r, cq, 8), f32, dev)
    nm_ptr, ld_nm = None, 0  # "plane" reads no moving normal
    if mode != "plane":
        ld_nm = native.require_rows(nm, "nm", (n_r, cq, 3), f32, dev)
        nm_ptr = nm.data_ptr()
    native.require(qvalid, "qvalid", (n_r, cq), f32, dev)
    native.require(reps, "reps", (n_r, 8), f32, dev)
    native.require(bins_vals, "bins_vals", (n_r, cb, 12), f32, dev)
    native.require(sq_b_masked, "sq_b_masked", (n_r, cb), f32, dev)
    native.require(G, "G", (8, 8), f32, dev)
    native.require(b_row, "b_row", (1, 8), f32, dev)
    kind = robust_kind(robust)
    scal = device_scalars(dev, alpha, robust_delta, gicp_eps)
    P = torch.empty((n_r, 8, 8), dtype=f32, device=dev)
    Pz = torch.empty((n_r, 8, 8), dtype=f32, device=dev) if mode == "gicp" else None
    native.launch(
        "icp_bin_gn_moments", dev, mg.data_ptr(), ld_mg, nm_ptr, ld_nm, qvalid.data_ptr(),
        reps.data_ptr(), bins_vals.data_ptr(), sq_b_masked.data_ptr(), G.data_ptr(),
        b_row.data_ptr(), scal.data_ptr(), n_r, cq, cb, GN_MODES.index(mode), int(weighted),
        kind, P.data_ptr(), None if Pz is None else Pz.data_ptr())
    return (P, Pz) if mode == "gicp" else P


def gicp_const_moment(P_z: torch.Tensor) -> torch.Tensor:
    """GICP's isotropic-I/2 moment block from the z-moment.

    The three constant-direction rows v_k = B e_k with
    B = [I3; skew(m); d^T; 1^T] (8 x 3) sum to sum_i (w_i / 2) B_i B_i^T,
    which is linear in P_z = sum_i w_i z_i z_i^T, z = [m, d, 1, 0]. Block
    identities (S := skew(m)): S S^T = |m|^2 I - m m^T, S d = m x d,
    S 1 = m x 1.
    """
    Mm = P_z[:, 0:3, 0:3]
    Md = P_z[:, 3:6, 3:6]
    Mmd = P_z[:, 0:3, 3:6]
    sw = P_z[:, 6, 6]
    sm = P_z[:, 0:3, 6]
    sd = P_z[:, 3:6, 6]
    eye3 = torch.eye(3, dtype=P_z.dtype, device=P_z.device)
    ones3 = torch.ones((3, 1), dtype=P_z.dtype, device=P_z.device)

    def skew(v):
        z = torch.zeros_like(v[:, 0])
        return torch.stack([
            torch.stack([z, -v[:, 2], v[:, 1]], -1),
            torch.stack([v[:, 2], z, -v[:, 0]], -1),
            torch.stack([-v[:, 1], v[:, 0], z], -1)], -2)

    S_sm = skew(sm)
    cross_md = torch.stack([Mmd[:, 1, 2] - Mmd[:, 2, 1],
                            Mmd[:, 2, 0] - Mmd[:, 0, 2],
                            Mmd[:, 0, 1] - Mmd[:, 1, 0]], -1)  # sum w m x d
    m_x_1 = torch.stack([sm[:, 1] - sm[:, 2],
                         sm[:, 2] - sm[:, 0],
                         sm[:, 0] - sm[:, 1]], -1)             # sum w m x 1
    tr_Mm = Mm.diagonal(dim1=1, dim2=2).sum(-1)
    tr_Md = Md.diagonal(dim1=1, dim2=2).sum(-1)
    sum_sd = torch.sum(sd, dim=1, keepdim=True)

    top = torch.cat([sw[:, None, None] * eye3, -S_sm, sd[:, :, None],
                     sw[:, None, None] * ones3], dim=2)              # (n_b, 3, 8)
    mid = torch.cat([S_sm, tr_Mm[:, None, None] * eye3 - Mm,
                     cross_md[:, :, None], m_x_1[:, :, None]], dim=2)
    r6 = torch.cat([sd, cross_md, tr_Md[:, None], sum_sd], dim=1)[:, None]
    r7 = torch.cat([sw[:, None] * ones3[:, 0], m_x_1, sum_sd,
                    3.0 * sw[:, None]], dim=1)[:, None]
    return 0.5 * torch.cat([top, mid, r6, r7], dim=1)


def _gn_T(reps: torch.Tensor) -> torch.Tensor:
    """(n_b, 8, 8) per-bin frame-translation factors: identity plus
    skew(rep_xyz) in the (3:6, 0:3) block, so v_global = T v_local."""
    rx, ry, rz = reps[:, 0], reps[:, 1], reps[:, 2]
    z = torch.zeros_like(rx)
    S = torch.stack([torch.stack([z, -rz, ry], -1),
                     torch.stack([rz, z, -rx], -1),
                     torch.stack([-ry, rx, z], -1)], -2)
    T = torch.eye(8, dtype=reps.dtype, device=reps.device).repeat(
        reps.shape[0], 1, 1)
    T[:, 3:6, 0:3] = S
    return T


def gn_v_total(P: torch.Tensor, reps: torch.Tensor,
               W_t: torch.Tensor | None = None) -> torch.Tensor:
    """Global (8, 8) GN moment matrix V = sum_b T_b P_b T_b^T; with ``W_t``
    (:func:`gn_translation_tensor`) one (1, n_b*64) x (n_b*64, 64) product."""
    if W_t is not None:
        n_b = P.shape[0]
        return (P.reshape(1, n_b * 64) @ W_t.reshape(n_b * 64, 64)).reshape(8, 8)
    T = _gn_T(reps)
    return torch.einsum("bij,bjk,blk->il", T, P, T)


def gn_translation_tensor(reps: torch.Tensor) -> torch.Tensor:
    """(n_b, 8, 8, 64) coefficients of :func:`gn_v_total`, built once per
    index with ``torch.func.jacrev`` of the direct congruence."""
    jac = torch.func.jacrev(lambda P: gn_v_total(P, reps).reshape(64))(
        reps.new_zeros((reps.shape[0], 8, 8)))  # (64, n_b, 8, 8)
    return jac.permute(1, 2, 3, 0).contiguous()


def gn_system_from_V(V: torch.Tensor, L: float):
    """(H (6, 6), b (6,)) in ``icp.plane``'s balanced units: the rotation
    rows and columns of V (built with m x u in raw mm) divided by L."""
    one = torch.ones(3, dtype=V.dtype, device=V.device)
    d = torch.cat([one, torch.full_like(one, 1.0 / L), one[:2]])
    Vs = V * d[:, None] * d[None, :]
    return Vs[0:6, 0:6], Vs[0:6, 6]
