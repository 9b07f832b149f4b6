"""Per-bin exhaustive search of the unfused RBC pipeline (port of
``icp_tpu.kernels.bin_search``).

For every grouped query slot of every bin, :func:`bin_search` (K5,
``csrc/bin_search.cu``) returns the winning score and the winner's payload:

    score[b, i]   = min_c  sq_b_masked[b, c] - 2 dot3(qg_w[b, i], bins_c[b, c])
    matched[b, i] = vals[b, argmin_c ...]          (first minimum on ties)

with the bf16x3 score contraction of ``fused_step.dot3`` (the JAX package's
bin-search scores), so the kernel and its plain twin :func:`bin_search_ref`
pick the same slot. +inf in ``sq_b_masked`` masks a slot; a bin with no
valid slot returns +inf and slot 0's payload, as ``argmin`` does.
"""

from __future__ import annotations

import torch

from icp_tpu_torch.kernels import native
from icp_tpu_torch.kernels.fused_step import dot3

# Score elements per block of bins in the twin, so a large capacity never
# forms the whole (n_r, cq, cb) score tensor at once.
REF_BLOCK_ELEMS = 1 << 22


def bin_search_ref(qg_w: torch.Tensor, bins_c: torch.Tensor,
                   sq_b_masked: torch.Tensor, vals: torch.Tensor):
    """Plain twin of :func:`bin_search` (the XLA branch of the JAX
    package's ``bin_phase2``): (best_score (n_r, cq), matched (n_r, cq, V))."""
    n_r, cq, _ = qg_w.shape
    cb = bins_c.shape[1]
    step = max(1, REF_BLOCK_ELEMS // max(cq * cb, 1))
    best, matched = [], []
    for lo in range(0, n_r, step):
        sl = slice(lo, lo + step)
        s = sq_b_masked[sl, None, :] - 2.0 * dot3(qg_w[sl, :, None, :],
                                                  bins_c[sl, None, :, :])
        slot = torch.argmin(s, dim=-1)
        best.append(torch.gather(s, -1, slot[..., None])[..., 0])
        matched.append(torch.gather(
            vals[sl], 1, slot[..., None].expand(-1, -1, vals.shape[2])))
    return torch.cat(best), torch.cat(matched)


def bin_search(qg_w: torch.Tensor, bins_c: torch.Tensor,
               sq_b_masked: torch.Tensor, vals: torch.Tensor):
    """Fused grouped bin search; K5, replacing
    ``icp_tpu.kernels.bin_search.bin_search_pallas``.

    Args:
      qg_w: (n_r, cq, 8) float32 metric-weighted rep-centered queries.
      bins_c: (n_r, cb, 8) float32 rep-centered bin points.
      sq_b_masked: (n_r, cb) float32 masked |b|^2_w (+inf on invalid slots).
      vals: (n_r, cb, V) float32 payload returned for the winner (the raw
        bin points, V = 8, or points and normals padded to V = 12).
    Returns:
      (best_score (n_r, cq), matched (n_r, cq, V)).
    """
    if qg_w.device.type == "cpu":
        return bin_search_ref(qg_w, bins_c, sq_b_masked, vals)
    native.require_cuda(qg_w, "qg_w")
    dev = qg_w.device
    n_r, cq, _ = qg_w.shape
    cb = bins_c.shape[1]
    v = vals.shape[2]
    f32 = torch.float32
    native.require(qg_w, "qg_w", (n_r, cq, 8), f32, dev)
    native.require(bins_c, "bins_c", (n_r, cb, 8), f32, dev)
    native.require(sq_b_masked, "sq_b_masked", (n_r, cb), f32, dev)
    native.require(vals, "vals", (n_r, cb, v), f32, dev)
    if cb == 0:
        raise ValueError("bin_search: bin capacity 0")
    best = torch.empty((n_r, cq), dtype=f32, device=dev)
    matched = torch.empty((n_r, cq, v), dtype=f32, device=dev)
    native.launch("icp_bin_search", dev, qg_w.data_ptr(), bins_c.data_ptr(),
                  sq_b_masked.data_ptr(), vals.data_ptr(), n_r, cq, cb, v,
                  best.data_ptr(), matched.data_ptr())
    return best, matched
