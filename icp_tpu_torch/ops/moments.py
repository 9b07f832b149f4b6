"""Residual weights and the robust M-estimator scale (port of the weighting
part of ``icp_tpu.ops.moments``).

:func:`compute_weights` is the reference's ``icpComputeReduceWeights``;
:func:`robust_factor` the IRLS factor of the optional robust kernel (it
multiplies into the reference weight inside K3, K7 and their twins);
:func:`adaptive_robust_delta` derives the robust scale from the median
residual of the current iteration, on the device.
"""

from __future__ import annotations

import torch

ROBUST_KINDS = ("none", "huber", "tukey", "trimmed")

# Per-kernel multiples of median(|r|) for the adaptive scale: Huber's
# c = 1.345 sigma and Tukey's c = 4.685 sigma with sigma ~ 1.4826 median(|r|)
# give ~2 and ~7; TRIMMED at 3x rejects the gross tail.
_ADAPTIVE_K = {"huber": 2.0, "tukey": 7.0, "trimmed": 3.0}


def compute_weights(dists: torch.Tensor) -> torch.Tensor:
    """Correspondence weights ``w_i = 100 / (100 + d_i)`` of the blended
    squared NN distances ``d_i``."""
    return 100.0 / (100.0 + dists)


def robust_factor(d2: torch.Tensor, kind: str, delta) -> torch.Tensor:
    """IRLS weight of a robust M-estimator on the blended squared distance.

    ``delta`` is in blended distance units (d^2 is compared against
    delta^2): Huber ``min(1, delta / |r|)``, Tukey ``(1 - d^2/delta^2)_+^2``,
    TRIMMED ``d^2 <= delta^2``; "none" gives ones.
    """
    if kind == "none":
        return torch.ones_like(d2)
    if kind not in ROBUST_KINDS:
        raise ValueError(f"unknown robust kernel: {kind!r}")
    delta = torch.as_tensor(delta, dtype=d2.dtype, device=d2.device)
    d2 = torch.clamp(d2, min=0.0)
    if kind == "huber":
        # Exact 1 at r = 0 through the rsqrt guard.
        return torch.clamp(delta * torch.rsqrt(torch.clamp(d2, min=1e-12)), max=1.0)
    if kind == "tukey":
        z = torch.clamp(1.0 - d2 / (delta * delta), min=0.0)
        return z * z
    return (d2 <= delta * delta).to(d2.dtype)


def masked_median(x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Lower median of ``x`` over ``mask``, 0 when nothing is valid.

    One sort (invalid entries sort to +inf) and a gather at the device-side
    index (count - 1) // 2: the host never reads a value.
    """
    x = x.reshape(-1)
    if mask is not None:
        mask = mask.reshape(-1)
        x = torch.where(mask, x, torch.full_like(x, float("inf")))
        cnt = torch.sum(mask.to(torch.int64))
    else:
        cnt = torch.full((), x.numel(), dtype=torch.int64, device=x.device)
    s, _ = torch.sort(x)
    med = torch.gather(s, 0, (torch.clamp(cnt - 1, min=0) // 2).reshape(1))[0]
    return torch.where(cnt > 0, med, torch.zeros_like(med))


def adaptive_robust_delta(d2: torch.Tensor, mask: torch.Tensor | None,
                          kind: str) -> torch.Tensor:
    """Per-iteration robust scale ``K_kind * sqrt(median(d2))`` over the valid
    pairs, floored at 1e-3 so an all-zero residual set keeps its weights."""
    med_r = torch.sqrt(torch.clamp(masked_median(d2, mask), min=0.0))
    return torch.clamp(_ADAPTIVE_K[kind] * med_r, min=1e-3)
