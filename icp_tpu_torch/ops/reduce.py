"""Row-wise reductions (port of ``icp_tpu.ops.reduce``): the operation
surface of the reference's generic ``Reduce<MIN / MAX / SUM, T>`` and its
float-in, double-out ``reduce_sum_fd``. No module of the port calls them;
they are kept for the API's parity.
"""

from __future__ import annotations

import torch


def reduce_min(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Row-wise minimum (reference ``Reduce<MIN, float>``)."""
    return torch.amin(x, dim=axis)


def reduce_max(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Row-wise maximum (reference ``Reduce<MAX, uint>``)."""
    return torch.amax(x, dim=axis)


def reduce_sum(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Row-wise sum (reference ``Reduce<SUM, float>``)."""
    return torch.sum(x, dim=axis)


def reduce_sum_fd(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Row-wise sum accumulated and returned in float64, the reference's
    ``reduce_sum_fd`` (float in, double out). The CPU and the card both have
    native float64, so the JAX package's compensated float32 stand-in for
    a TPU without it has no counterpart here."""
    return torch.sum(x, dim=axis, dtype=torch.float64)
