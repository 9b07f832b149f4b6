"""Row-wise prefix scans (port of ``icp_tpu.ops.scan``), the parity API
for the reference's generic ``Scan``: ``torch.cumsum``, and for the
exclusive scan the same shifted by one with the identity in front. The
result keeps the input's dtype, as ``jnp.cumsum`` does (``torch.cumsum``
widens integers to int64)."""

from __future__ import annotations

import torch


def inclusive_scan(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Row-wise inclusive prefix sum (reference ``Scan<INCLUSIVE>``)."""
    return torch.cumsum(x, dim=axis, dtype=x.dtype)


def exclusive_scan(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Row-wise exclusive prefix sum (reference ``Scan<EXCLUSIVE>``)."""
    inc = torch.cumsum(x, dim=axis, dtype=x.dtype)
    n = x.shape[axis]
    zero = torch.zeros_like(inc.narrow(axis, 0, 1))
    return torch.cat([zero, inc.narrow(axis, 0, n - 1)], dim=axis)
