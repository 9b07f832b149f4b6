"""Coarse-to-fine pyramid registration (port of ``icp_tpu.icp.pyramid``).

Single-level ICP converges from within about one landmark spacing. The
pyramid registers strided subsamples of the organized 128x128 landmark grid
first (a 4x subsample has 4x the spacing, so ~4x the basin) and refines
level by level, each warm-started from the previous estimate. Each level is
the full pipeline (:func:`~icp_tpu_torch.icp.run.build_target`, then
:func:`~icp_tpu_torch.icp.run.icp_run`) at a smaller m.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from icp_tpu_torch.icp.run import build_target, icp_run
from icp_tpu_torch.icp.state import ICPState, identity_state
from icp_tpu_torch.ops.sampling import LM_GRID
from icp_tpu_torch.runtime.config import ICPConfig, ICPParams


def subsample_grid(landmarks8: torch.Tensor, stride: int,
                   grid: int = LM_GRID) -> torch.Tensor:
    """Strided subsample of an organized (grid*grid, 8) landmark set, the
    rows and columns off + k*stride with off = stride // 2. ``stride`` must
    divide the grid, or the level's point count would disagree with its
    config's m."""
    if stride == 1:
        return landmarks8
    if grid % stride != 0:
        raise ValueError(f"stride {stride} must divide the grid size {grid}")
    off = stride // 2
    return landmarks8.reshape(grid, grid, 8)[off::stride, off::stride].reshape(-1, 8)


def _level_config(config: ICPConfig, stride: int) -> ICPConfig:
    """The config of a level: m of the subsampled grid, n_r cut by stride^2
    (at least 16) and rounded down to a power of two (the rep grid's
    constraint), automatic capacities."""
    if stride == 1:
        return config
    if LM_GRID % stride != 0:
        raise ValueError(f"stride {stride} must divide the grid size {LM_GRID}")
    m = (LM_GRID // stride) ** 2
    n_r = max(config.n_r // (stride * stride), 16)
    n_r = 1 << (n_r.bit_length() - 1)
    return dataclasses.replace(config, m=m, n_r=n_r, bin_capacity=0, query_capacity=0)


def register_pyramid(fixed8: torch.Tensor, moving8: torch.Tensor,
                     params: ICPParams, config: ICPConfig,
                     strides: Sequence[int] = (4, 2, 1)) -> ICPState:
    """Coarse-to-fine registration over subsampled landmark grids.

    Args:
      fixed8, moving8: (16384, 8) organized landmark sets (128x128 order) on
        one device; every level runs there.
      strides: grid subsampling per level, coarse to fine (each must divide
        the grid); the last should be 1 (full resolution).
    Returns:
      the finest level's ICPState (its ``k`` counts that level's steps).
    """
    dev = fixed8.device
    params = params.to(dev)
    state = identity_state(fixed8.dtype, dev)
    for stride in strides:
        cfg = _level_config(config, stride)
        f = subsample_grid(fixed8, stride).contiguous()
        m = subsample_grid(moving8, stride).contiguous()
        # Warm start from the previous level, with the iteration counter
        # reset so each level gets its full budget.
        state = dataclasses.replace(state, k=torch.zeros((), dtype=torch.int32, device=dev))
        state = icp_run(m, build_target(f, params, cfg), params, cfg, init=state)
    return state
