"""Matplotlib-based offline cloud / trajectory rendering (port of
``icp_tpu.viz.plot``).

The clouds may be tensors on any device or numpy arrays. Each plot draws a
host-side subsample of at most ``max_points`` valid points, picked by the
same numpy generator as the JAX package's, and copies only those rows to
the host. matplotlib is imported on the first call.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch


def _plt():
    """matplotlib's pyplot; Agg when there is no display and no backend
    choice (interactive backends serve :class:`~icp_tpu_torch.viz.live.LiveViewer`)."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("icp_tpu_torch.viz needs matplotlib to plot; install "
                          "matplotlib or export the clouds with "
                          "icp_tpu_torch.sensors.io.write_ply") from e
    if not os.environ.get("DISPLAY") and not os.environ.get("MPLBACKEND"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _host_sample(cloud8, k: int, rng: np.random.Generator) -> np.ndarray:
    """The valid rows (nonzero geometry) of an (n, 8) cloud, at most ``k``
    of them drawn without replacement by ``rng``, as a numpy array. The
    draw is the JAX package's (``rng.choice`` over the valid count), and
    only the drawn rows leave the cloud's device."""
    c = torch.as_tensor(cloud8).reshape(-1, 8)
    idx = torch.nonzero(torch.abs(c[:, :3]).sum(dim=1) > 0).squeeze(1)
    if idx.numel() > k:
        pick = torch.from_numpy(rng.choice(idx.numel(), k, replace=False))
        idx = idx[pick.to(idx.device)]
    return c[idx].cpu().numpy()


def plot_cloud(cloud8, path: str, max_points: int = 20000,
               title: Optional[str] = None) -> None:
    """Scatter an (n, 8) cloud colored by its photometric half."""
    plt = _plt()
    pts = _host_sample(cloud8, max_points, np.random.default_rng(0))
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(pts[:, 0], pts[:, 2], -pts[:, 1], s=1, c=np.clip(pts[:, 4:7], 0, 1))
    ax.set_xlabel("x [mm]")
    ax.set_ylabel("z [mm]")
    ax.set_zlabel("-y [mm]")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_registration(fixed8, moving8, transformed8, path: str,
                      max_points: int = 8000) -> None:
    """Before/after composite: fixed (gray) vs moving (red) vs registered
    moving (green)."""
    plt = _plt()
    rng = np.random.default_rng(0)
    f, m, t = (_host_sample(c, max_points, rng) for c in (fixed8, moving8, transformed8))
    fig, axes = plt.subplots(1, 2, figsize=(13, 6), subplot_kw={"projection": "3d"})
    for ax, other, label, color in [(axes[0], m, "before", "#d62728"),
                                    (axes[1], t, "after", "#2ca02c")]:
        ax.scatter(f[:, 0], f[:, 2], -f[:, 1], s=1, c="#888888", label="fixed")
        ax.scatter(other[:, 0], other[:, 2], -other[:, 1], s=1, c=color, label=label)
        ax.legend()
        ax.set_title(label)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_trajectory(est_t: Sequence, gt_t: Optional[Sequence], path: str) -> None:
    """Top-down (x-z) trajectory plot, estimated vs ground truth."""
    plt = _plt()
    e = np.asarray([_host(t) for t in est_t])
    fig, ax = plt.subplots(figsize=(7, 6))
    ax.plot(e[:, 0], e[:, 2], "o-", label="estimated", ms=3)
    if gt_t is not None:
        g = np.asarray([_host(t) for t in gt_t])
        ax.plot(g[:, 0], g[:, 2], "x--", label="ground truth", ms=4)
    ax.set_xlabel("x [mm]")
    ax.set_ylabel("z [mm]")
    ax.axis("equal")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
