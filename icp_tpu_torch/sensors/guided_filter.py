"""Guided image filter for RGB and depth denoising (port of
``icp_tpu.sensors.guided_filter``).

The reference's frame grabber optionally denoises through its GuidedFilter
dependency (``GuidedFilterRGB<SEPARATED>``, ``GuidedFilterDepth``; radius 5,
eps 0.005, depth scaling 1e-3; src/kinect_frame_grabber.cpp:179-243): the He
et al. guided filter with the guide equal to the input. The box filter is
two float32 cumulative sums and shifted differences (integral-image form),
so its cost does not grow with the radius; it runs on the device of the
image it is handed. The sums' rounding depends on the order in which the
device adds, so two devices agree to the cumsums' float32 precision, not
bit for bit.
"""

from __future__ import annotations

import torch

DEFAULT_RADIUS = 5
DEFAULT_EPS = 0.005
DEPTH_SCALE = 1e-3  # the reference scales depth (mm) to meters before filtering


def _box_1d(x: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """Box sum of width 2r+1 along ``dim`` by cumsum differences, with
    edge-clamped windows (cropped at the borders)."""
    n = x.shape[dim]
    c = torch.cumsum(x, dim=dim)
    c = torch.cat([torch.zeros_like(c.narrow(dim, 0, 1)), c], dim=dim)  # c[i] = sum x[:i]
    i = torch.arange(n, device=x.device)
    hi = torch.clamp(i + r + 1, 0, n)
    lo = torch.clamp(i - r, 0, n)
    return torch.index_select(c, dim, hi) - torch.index_select(c, dim, lo)


def box_filter(x: torch.Tensor, r: int) -> torch.Tensor:
    """Mean filter over (2r+1)^2 windows (cropped at borders) on (H, W)."""
    s = _box_1d(_box_1d(x, r, 0), r, 1)
    area = _box_1d(_box_1d(torch.ones_like(x), r, 0), r, 1)
    return s / area


def guided_filter(guide: torch.Tensor, src: torch.Tensor,
                  radius: int = DEFAULT_RADIUS, eps: float = DEFAULT_EPS,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Gray guided filter q = mean(a) * I + mean(b) (He et al. 2010).

    Args:
      guide: (H, W) guide image I.
      src: (H, W) input p to be filtered.
      radius: window radius, a Python int.
      mask: optional (H, W) validity; the statistics become normalized
        convolutions over valid pixels only (invalid pixels would otherwise
        enter the window means as zeros and pull every valid neighbour).
    """
    if mask is None:
        def mean(x):
            return box_filter(x, radius)
    else:
        v = mask.to(guide.dtype)
        denom = torch.clamp(box_filter(v, radius), min=1e-12)

        def mean(x):
            return box_filter(x * v, radius) / denom

    mean_i = mean(guide)
    mean_p = mean(src)
    corr_ip = mean(guide * src)
    corr_ii = mean(guide * guide)
    var_i = corr_ii - mean_i * mean_i
    cov_ip = corr_ip - mean_i * mean_p
    a = cov_ip / (var_i + eps)
    b = mean_p - a * mean_i
    return mean(a) * guide + mean(b)


def filter_rgb(rgb: torch.Tensor, radius: int = DEFAULT_RADIUS,
               eps: float = DEFAULT_EPS) -> torch.Tensor:
    """Per-channel self-guided filtering of an (H, W, 3) image in [0, 1],
    the reference's SEPARATED RGB configuration."""
    chans = [guided_filter(rgb[..., c], rgb[..., c], radius, eps) for c in range(3)]
    return torch.clamp(torch.stack(chans, dim=-1), 0.0, 1.0)


def filter_depth(depth_mm: torch.Tensor, radius: int = DEFAULT_RADIUS,
                 eps: float = DEFAULT_EPS) -> torch.Tensor:
    """Self-guided filtering of an (H, W) depth map in mm.

    Depth is scaled to meters first (the reference's depth scaling 1e-3) so
    eps is commensurate; invalid (zero) pixels stay 0 and are left out of
    the window statistics (normalized convolution)."""
    d = depth_mm * DEPTH_SCALE
    valid = depth_mm > 0
    out = guided_filter(d, d, radius, eps, mask=valid) / DEPTH_SCALE
    return torch.where(valid, out, torch.zeros_like(out))
