"""Visualization and export (port of ``icp_tpu.viz``): matplotlib scatter
snapshots of clouds, registration before/after composites, trajectory
plots and a live step-by-step viewer. PLY export is
``icp_tpu_torch.sensors.io.write_ply``.

matplotlib is imported by the first plot call, never by this package:
without it a plot call raises ImportError, and everything else runs.
"""

from icp_tpu_torch.viz.live import LiveViewer
from icp_tpu_torch.viz.plot import plot_cloud, plot_registration, plot_trajectory

__all__ = ["LiveViewer", "plot_cloud", "plot_registration", "plot_trajectory"]
