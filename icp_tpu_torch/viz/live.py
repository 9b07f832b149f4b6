"""Live streaming registration viewer (port of ``icp_tpu.viz.live``), the
reference's GL view equivalent.

The reference's step-by-step app drives a GLUT window with CL-GL shared
buffers (its ``CLEnvGL``; the GLUT loop and the T/R key map of its
examples/step_by_step.cpp). This viewer streams matplotlib frames instead:

- with an interactive backend (a workstation $DISPLAY): a live-updating
  3-D figure with the reference's key map: ``t`` steps, ``r`` resets,
  ``q`` closes;
- headless (Agg): numbered PNG frames under ``out_dir``, an animation
  strip any tool can assemble.

The clouds stay on their device: each frame copies only a ``max_points``
subsample of each cloud to the host, drawn as the JAX package draws it.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import numpy as np

from icp_tpu_torch.viz.plot import _host, _host_sample, _plt


def _subsample(cloud8, k: int, seed: int = 0) -> np.ndarray:
    """At most ``k`` valid rows of ``cloud8`` (a tensor on any device or
    an array), drawn by ``np.random.default_rng(seed)``: the rows
    ``icp_tpu.viz.live._subsample`` picks."""
    return _host_sample(cloud8, k, np.random.default_rng(seed))


class LiveViewer:
    """Streaming fixed/moving overlay with per-iteration annotations.

    Args:
      out_dir: where headless PNG frames go (created on demand). With an
        interactive backend frames are drawn to the screen instead; pass
        ``out_dir`` anyway to ALSO record frames.
      max_points: per-cloud host-side subsample for display.
    """

    def __init__(self, out_dir: Optional[str] = None, max_points: int = 6000,
                 elev: float = -70.0, azim: float = -90.0):
        plt = _plt()
        self._plt = plt
        self.interactive = plt.get_backend().lower() not in (
            "agg", "pdf", "svg", "ps", "cairo", "template")
        self.out_dir = out_dir
        self.max_points = max_points
        self.frame = 0
        self._app = None

        self.fig = plt.figure(figsize=(7, 6))
        self.ax = self.fig.add_subplot(111, projection="3d")
        self.ax.view_init(elev=elev, azim=azim)
        self._fixed_art = None
        self._moving_art = None
        if self.interactive:
            plt.ion()
            self.fig.canvas.mpl_connect("key_press_event", self._on_key)
            self.fig.show()

    # -- drawing -----------------------------------------------------------

    def update(self, fixed8, moving8, state=None, title: Optional[str] = None) -> None:
        """Draw one frame: fixed (gray) + current moving (its colours)
        overlay, annotated with the state's iteration/transform."""
        f = _subsample(fixed8, self.max_points)
        m = _subsample(moving8, self.max_points, seed=1)
        ax = self.ax
        for art in (self._fixed_art, self._moving_art):
            if art is not None:
                art.remove()
        self._fixed_art = ax.scatter(f[:, 0], f[:, 1], f[:, 2], s=1.0, c="0.65",
                                     depthshade=False)
        self._moving_art = ax.scatter(m[:, 0], m[:, 1], m[:, 2], s=1.2,
                                      c=np.clip(m[:, 4:7], 0, 1), depthshade=False)
        if title is None and state is not None:
            k = int(state.k)
            t = _host(state.t)
            title = f"iteration {k}   t = [{t[0]:+.2f} {t[1]:+.2f} {t[2]:+.2f}] mm"
        if title:
            ax.set_title(title, fontsize=10)
        self._flush()

    def _flush(self) -> None:
        if self.interactive:
            self.fig.canvas.draw_idle()
            self._plt.pause(0.001)
        if self.out_dir is not None or not self.interactive:
            out = self.out_dir or os.path.join(tempfile.gettempdir(), "icp_tpu_live")
            os.makedirs(out, exist_ok=True)
            self.fig.savefig(os.path.join(out, f"frame_{self.frame:04d}.png"), dpi=90)
        self.frame += 1

    # -- the reference's key map (T steps, R resets) ------------------------

    def attach(self, app) -> None:
        """Bind an :class:`icp_tpu_torch.icp.pipeline.ICPStepByStep`: draws
        the initial overlay; interactive keys then drive it (t/r/q)."""
        self._app = app
        self.update(app.fixed_cloud, app.transformed_cloud(), app.state)

    def step(self) -> None:
        """One ICP iteration + redraw (the T key / one <Enter>)."""
        assert self._app is not None, "attach() an ICPStepByStep first"
        state = self._app.step()
        self.update(self._app.fixed_cloud, self._app.transformed_cloud(), state)

    def reset(self) -> None:
        assert self._app is not None, "attach() an ICPStepByStep first"
        self._app.reset()
        self.update(self._app.fixed_cloud, self._app.transformed_cloud(),
                    self._app.state, title="reset")

    def _on_key(self, event) -> None:
        if self._app is None:
            return
        if event.key in ("t", "enter"):
            self.step()
        elif event.key == "r":
            self.reset()
        elif event.key == "q":
            self.close()

    def loop(self) -> None:
        """Block in the GUI event loop (interactive backends only)."""
        if self.interactive:
            self._plt.show(block=True)

    def close(self) -> None:
        self._plt.close(self.fig)
