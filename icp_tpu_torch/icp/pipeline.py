"""App-level pipelines (port of ``icp_tpu.icp.pipeline``): the reference's
ICPSBS and ICPReg apps.

:class:`ICPStepByStep` samples the landmarks of two full 640x480 clouds,
runs one ICP iteration per :meth:`~ICPStepByStep.step` and prints the
reference's per-iteration report; :class:`ICPRegistration` registers two
clouds to convergence in one call. Both run on the device of the clouds
they are handed (the card for numpy clouds), and read their clock after the
device has finished.
"""

from __future__ import annotations

from typing import Optional

import torch

from icp_tpu_torch.icp.quaternion import qangle_deg, qaxis, transform_points
from icp_tpu_torch.icp.run import build_target, register
from icp_tpu_torch.icp.state import ICPState, identity_state
from icp_tpu_torch.icp.step import icp_step
from icp_tpu_torch.ops.sampling import get_landmarks
from icp_tpu_torch.runtime.config import ICPConfig, ICPParams
from icp_tpu_torch.runtime.timing import CPUTimer, block_until_ready


def _report(state: ICPState, latency_ms: float) -> str:
    """The reference's per-iteration printout (src/ocl_icp_sbs.cpp:202-217)."""
    angle = float(qangle_deg(state.q))
    axis = qaxis(state.q).cpu().numpy()
    dt = float(torch.linalg.vector_norm(state.tk))
    dang = float(qangle_deg(state.qk))
    lines = [
        "================",
        f"Iteration k = {int(state.k)}:",
        f"    Latency               :    {latency_ms:.3f} ms",
        f"    Rotation angle        :    {angle:.6f} degrees",
        f"    Rotation axis         :    {axis[0]:.4f} {axis[1]:.4f} {axis[2]:.4f}",
        f"    Translation vector    :    {state.t.cpu().numpy()}",
        f"    Scale                 :    {float(state.s):.6f}",
        f"    Change in translation :    {dt:.6f} mm",
        f"    Change in rotation    :    {dang:.6f} degrees",
    ]
    return "\n".join(lines)


def _cloud(cloud) -> torch.Tensor:
    """A (480, 640, 8) or (307200, 8) cloud as (307200, 8) rows. A tensor
    stays on its device; any other array (a numpy cloud) goes to the card."""
    if not isinstance(cloud, torch.Tensor):
        cloud = torch.as_tensor(cloud, device="cuda")
    return cloud.reshape(-1, 8)


class ICPStepByStep:
    """Step-by-step pipeline over two full 640x480 clouds (ICPSBS parity)."""

    def __init__(self, fixed_cloud, moving_cloud,
                 params: Optional[ICPParams] = None,
                 config: Optional[ICPConfig] = None):
        self.config = config or ICPConfig()
        self.moving_cloud = _cloud(moving_cloud)
        self.fixed_cloud = _cloud(fixed_cloud)
        self.device = self.fixed_cloud.device
        self.params = (params or ICPParams(alpha=2e2)).to(self.device)
        self.fixed_lms = get_landmarks(self.fixed_cloud).contiguous()
        self.moving_lms = get_landmarks(self.moving_cloud).contiguous()
        self.state = identity_state(torch.float32, self.device)
        self._index = None

    def build_rbc(self) -> None:
        """Reference ``buildRBC``: (re)build the search target over the
        fixed landmarks and reset the state."""
        self._index = block_until_ready(
            build_target(self.fixed_lms, self.params, self.config))
        self.state = identity_state(torch.float32, self.device)

    def step(self, verbose: bool = True) -> ICPState:
        """One ICP iteration (reference ``ICPSBS::step``)."""
        if self._index is None and self.config.needs_index:
            self.build_rbc()
        target = self._index if self._index is not None else self.fixed_lms
        with CPUTimer() as t:
            self.state = block_until_ready(icp_step(
                self.state, self.moving_lms, target, self.params, self.config))
        if verbose:
            print(_report(self.state, t.span_ms))
        return self.state

    def transformed_cloud(self) -> torch.Tensor:
        """The full moving cloud under the current transform, for display
        (the reference's ICPTransform over all 307200 points)."""
        return transform_points(self.moving_cloud, self.state.q, self.state.t, self.state.s)

    def reset(self) -> None:
        self.state = identity_state(torch.float32, self.device)


class ICPRegistration:
    """Full registration pipeline (ICPReg parity)."""

    def __init__(self, params: Optional[ICPParams] = None,
                 config: Optional[ICPConfig] = None):
        self.config = config or ICPConfig()
        self.params = params or ICPParams(alpha=2e2)

    def register_clouds(self, fixed_cloud, moving_cloud, verbose: bool = True) -> ICPState:
        """Register two full 640x480 clouds (reference ``ICPReg::registerPC``):
        sample the landmarks, build the search target, run to convergence,
        and report the iterations and the latency."""
        fixed_lms = get_landmarks(_cloud(fixed_cloud)).contiguous()
        moving_lms = get_landmarks(_cloud(moving_cloud)).contiguous()
        with CPUTimer() as t:
            state = block_until_ready(register(fixed_lms, moving_lms, self.params, self.config))
        if verbose:
            print(_report(state, t.span_ms))
            print(f"Registration finished in k = {int(state.k)} iterations, "
                  f"{t.span_ms:.2f} ms")
        return state
