"""ICP iteration state (port of ``icp_tpu.icp.state``)."""

from __future__ import annotations

import dataclasses

import torch

from icp_tpu_torch.icp.quaternion import qidentity


@dataclasses.dataclass
class ICPState:
    """Accumulated + incremental transform state.

    q, t, s: accumulated similarity (moving -> fixed): p' = s R(q) p + t.
    qk, tk, sk: the last iteration's incremental transform.
    k: completed iterations, a 0-d int32 tensor.
    """

    q: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor
    qk: torch.Tensor
    tk: torch.Tensor
    sk: torch.Tensor
    k: torch.Tensor

    @property
    def T(self) -> torch.Tensor:
        """Reference T-buffer layout [qx,qy,qz,qw, tx,ty,tz,s]."""
        return torch.cat([self.q, self.t, self.s.reshape(1)])


def identity_state(dtype=torch.float32, device=None) -> ICPState:
    """Identity transform before the first iteration."""
    return ICPState(
        q=qidentity(dtype, device),
        t=torch.zeros((3,), dtype=dtype, device=device),
        s=torch.ones((), dtype=dtype, device=device),
        qk=qidentity(dtype, device),
        tk=torch.full((3,), float("inf"), dtype=dtype, device=device),
        sk=torch.ones((), dtype=dtype, device=device),
        k=torch.zeros((), dtype=torch.int32, device=device),
    )
