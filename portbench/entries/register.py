"""Entry ``register``: one frame pair a call through
``icp_tpu_torch.register``, the pose and k read back to the host."""

import torch

from portbench import drive


class Entry(drive.Entry):
    def __init__(self, config, traffic, frames, start=0):
        import icp_tpu_torch as port

        super().__init__(config, traffic, frames, start)
        self.register = port.register

    def call(self, n: int) -> torch.Tensor:
        (i, j), = self.pairs(n)
        st = self.register(self.frames[i], self.frames[j], self.params, self.cfg)
        out = torch.cat([st.q, st.t, st.s.reshape(1), st.k.to(torch.float32).reshape(1)])[None]
        return out.cpu().double()
