"""Entry ``register_batch``: the traffic mix's ``batch`` frame pairs a
call through ``icp_tpu_torch.register_batch``, the poses and ks read back
to the host."""

import torch

from portbench import drive


class Entry(drive.Entry):
    def __init__(self, config, traffic, frames, start=0):
        import icp_tpu_torch as port

        super().__init__(config, traffic, frames, start)
        self.register_batch = port.register_batch
        # The index tensors of every distinct batch, made once: indexing
        # with a host list would copy it to the device inside the window.
        per_cycle = traffic["pool_frames"] // traffic["batch"]
        self.index = [tuple(torch.tensor(col, device=frames.device)
                            for col in zip(*drive.call_pairs(traffic, n)))
                      for n in range(per_cycle)]

    def call(self, n: int) -> torch.Tensor:
        fi, mi = self.index[(self.start + n) % len(self.index)]
        st = self.register_batch(self.frames[fi], self.frames[mi], self.params, self.cfg)
        out = torch.cat([st.q, st.t, st.s[:, None], st.k.to(torch.float32)[:, None]], dim=1)
        return out.cpu().double()
