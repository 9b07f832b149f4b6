"""Padded bin table from bin-major sorted rows (port of
``icp_tpu.kernels.table_build``).

Slot c of bin b is ``sorted_rows[starts[b] + c]``, and 0.0 past the last row
(slots past a bin's count read the next bin's rows: garbage that the
caller's validity masks, as in the JAX package). :func:`bin_table` runs the
CUDA kernel ``csrc/bin_table.cu`` on CUDA tensors and its plain twin
:func:`bin_table_ref` on CPU tensors; the two are bit-identical (a copy has
no arithmetic).
"""

from __future__ import annotations

import torch

from icp_tpu_torch.kernels import native


def bin_table_ref(sorted_rows: torch.Tensor, starts: torch.Tensor, *,
                  capacity: int) -> torch.Tensor:
    """Plain twin: row gather at arithmetic positions from the rows padded
    with ``capacity`` zero rows. Returns (n_r, capacity, d)."""
    m, d = sorted_rows.shape
    n_r = starts.shape[0]
    padded = torch.cat([sorted_rows, sorted_rows.new_zeros((capacity, d))])
    flat_pos = torch.clamp(
        starts[:, None].long()
        + torch.arange(capacity, device=starts.device)[None, :],
        max=m + capacity - 1)
    return padded[flat_pos.reshape(-1)].reshape(n_r, capacity, d)


def bin_table(sorted_rows: torch.Tensor, starts: torch.Tensor, *,
              capacity: int) -> torch.Tensor:
    """(n_r, capacity, d) padded bin table; K2, replacing
    ``icp_tpu.kernels.table_build.bin_table_pallas``.

    Args:
      sorted_rows: (m, d) float32 rows in bin-major order.
      starts: (n_r,) int32 exclusive-prefix offsets of the bins.
      capacity: slots per bin.
    """
    if sorted_rows.device.type == "cpu":
        return bin_table_ref(sorted_rows, starts, capacity=capacity)
    native.require_cuda(sorted_rows, "sorted_rows")
    dev = sorted_rows.device
    m, d = sorted_rows.shape
    n_r = starts.shape[0]
    native.require(sorted_rows, "sorted_rows", (m, d), torch.float32, dev)
    native.require(starts, "starts", (n_r,), torch.int32, dev)
    out = torch.empty((n_r, capacity, d), dtype=torch.float32, device=dev)
    lib = native.load_library()
    native.check(lib.icp_bin_table(
        sorted_rows.data_ptr(), starts.data_ptr(), m, d, n_r, capacity,
        out.data_ptr(), native.stream_ptr(dev)), "icp_bin_table")
    bin_table.launches += 1
    return out


bin_table.launches = 0
