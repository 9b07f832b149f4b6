"""Padded bin table, gathered from the row sources in bin-major order (port
of ``icp_tpu.kernels.table_build``).

Slot c of bin b is row ``order[starts[b] + c]`` of the sources' lanes side
by side, and 0.0 past the last row (slots past a bin's count read the next
bin's rows: garbage that the caller's validity masks, as in the JAX
package). Without ``order`` the rows are already in bin-major order, the
JAX package's form. :func:`bin_table` runs the CUDA kernel
``csrc/bin_table.cu`` on CUDA tensors and its plain twin :func:`bin_table_ref`
of :func:`gathered_rows` on CPU tensors; the two are bit-identical (a copy
has no arithmetic).
"""

from __future__ import annotations

import torch

from icp_tpu_torch.kernels import native

MAX_SOURCES = 3  # the most any caller passes: rbc/construct.py (db, ids, normals)


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


def gathered_rows(sources: tuple, order: torch.Tensor | None) -> torch.Tensor:
    """The twin's input: the sources' lanes side by side, rows in ``order``."""
    rows = sources[0] if len(sources) == 1 else torch.cat(sources, dim=1)
    return rows if order is None else torch.index_select(rows, 0, order)


def bin_table(rows, starts: torch.Tensor, *, capacity: int,
              order: torch.Tensor | None = None) -> torch.Tensor:
    """(n_r, capacity, d) padded bin table; K2, replacing
    ``icp_tpu.kernels.table_build.bin_table_pallas``.

    Args:
      rows: (m, d) float32 rows, or a tuple of up to three (m, d_i) sources
        whose lanes lie side by side in the table (d = sum d_i); on CUDA each
        may be a column slice of a wider table (unit lane stride).
      starts: (n_r,) int32 exclusive-prefix offsets of the bins in the
        bin-major order.
      capacity: slots per bin.
      order: optional (m,) int32 bin-major permutation of the rows (slot c
        of bin b is row ``order[starts[b] + c]``); None when the rows are
        already in that order.
    """
    sources = (rows,) if isinstance(rows, torch.Tensor) else tuple(rows)
    if sources[0].device.type == "cpu":
        return bin_table_ref(gathered_rows(sources, order), starts, capacity=capacity)
    native.require_cuda(sources[0], "rows")
    dev = sources[0].device
    m = sources[0].shape[0]
    n_r = starts.shape[0]
    if not 1 <= len(sources) <= MAX_SOURCES:
        raise ValueError(f"rows: 1 to {MAX_SOURCES} sources, got {len(sources)}")
    ptrs = []
    for i, s in enumerate(sources):
        name = f"rows[{i}]"
        if s.device != dev or s.dtype != torch.float32 or s.dim() != 2 or s.shape[0] != m:
            raise ValueError(f"{name}: expected ({m}, d) float32 on {dev}, got "
                             f"{tuple(s.shape)} {s.dtype} on {s.device}")
        d, ld = s.shape[1], s.stride(0)
        if (d > 1 and s.stride(1) != 1) or ld < d:
            raise ValueError(f"{name}: lanes must be packed, got strides {s.stride()}")
        if m and (m - 1) * ld + d >= 2 ** 31:
            raise ValueError(f"{name}: 2^31 elements or more")
        ptrs += [s.data_ptr() if d else None, ld, d]
    ptrs += [None, 0, 0] * (MAX_SOURCES - len(sources))
    width = sum(s.shape[1] for s in sources)
    if n_r * capacity * width >= 2 ** 31:
        raise ValueError(f"table ({n_r}, {capacity}, {width}): 2^31 elements or more")
    native.require(starts, "starts", (n_r,), torch.int32, dev)
    if order is not None:
        native.require(order, "order", (m,), torch.int32, dev)
    out = torch.empty((n_r, capacity, width), dtype=torch.float32, device=dev)
    native.launch("icp_bin_table", dev, *ptrs, None if order is None else order.data_ptr(),
                  starts.data_ptr(), m, n_r, capacity, out.data_ptr())
    return out
