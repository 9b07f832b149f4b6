"""Fixed-capacity grouping of rows by bin id (port of
``icp_tpu.rbc.grouping``, the bin-major layout path).

The RBC search needs its points bin-major in a padded (n_bins, capacity, d)
table with a validity mask: one stable sort gives the order, the counts give
the offsets, one row gather moves the rows into bin-major order, and the
padded table is built by :func:`icp_tpu_torch.kernels.table_build.bin_table`
(the CUDA kernel K2 on CUDA tensors).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from icp_tpu_torch.kernels.table_build import bin_table


def _counts_from_sorted(sorted_bins: torch.Tensor, n_bins: int) -> torch.Tensor:
    """(n_bins,) int32 counts via searchsorted over bin ids in sorted order."""
    n = sorted_bins.shape[0]
    starts = torch.searchsorted(
        sorted_bins,
        torch.arange(n_bins, dtype=sorted_bins.dtype, device=sorted_bins.device),
        side="left", out_int32=True)
    ends = torch.cat([starts[1:], starts.new_full((1,), n)])
    return ends - starts


class GroupedRows(NamedTuple):
    """Result of :func:`group_rows_by_bin`.

    Attributes:
      counts: (n_bins,) int32 points per bin.
      offsets: (n_bins,) int32 exclusive prefix of counts.
      valid: (n_bins, capacity) bool slot validity.
      grouped: tuple of (n_bins, capacity, d_i) tensors, one per input rows
        tensor, in bin-major order (padded slots undefined).
    """

    counts: torch.Tensor
    offsets: torch.Tensor
    valid: torch.Tensor
    grouped: tuple


def bin_sort_layout(bin_ids: torch.Tensor, n_bins: int, capacity: int,
                    counts: torch.Tensor | None = None):
    """Bin-major stable sort layout: (sidx (n,) int32 original index in
    bin-major order, counts (n_bins,), offsets (n_bins,), valid
    (n_bins, capacity)).

    One sort of the int32 composite key bin*n + i (the index in the low
    digits makes the order stable); where bin*n + i would overflow int32,
    a stable sort of the bin ids. ``counts``, when given, must equal
    ``sum(bin_ids == b)`` exactly (K1 supplies them).
    """
    n = bin_ids.shape[0]
    if n_bins * n < 2 ** 31:
        iota = torch.arange(n, dtype=torch.int32, device=bin_ids.device)
        skey, _ = torch.sort(bin_ids * n + iota)
        sbin = skey // n
        sidx = skey - sbin * n
    else:
        sbin, order = torch.sort(bin_ids, stable=True)
        sidx = order.to(torch.int32)
    if counts is None:
        counts = _counts_from_sorted(sbin, n_bins)
    offsets = (torch.cumsum(counts, dim=0) - counts).to(torch.int32)
    valid = (torch.arange(capacity, dtype=torch.int32, device=bin_ids.device)[None, :]
             < counts[:, None])
    return sidx, counts, offsets, valid


def group_rows_by_bin(bin_ids: torch.Tensor, n_bins: int, capacity: int,
                      rows_list: tuple,
                      counts: torch.Tensor | None = None) -> GroupedRows:
    """Group row data into fixed-capacity bins.

    Args:
      bin_ids: (n,) int32 bin of each row.
      n_bins, capacity: table shape.
      rows_list: tuple of (n, d_i) float32 tensors; they are concatenated,
        permuted and tabled once, then split back (d_i may be 0).
      counts: optional exact per-bin counts (see :func:`bin_sort_layout`).
    """
    sidx, counts, offsets, valid = bin_sort_layout(bin_ids, n_bins, capacity,
                                                   counts=counts)
    nonempty = [rows for rows in rows_list if rows.shape[1] > 0]
    if nonempty:
        big = nonempty[0] if len(nonempty) == 1 else torch.cat(nonempty, dim=1)
        sorted_big = torch.index_select(big, 0, sidx).contiguous()
        table = bin_table(sorted_big, offsets, capacity=capacity)
    grouped = []
    k = 0
    for rows in rows_list:
        d = rows.shape[1]
        if d == 0:
            grouped.append(rows.new_zeros((n_bins, capacity, 0)))
        else:
            grouped.append(table[..., k:k + d])
            k += d
    return GroupedRows(counts, offsets, valid, tuple(grouped))
