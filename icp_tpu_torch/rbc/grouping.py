"""Fixed-capacity grouping of rows by bin id (port of
``icp_tpu.rbc.grouping``).

The RBC search needs its points bin-major in a padded (n_bins, capacity, d)
table with a validity mask: one stable sort gives the order, the counts give
the offsets, and :func:`icp_tpu_torch.kernels.table_build.bin_table` gathers
the padded table straight from the unsorted row sources through the order
(the CUDA kernel K2 on CUDA tensors; no concatenated or sorted copy of the
rows). :func:`group_rows_by_bin` is the hot path; :func:`group_by_bin` also
keeps the member table of original indices, which the original-order
search (``rbc.search.rbc_search``) scatters back through.
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
      rows_list: tuple of (n, d_i) float32 tensors, at most three with
        d_i > 0 on CUDA (K2's sources); they are tabled side by side in one
        gather, then split back into views (d_i may be 0).
      counts: optional exact per-bin counts (see :func:`bin_sort_layout`).
    """
    sidx, counts, offsets, valid = bin_sort_layout(bin_ids, n_bins, capacity,
                                                   counts=counts)
    nonempty = tuple(rows for rows in rows_list if rows.shape[1] > 0)
    if nonempty:
        table = bin_table(nonempty, offsets, capacity=capacity, order=sidx)
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


class GroupLayout(NamedTuple):
    """Bin-major layout of a point set grouped by bin id.

    Attributes:
      order: (n,) int32 original indices in bin-major (stable) order.
      counts: (n_bins,) int32 points per bin.
      offsets: (n_bins,) int32 exclusive prefix of counts.
      member: (n_bins, capacity) int32 original index of each bin slot
        (undefined where ``valid`` is False).
      valid: (n_bins, capacity) bool slot validity; members ranked past
        ``capacity`` in their bin are not represented (overflow).
    """

    order: torch.Tensor
    counts: torch.Tensor
    offsets: torch.Tensor
    member: torch.Tensor
    valid: torch.Tensor


def group_by_bin(bin_ids: torch.Tensor, n_bins: int, capacity: int) -> GroupLayout:
    """Group ``n`` points into ``n_bins`` fixed-capacity bins: a stable sort
    of the bin ids, exact counts, and the member table as each bin's
    contiguous run of the order (zero-padded past the end)."""
    sbin, order = torch.sort(bin_ids, stable=True)
    order = order.to(torch.int32)
    counts = _counts_from_sorted(sbin, n_bins)
    offsets = (torch.cumsum(counts, dim=0) - counts).to(torch.int32)
    slots = torch.arange(capacity, dtype=torch.int32, device=bin_ids.device)
    valid = slots[None, :] < counts[:, None]
    order_padded = torch.cat([order, order.new_zeros((capacity,))])
    member = order_padded[(offsets[:, None] + slots[None, :]).long()]
    return GroupLayout(order, counts, offsets, member, valid)


def gather_grouped(layout: GroupLayout, rows: torch.Tensor) -> torch.Tensor:
    """``rows[member]`` as an (n_bins, capacity, d) table (padded slots
    undefined): each bin's run of the order, gathered from ``rows`` (K2 on
    CUDA tensors)."""
    return bin_table(rows, layout.offsets, capacity=layout.member.shape[1],
                     order=layout.order)


def overflow_mask(layout: GroupLayout, bin_ids: torch.Tensor,
                  capacity: int) -> torch.Tensor:
    """(n,) bool, True for points whose rank in their bin is >= capacity
    (a diagnostic, off the hot path)."""
    n = bin_ids.shape[0]
    order = layout.order.long()
    rank_sorted = (torch.arange(n, dtype=torch.int32, device=bin_ids.device)
                   - layout.offsets[bin_ids[order].long()])
    rank = torch.zeros((n,), dtype=torch.int32, device=bin_ids.device)
    rank[order] = rank_sorted
    return rank >= capacity
