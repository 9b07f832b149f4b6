"""Random-Ball-Cover index: grouping, construction, fused search."""

from icp_tpu_torch.rbc.construct import RBCIndex, rbc_construct
from icp_tpu_torch.rbc.grouping import (
    GroupLayout,
    GroupedRows,
    gather_grouped,
    group_by_bin,
    group_rows_by_bin,
)
from icp_tpu_torch.rbc.search import (
    GroupedSearchResult,
    SearchResult,
    rbc_point_moments,
    rbc_search,
    rbc_search_grouped,
)
