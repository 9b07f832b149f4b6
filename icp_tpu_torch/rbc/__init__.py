"""Random-Ball-Cover index: grouping, construction, fused search."""
