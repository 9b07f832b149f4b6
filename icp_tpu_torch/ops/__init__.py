"""Tensor ops: 8-D distances and samplers."""
