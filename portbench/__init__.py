"""The benchmark of icp_tpu_torch on one NVIDIA GPU (``run.py`` runs one
cell). It loads nothing of the JAX package ``icp_tpu`` and reads nothing of
the repo's older benchmarks."""
