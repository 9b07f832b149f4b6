"""The plain reference of the benchmark: the registration that
``icp_tpu_torch.register`` computes, written again in plain PyTorch from the
algorithm's description (Random Ball Cover correspondences, photogeometric
8-D metric, the reference weights, Horn's closed form or one point-to-plane
Gauss-Newton step, kNN PCA normals over two nearest balls).

It imports nothing of ``icp_tpu_torch``, ``icp_tpu`` or ``jax``, and takes
nothing that the program made: it builds its own representatives, bins and
normals from the raw frames. Its matrix products run in full float32
(TF32 off, set by :func:`precision`); ``precision(tf32=True)`` computes the
same in TF32, the benchmark's control.
"""
