"""The reference of the POINT and PLANE configurations, which
configurations that name no ``reference`` get: ``icp.register`` of the
pair, with the fixed frame's kNN normals (``normals.knn_normals``) where
the objective is PLANE, each fixed frame's normals made once a run."""

from __future__ import annotations

import torch

from portbench.reference import icp as ref_icp
from portbench.reference import normals as ref_normals

# The keys of the ``icp`` section that this reference reads, or that leave
# the result it stands for as it is (the solver of Horn's rotation; the
# normals' name, which has to be "knn" for PLANE).
MODELLED = {"n_r", "objective", "normal_mode", "rotation", "weighted", "estimate_scale",
            "alpha", "c", "max_iterations", "angle_threshold_deg",
            "translation_threshold_mm"}


def run(frames: torch.Tensor, pair, icp: dict, run_to: int, cache: dict,
        tf32: bool = False) -> dict:
    """The registration of ``pair`` (fixed, moving), as ``spec`` states the
    contract."""
    other = sorted(set(icp) - MODELLED)
    plane = icp["objective"] == "plane"
    if not (plane or icp["objective"] == "point") or other or (
            plane and icp["normal_mode"] != "knn"):
        raise ValueError(f"the point_plane reference does not compute objective "
                         f"{icp['objective']!r} with normals {icp.get('normal_mode')!r} "
                         f"and keys {other}: the configuration has to name a "
                         "reference that does")
    i, j = pair
    with ref_icp.precision(tf32):
        normals = None
        if plane:
            if i not in cache:
                cache[i] = ref_normals.knn_normals(frames[i])
            normals = cache[i]
        return ref_icp.register(frames[i], frames[j], icp, normals, run_to=run_to)
