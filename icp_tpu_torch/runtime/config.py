"""Configuration for the ICP engine (PyTorch port of ``icp_tpu.runtime.config``).

``ICPConfig`` mirrors the JAX package's static configuration field for field,
with the same defaults, auto-capacities and validation, except
``use_pallas``: here the device of the input tensors selects the path (CUDA
tensors run the hand-written kernels, CPU tensors their plain twins), so the
port has no such switch. ``ICPParams`` holds the dynamic scalars as Python
floats, or as 0-d float32 tensors after :meth:`ICPParams.to`.

The port covers every configuration the JAX package validates: the POINT,
PLANE, symmetric PLANE and GICP objectives with grid or kNN normals, each
with or without a robust kernel and its adaptive scale, on both
correspondences (RBC, fused or unfused, and BRUTE).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

import torch


class RotationMode(enum.Enum):
    """Rotation-solve variant (reference ``ICPStepConfigT``)."""

    SVD = "svd"
    POWER = "power"
    JACOBI = "jacobi"


class Weighting(enum.Enum):
    """Residual weighting variant (reference ``ICPStepConfigW``)."""

    REGULAR = "regular"
    WEIGHTED = "weighted"


class Objective(enum.Enum):
    """Error metric of the alignment solve (see ``icp_tpu.runtime.config``)."""

    POINT = "point"
    PLANE = "plane"
    GICP = "gicp"


class RobustKernel(enum.Enum):
    """Robust M-estimator on correspondence residuals (IRLS weights)."""

    NONE = "none"
    HUBER = "huber"
    TUKEY = "tukey"
    TRIMMED = "trimmed"


class Correspondence(enum.Enum):
    """Nearest-neighbor search strategy."""

    BRUTE = "brute"
    RBC = "rbc"


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """Static configuration; fields as in ``icp_tpu.runtime.config.ICPConfig``.

    ``bin_capacity`` and ``query_capacity`` of 0 select the same automatic
    capacities as the JAX package: 2x the mean bin occupancy rounded up to a
    multiple of 128 (at least 16), and 1.5x rounded up to a multiple of 8
    (at least 16).
    """

    m: int = 16384
    n_r: int = 256
    rotation: RotationMode = RotationMode.POWER
    weighting: Weighting = Weighting.WEIGHTED
    robust: RobustKernel = RobustKernel.NONE
    robust_adaptive: bool = False
    correspondence: Correspondence = Correspondence.RBC
    max_iterations: int = 40
    bin_capacity: int = 0
    query_capacity: int = 0
    estimate_scale: bool = True
    objective: Objective = Objective.POINT
    plane_symmetric: bool = False
    normal_mode: str = "auto"
    fused_point: bool = True
    fused_gn: bool = True

    def __post_init__(self):
        if self.m <= 0:
            raise ValueError("The sets of landmarks cannot have zero points")
        if self.n_r <= 0:
            raise ValueError("The sets of representatives cannot have zero points")
        if self.n_r % 4 != 0:
            raise ValueError("n_r must be a multiple of 4")
        if self.normal_mode not in ("auto", "grid", "knn", "knn_rbc"):
            raise ValueError(f"normal_mode must be auto|grid|knn|knn_rbc, "
                             f"got {self.normal_mode!r}")
        mean_occ = max(self.m // self.n_r, 4)
        if self.bin_capacity == 0:
            object.__setattr__(self, "bin_capacity",
                               max(((2 * mean_occ + 127) // 128) * 128, 16))
        if self.query_capacity == 0:
            object.__setattr__(self, "query_capacity",
                               max(((3 * mean_occ // 2 + 7) // 8) * 8, 16))

    @property
    def needs_normals(self) -> bool:
        """True when the objective consumes fixed-surface normals (PLANE
        point-to-plane; GICP plane-to-plane covariances)."""
        return self.objective in (Objective.PLANE, Objective.GICP)

    @property
    def needs_index(self) -> bool:
        """True when the pipeline builds an RBCIndex: RBC correspondence
        always, and the normal-consuming objectives (it carries the
        normals)."""
        return self.correspondence is Correspondence.RBC or self.needs_normals

    @property
    def rep_grid(self) -> tuple[int, int]:
        """(n_ry, n_rx) split of n_r: n_r = 2^p -> (2^(p//2), 2^(p - p//2))."""
        p = self.n_r.bit_length() - 1
        if (1 << p) != self.n_r:
            raise ValueError("n_r must be a power of 2 for the rep sampler")
        return (1 << (p // 2), 1 << (p - p // 2))


@dataclasses.dataclass
class ICPParams:
    """Dynamic scalar parameters; see ``icp_tpu.runtime.config.ICPParams``.

    alpha: photometric blend weight of the 8-D metric.
    c: float-safety scaling of deviations before the S-matrix products.
    angle_threshold_deg / translation_threshold: convergence thresholds.
    gicp_epsilon: GICP disk-covariance thickness along the normal; read by
      ``Objective.GICP`` only.
    robust_delta: scale of the robust kernel in blended distance units (mm
      for pure geometry); read when ``robust`` is not NONE and
      ``robust_adaptive`` is off.
    """

    alpha: Any = 1e2
    c: Any = 1e-6
    angle_threshold_deg: Any = 0.001
    translation_threshold: Any = 0.01
    gicp_epsilon: Any = 1e-3
    robust_delta: Any = 100.0

    def to(self, device) -> "ICPParams":
        """Every field as a 0-d float32 tensor on ``device``. A Python float
        becomes a fill there: copying it from host memory would wait for
        the stream."""
        def on_device(v):
            if isinstance(v, torch.Tensor):
                return v.to(device=device, dtype=torch.float32)
            return torch.full((), float(v), dtype=torch.float32, device=device)
        return ICPParams(**{f.name: on_device(getattr(self, f.name))
                            for f in dataclasses.fields(self)})
