"""Runtime layer: configuration, timing, metrics, native bindings."""

from icp_tpu_torch.runtime.config import (
    Correspondence,
    ICPConfig,
    ICPParams,
    Objective,
    RotationMode,
    Weighting,
)
from icp_tpu_torch.runtime.timing import CPUTimer, ProfilingInfo
from icp_tpu_torch.runtime.metrics import MetricsSink
