"""Distributed execution. Ported so far: the single-device failure
detection and bounded retries of ``parallel.resilience``."""

from icp_tpu_torch.parallel.resilience import device_healthy, with_retries
