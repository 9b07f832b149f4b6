"""Sensor layer: pinhole model, synthetic renderer, guided filter, IO."""

from icp_tpu_torch.sensors.pinhole import backproject, project
from icp_tpu_torch.sensors.io import read_cloud_bin, write_cloud_bin, write_ply
