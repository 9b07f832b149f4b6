"""Shared pieces of the benchmark's tests: the repo root on the path, and a
cell cut to a size the CPU runs in seconds."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny(cell: dict, points: int, n_r: int, pool: int = 4, batch: int = 1) -> dict:
    """A copy of ``cell`` at ``points`` points, ``n_r`` representatives and
    a pool of ``pool`` frames (a LiDAR's sweep cut to 32 beams where the
    point count changes)."""
    cell = copy.deepcopy(cell)
    cell["config"]["points"] = points
    sensor = cell["config"].get("sensor")
    if sensor and sensor["beams"] * sensor["columns"] != points:
        sensor.update(beams=32, columns=points // 32)
    cell["config"]["icp"]["n_r"] = n_r
    cell["traffic"].update(pool_frames=pool, batch=batch, trace_pairs=pool,
                           check_sample=3)
    return cell


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
