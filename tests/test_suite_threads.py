"""The suite's one-thread pin (``tests/torch_one_thread.py``), as it stands
once the torch test modules are collected: torch on one CPU thread in the
test process and in a subprocess a test starts. It catches a pin that is
dropped or stops reaching children; a test elsewhere that changes the count
while it runs is not seen here."""

import tests.torch_one_thread  # noqa: F401  (torch on one CPU thread)
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def test_tier1_runs_torch_on_one_thread():
    assert torch.get_num_threads() == 1
    child = subprocess.run(
        [sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    assert child.stdout.split() == ["1"], child.stdout + child.stderr
