"""One CPU thread for torch in the port's tests.

Every ``tests/test_torch_*.py`` imports this module first, before anything
loads torch: ``import tests.torch_one_thread  # noqa: F401``. It sets
``torch.set_num_threads(1)`` and ``torch.set_num_interop_threads(1)`` for the
process, and ``OMP_NUM_THREADS=1`` / ``MKL_NUM_THREADS=1`` for the
subprocesses tests start, which inherit them. An xdist worker collects every
test module before it runs a test, so the pin holds for the whole run.

Two reasons. The suite runs as 6 xdist workers on one host, and a pool of
one thread per core in each of them oversubscribes the host's cores several
times over, which made the torch cases run several times slower than on one
thread. And the port's float32 reductions then sum in one order on any
machine, so the comparisons against the JAX package are deterministic; a
serial run is pinned the same way.

A new torch test file starts with the import above and needs no fixture of
its own for this. A test must not call ``torch.set_num_threads`` with
anything but 1: ``tests/test_suite_threads.py`` checks the pin.
"""

import os

os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"

import torch  # noqa: E402

torch.set_num_threads(1)
torch.set_num_interop_threads(1)  # settable once, before any inter-op work
