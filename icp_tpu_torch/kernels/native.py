"""Build and load the hand-written CUDA kernels of ``icp_tpu_torch/csrc``.

All ``csrc/*.cu`` files compile with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ctypes. The build runs at the
first CUDA call, into ``build/icp_tpu_torch/<hash>/`` beside the package,
keyed by a hash of the sources and flags, so a changed source rebuilds and an
unchanged one loads the existing library. Nothing here runs on import, and
CPU tensors never reach this module: their wrappers take the plain twins.

Every C entry point launches on the stream it is given, allocates nothing,
does not synchronize and returns ``cudaGetLastError()``; :func:`check`
raises on any non-zero value.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "icp_tpu_torch"
# No --use_fast_math: the +inf slot mask and the 100/(100+d^2) weight
# must stay IEEE.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argument types (pointers and the stream as void*, sizes as int).
SIGNATURES = {
    # moving8, C, srow, m, n_r, rid, counts, stream
    "icp_rep_assign_counts": [_P, _P, _P, _I, _I, _P, _P, _P],
    # sorted_rows, starts, m, d, n_r, capacity, out, stream
    "icp_bin_table": [_P, _P, _I, _I, _I, _I, _P, _P],
    # mg, qvalid, reps, bins_c, sq_b_masked, G, b_row, alpha,
    # n_r, cq, cb, weighted, P, stream
    "icp_bin_point_moments": [_P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _P, _P],
}

build_info: dict = {}  # filled by load_library(): path, seconds, log


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


@functools.cache
def load_library() -> ctypes.CDLL:
    """Compile (if this source hash was never built) and load the kernels."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib_path = out_dir / "libicp_tpu_torch.so"
    t0 = time.perf_counter()
    log = ""
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        cu = [str(p) for p in sorted(CSRC.glob("*.cu"))]
        # Build under a temporary name and rename: concurrent processes never
        # load a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *cu],
                capture_output=True, text=True, check=False)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        (out_dir / "build.log").write_text(log)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    build_info.update(path=str(lib_path), seconds=time.perf_counter() - t0,
                      log=log)
    return lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status}")


def stream_ptr(device: torch.device) -> int:
    """Handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def require(t: torch.Tensor, name: str, shape: tuple, dtype: torch.dtype,
            device: torch.device) -> None:
    """Validate a kernel argument: device, dtype, shape and contiguity."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def require_cuda(t: torch.Tensor, name: str) -> None:
    """Only CPU tensors take the plain twins; anything else must be CUDA."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: kernels run on CUDA tensors, got {t.device}")
