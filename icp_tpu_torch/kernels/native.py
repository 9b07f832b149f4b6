"""Build and load the hand-written CUDA kernels of ``icp_tpu_torch/csrc``.

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` for ``sm_90a``, all
of them at once, and one more ``nvcc`` links the objects into one shared
library with a plain C interface, loaded with ctypes. The build runs at the
first CUDA call, into ``build/icp_tpu_torch/<hash>/`` beside the package,
keyed by a hash of the sources and flags, so a changed source rebuilds and an
unchanged one loads the existing library. Nothing here runs on import, and
CPU tensors never reach this module: their wrappers take the plain twins.

Every C entry point launches on the stream it is given, allocates nothing,
does not synchronize and returns ``cudaGetLastError()``, or
:data:`LAUNCH_LIMIT` when its shapes pass a limit of the card (a block's
shared memory, a grid's second dimension) and it launched nothing; the C
side knows its tiles and the card, and names the limit and the shape.
:func:`check` raises a ``ValueError`` with that text for the latter and a
``RuntimeError`` on any other non-zero value.
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
# No --use_fast_math: the +inf slot mask, the 100/(100+d^2) weight and the
# kNN bisection must stay IEEE.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argument types (pointers and the stream as void*, sizes as int,
# constants as float).
SIGNATURES = {
    # moving8, C, srow, m, n_r, rid, counts, stream
    "icp_rep_assign_counts": [_P, _P, _P, _I, _I, _P, _P, _P],
    # moving8, C, srow, m, n_r, rid, stream
    "icp_rep_assign": [_P, _P, _P, _I, _I, _P, _P],
    # (source, row stride, lanes) x 3, order (or null), starts, m, n_r,
    # capacity, out, stream
    "icp_bin_table": [_P, _I, _I, _P, _I, _I, _P, _I, _I, _P, _P, _I, _I, _I, _P, _P],
    # mg, qvalid, reps, bins_c, sq_b_masked, G, b_row, scal [alpha, delta],
    # n_r, cq, cb, weighted, robust, P, stream
    "icp_bin_point_moments": [_P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _P, _P],
    # mg, ld_mg, qvalid, reps, bins_c, sq_b_masked, G, b_row, scal [alpha],
    # n_r, cq, cb, d2, stream
    "icp_bin_min_dists": [_P, _I, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _P, _P],
    # mg, ld_mg, nm, ld_nm, qvalid, reps, bins_vals, sq_b_masked, G, b_row,
    # scal [alpha, delta, eps], n_r, cq, cb, mode, weighted, robust, P, Pz,
    # stream
    "icp_bin_gn_moments": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # qg_w, bins_c, sq_b_masked, vals, n_r, cq, cb, v, best_score, matched,
    # stream
    "icp_bin_search": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    # qw, db, sq_db, ms (9 scratch), kappa, floor, m, n, idx, score,
    # rescored (or null), stream
    "icp_brute_nn": [_P, _P, _P, _P, _F, _F, _I, _I, _P, _P, _P, _P],
    # p3, reps, m, n_r, i1, i2, counts, stream
    "icp_rep_top2_counts": [_P, _P, _I, _I, _P, _P, _P, _P],
    # qp, ld_q, bins, reps, bvalid, n_r, cq, cb, k, out (7, n_r, cq),
    # workspace (or null), stream
    "icp_bin_knn_moments": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    # n_r, cq, cb, floats of the workspace icp_bin_knn_moments needs (out)
    "icp_bin_knn_moments_workspace": [_I, _I, _I, ctypes.POINTER(ctypes.c_longlong)],
}

# The status of an entry point that launched nothing because its shapes
# pass a launch limit (csrc/common.cuh, kLaunchLimit); no CUDA status is
# negative.
LAUNCH_LIMIT = -1

build_info: dict = {}  # filled by load_library(): path, seconds, log
_build_allowed = True


def forbid_build() -> None:
    """From now on :func:`load_library` loads a library built earlier or
    raises; it never compiles. The ranks of a world call this: they load
    what their launching process built, so no two compilers write into one
    build directory at once."""
    global _build_allowed
    _build_allowed = False


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


def _build(tmp: Path, lib_path: Path) -> str:
    """Compile every ``.cu`` with its own nvcc process, all started together,
    then link them into ``lib_path``. Returns the compilers' output."""
    nvcc = _nvcc()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = tmp / (src.stem + ".o")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, obj, proc))
    log, failed = "", []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        log += f"== {src.name}\n{out}"
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    tmp_lib = tmp / lib_path.name
    proc = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-o", str(tmp_lib), *(str(obj) for _, obj, _ in jobs)],
        capture_output=True, text=True, check=False)
    log += proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
    os.replace(tmp_lib, lib_path)
    return log


def source_digest() -> str:
    """sha256 of ``NVCC_FLAGS`` and every ``csrc/*.cu`` and ``*.cuh`` (name
    and bytes): the key of the build directory, and of the support table
    (``runtime/support_matrix.py``) that records what these sources did on
    the card."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return digest.hexdigest()


@functools.cache
def load_library() -> ctypes.CDLL:
    """Compile (if this source hash was never built, and building is not
    forbidden) and load the kernels."""
    out_dir = BUILD_ROOT / source_digest()[:16]
    lib_path = out_dir / "libicp_tpu_torch.so"
    t0 = time.perf_counter()
    log = ""
    if not lib_path.exists():
        if not _build_allowed:
            raise RuntimeError(f"{lib_path} is not built, and this process may not build "
                               "it: call load_library() in the launching process first")
        out_dir.mkdir(parents=True, exist_ok=True)
        # Build in a private directory and rename the library into place:
        # concurrent processes never load a half-written one.
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            log = _build(Path(tmp), lib_path)
        (out_dir / "build.log").write_text(log)
    elif (out_dir / "build.log").exists():  # built by an earlier process
        log = (out_dir / "build.log").read_text()
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.icp_launch_limit_message.argtypes = []
    lib.icp_launch_limit_message.restype = ctypes.c_char_p
    build_info.update(path=str(lib_path), seconds=time.perf_counter() - t0,
                      log=log)
    return lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point reported a launch limit (``ValueError``,
    naming the limit and the shape) or a CUDA error."""
    if status == LAUNCH_LIMIT:
        raise ValueError(load_library().icp_launch_limit_message().decode())
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


def require_rows(t: torch.Tensor, name: str, shape: tuple, dtype: torch.dtype,
                 device: torch.device) -> int:
    """Validate a (n_r, cq, w) argument that a kernel reads row by row:
    device, dtype, shape, unit lane stride and rows packed one after the
    other, so a slice of the lanes of a wider contiguous table qualifies.
    Returns the row stride in elements."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    ld = t.stride(1)
    if t.stride(2) != 1 or ld < shape[2] or t.stride(0) != ld * shape[1]:
        raise ValueError(f"{name}: rows must be packed, got strides {t.stride()}")
    return ld


def require_aligned(t: torch.Tensor, name: str, nbytes: int = 16) -> None:
    """A kernel that reads ``t`` in 16-byte vectors needs its data there."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name}: data must be {nbytes}-byte aligned")


def require_cuda(t: torch.Tensor, name: str) -> None:
    """Only CPU tensors take the plain twins; anything else must be CUDA."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: kernels run on CUDA tensors, got {t.device}")
