"""ctypes bindings of the native host library (port of
``icp_tpu.runtime.native``).

``native/icp_host.cpp`` (cloud codec, validation and the CPU golden
oracles) and ``native/frame_source.cpp`` (the prefetching frame ring) are
compiled with ``g++`` and the flags of ``native/Makefile`` into
``build/icp_tpu_torch/host/<hash>/libicp_host.so`` beside the package,
keyed by a hash of the sources and flags, so a changed source rebuilds and an
unchanged one loads the existing library. Nothing is written under
``native/`` and the library kept there is never loaded. The build runs at
the first call, never on import. Every entry point but
:func:`golden_solve` has a numpy fallback, taken when no compiler is at
hand; :data:`build_info` says which one ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np

from icp_tpu_torch.sensors.io import read_cloud_bin, write_cloud_bin

NATIVE = Path(__file__).resolve().parent.parent.parent / "native"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "icp_tpu_torch" / "host"
SOURCES = ("icp_host.cpp", "frame_source.cpp")
CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra"]  # native/Makefile's

_P = ctypes.c_void_p
_FP = ctypes.POINTER(ctypes.c_float)
_L = ctypes.c_long
# name -> (result type, argument types)
SIGNATURES = {
    "icp_read_cloud": (_L, [ctypes.c_char_p, _FP, _L]),
    "icp_write_cloud": (ctypes.c_int, [ctypes.c_char_p, _FP, _L]),
    "icp_validate_cloud": (_L, [_FP, _L]),
    "icp_golden_nn": (None, [_FP, _L, _FP, _L, ctypes.c_float,
                             ctypes.POINTER(ctypes.c_int), _FP]),
    "icp_golden_solve": (None, [_FP, _FP, _FP, _L, ctypes.c_int, ctypes.c_int,
                                ctypes.c_float, _FP]),
    "fs_open": (_P, [ctypes.c_char_p, _L, _L]),
    "fs_count": (_L, [_P]),
    "fs_next": (_L, [_P, _FP]),
    "fs_close": (None, [_P]),
}

# filled by load(): path, seconds, log, built (compiled by this process), or error
build_info: dict = {}

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build(lib_path: Path) -> str:
    """Compile the sources into ``lib_path`` in a private directory, then
    rename the library into place, so a concurrent process never loads a
    half-written one. Returns the compiler's output."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    with tempfile.TemporaryDirectory(dir=lib_path.parent) as tmp:
        out = Path(tmp) / lib_path.name
        proc = subprocess.run(
            [cxx, *CXXFLAGS, "-shared", "-o", str(out),
             *(str(NATIVE / s) for s in SOURCES), "-lpthread"],
            capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(out, lib_path)
    return proc.stdout + proc.stderr


def load() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; None if it cannot be built
    or loaded (the numpy fallbacks then run, and ``build_info["error"]``
    says why)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    digest = hashlib.sha256(" ".join(CXXFLAGS).encode())
    for name in SOURCES:
        digest.update(name.encode())
        digest.update((NATIVE / name).read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib_path = out_dir / "libicp_host.so"
    t0 = time.perf_counter()
    built = not lib_path.exists()
    try:
        log = ""
        if built:
            out_dir.mkdir(parents=True, exist_ok=True)
            log = _build(lib_path)
            (out_dir / "build.log").write_text(log)
        lib = ctypes.CDLL(str(lib_path))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        build_info.update(path=None, seconds=time.perf_counter() - t0, error=str(e))
        return None
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    build_info.update(path=str(lib_path), seconds=time.perf_counter() - t0, log=log,
                      built=built)
    _lib = lib
    return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_FP)


def read_cloud(path: str, max_points: int = 640 * 480) -> np.ndarray:
    """Native mmap cloud read; numpy fallback."""
    lib = load()
    if lib is None:
        return read_cloud_bin(path)
    out = np.empty((max_points, 8), np.float32)
    n = lib.icp_read_cloud(str(path).encode(), _fptr(out), max_points)
    if n < 0:
        raise IOError(f"native read failed for {path}")
    return out[:n]


def write_cloud(path: str, cloud: np.ndarray) -> None:
    """Native cloud write; numpy fallback."""
    lib = load()
    arr = np.ascontiguousarray(cloud, np.float32)
    if lib is None:
        write_cloud_bin(path, arr)
        return
    if lib.icp_write_cloud(str(path).encode(), _fptr(arr), len(arr)) != 0:
        raise IOError(f"native write failed for {path}")


def validate_cloud(cloud: np.ndarray) -> int:
    """Count valid points; raises on non-finite data. Native or numpy."""
    arr = np.ascontiguousarray(cloud, np.float32)
    lib = load()
    if lib is None:
        if not np.isfinite(arr).all():
            raise ValueError("cloud contains non-finite values")
        return int((np.abs(arr[:, :3]).sum(1) > 0).sum())
    n = lib.icp_validate_cloud(_fptr(arr), len(arr))
    if n < 0:
        raise ValueError("cloud contains non-finite values")
    return int(n)


def golden_nn(queries: np.ndarray, db: np.ndarray, alpha: float):
    """Native exact-NN oracle (O(mn)); numpy fallback."""
    q = np.ascontiguousarray(queries, np.float32)
    d = np.ascontiguousarray(db, np.float32)
    lib = load()
    if lib is None:
        w = np.array([1, 1, 1, 0, alpha, alpha, alpha, 0], np.float32)
        d2 = (((q[:, None, :] - d[None, :, :]) ** 2) * w).sum(-1)
        return d2.argmin(1).astype(np.int32), d2.min(1).astype(np.float32)
    idx = np.empty((len(q),), np.int32)
    dist = np.empty((len(q),), np.float32)
    lib.icp_golden_nn(_fptr(q), len(q), _fptr(d), len(d), ctypes.c_float(alpha),
                      idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), _fptr(dist))
    return idx, dist


def golden_solve(moving: np.ndarray, fixed: np.ndarray, d2: np.ndarray,
                 weighted: bool = True, estimate_scale: bool = True,
                 c: float = 1e-6) -> np.ndarray:
    """Native golden Horn solve from matched pairs -> T[8] (reference
    layout [qx,qy,qz,qw, tx,ty,tz,sk]); no fallback."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    mv = np.ascontiguousarray(moving, np.float32)
    fx = np.ascontiguousarray(fixed, np.float32)
    dd = np.ascontiguousarray(d2, np.float32)
    Tk = np.empty((8,), np.float32)
    lib.icp_golden_solve(_fptr(mv), _fptr(fx), _fptr(dd), len(mv), int(weighted),
                         int(estimate_scale), ctypes.c_float(c), _fptr(Tk))
    return Tk
