"""ctypes binding of the host runtime's LiDAR splat (``native/dmmfods_io.cpp``).

Only the splat entries are bound: ``dmm_splat_pooled_f32`` (one sample) and
``dmm_splat_pooled_batch_f32`` (a ragged batch over worker threads, the GIL
released for the whole call). At first use the source is compiled with
``g++`` and the flags of ``native/Makefile`` into
``dmmfods_tpu_torch/_build/<hash>/libdmmfods_io.so``, keyed by a hash of the
source, the flags and the compiler (``$CXX``, else ``g++`` on the path), so
an edited source or another compiler rebuilds and an unchanged one is
reused; nothing is written under ``native/``. Nothing here runs at import
time. :func:`available` says whether the library built (without ``g++`` it
does not, and callers take the numpy form).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR.parent / "native" / "dmmfods_io.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "libdmmfods_io.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_lock = threading.Lock()
_lib = None
build_error = None     # why the library did not build, once a build failed


def _compiler() -> str:
    """``$CXX``, else the path of ``g++``; empty if neither is there."""
    return os.environ.get("CXX") or shutil.which("g++") or ""


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((_compiler(), *CXX_FLAGS)).encode())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


def _compile(target: Path) -> None:
    cxx = _compiler()
    if not cxx:
        raise RuntimeError("g++ not found")
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        # build under a private name, then rename: a concurrent process sees
        # either no library or a whole one
        lib = Path(tmp) / LIB_NAME
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(lib), str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(lib, target)


def _declare(lib: ctypes.CDLL) -> None:
    f32p, i64p, i64 = ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64
    lib.dmm_splat_pooled_f32.restype = ctypes.c_int
    lib.dmm_splat_pooled_f32.argtypes = [f32p, i64, i64, i64, f32p]
    lib.dmm_splat_pooled_batch_f32.restype = ctypes.c_int
    lib.dmm_splat_pooled_batch_f32.argtypes = [f32p, i64p, i64, i64, i64, f32p, i64]


def load():
    """The library, built first if this tree has no build of it; None if it
    cannot be built (``build_error`` says why)."""
    global _lib, build_error
    with _lock:
        if _lib is None and build_error is None:
            try:
                path = library_path()
                if not path.is_file():
                    _compile(path)
                lib = ctypes.CDLL(str(path))
                _declare(lib)
                _lib = lib
            except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
                build_error = str(exc)
        return _lib


def available() -> bool:
    return load() is not None


def _loaded():
    lib = load()
    if lib is None:
        raise RuntimeError(f"the native splat library did not build: {build_error}")
    return lib


def _ptr(arr):
    return arr.ctypes.data_as(ctypes.c_void_p)


def _points(points):
    """``points`` as a C-contiguous float32 ``(n, 3)`` array, or raise."""
    pts = np.ascontiguousarray(points, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points must be (n, 3), got {pts.shape}")
    return pts


def splat_pooled(points, height=1280, width=1920):
    """One sample's points ``(n, 3)`` -> the pooled model input
    ``(height // 10, width // 10, 1)`` float32."""
    pts = _points(points)
    lib = _loaded()
    out = np.empty((height // 10, width // 10), np.float32)
    status = lib.dmm_splat_pooled_f32(_ptr(pts), len(pts), height, width, _ptr(out))
    if status != 0:
        raise ValueError(f"native splat failed ({status})")
    return out[:, :, None]


def splat_pooled_batch(points_concat, offsets, height=1280, width=1920, num_threads=2):
    """Ragged batch: sample ``i`` owns ``points_concat[offsets[i]:offsets[i +
    1]]``. Returns ``(batch, height // 10, width // 10, 1)`` float32 from one
    C call over ``num_threads`` threads."""
    pts = _points(points_concat)
    offs = np.ascontiguousarray(offsets, np.int64)
    if (offs.ndim != 1 or len(offs) < 1 or offs[0] < 0 or offs[-1] > len(pts)
            or (np.diff(offs) < 0).any()):
        raise ValueError(f"offsets must rise from >= 0 to <= {len(pts)}, got {offs}")
    batch = len(offs) - 1
    lib = _loaded()
    out = np.empty((batch, height // 10, width // 10), np.float32)
    status = lib.dmm_splat_pooled_batch_f32(_ptr(pts), _ptr(offs), batch, height, width,
                                            _ptr(out), num_threads)
    if status != 0:
        raise ValueError(f"native batch splat failed ({status})")
    return out[:, :, :, None]
