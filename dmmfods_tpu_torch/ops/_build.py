"""Build and load the package's CUDA kernels.

The kernels live as CUDA C++ sources under ``dmmfods_tpu_torch/csrc/``. At
first use they are compiled with ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, which is loaded with ``ctypes``.
The library goes to ``dmmfods_tpu_torch/_build/<hash>/``, keyed by a hash of
the sources and the compiler flags, so an edit to a source rebuilds and an
unchanged tree reuses the last build. Nothing here runs at import time.

Each call of a C entry point returns the ``cudaError_t`` of its launch; the
Python wrappers raise on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("concat_bn_relu_conv1x1.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libdmmfods_kernels.so"

_lock = threading.Lock()
_lib = None
build_seconds = None   # wall time of the build this process ran; None if it reused one
build_log = ""         # nvcc's output (ptxas register / shared-memory report)


def _nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH, else
    the toolkit's usual place."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / source_hash() / LIB_NAME


def _compile(target: Path) -> None:
    global build_seconds, build_log
    target.parent.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent process sees
    # either no library or a whole one
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC_DIR / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    (target.parent / "nvcc.log").write_text(build_log)
    os.replace(tmp, target)


def _declare(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    fn = lib.dmm_concat_bn_relu_conv1x1
    fn.argtypes = [p, p, p, p, p, p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, p]
    fn.restype = ctypes.c_int


def load() -> ctypes.CDLL:
    """The kernel library, built first if this tree has no build of it."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.is_file():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            _declare(lib)
            _lib = lib
        return _lib
