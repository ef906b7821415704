"""Build and load the package's CUDA kernels.

The kernels live as CUDA C++ sources under ``dmmfods_tpu_torch/csrc/``. At
first use each source is compiled with ``nvcc`` for Hopper (``sm_90a``) into
an object file, all of them at once in parallel, and the objects are linked
into one shared library with a plain C interface, which is loaded with
``ctypes``.
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
SOURCES = ("concat_bn_relu_conv1x1.cu", "dense_block_strip.cu", "phase_head.cu",
           "dense_block.cu", "stem_pool.cu", "dense_block_recompute.cu", "bn_relu.cu")
HEADERS = ("dtype.cuh", "dense_layer_tile.cuh", "dense_layer_mma.cuh",
           "tensor_core.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libdmmfods_kernels.so"

_lock = threading.Lock()
_lib = None
build_seconds = None   # wall time of the build this process ran; None if it reused one
build_log = ""         # nvcc's output (ptxas's report) of the build in use


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
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / source_hash() / LIB_NAME


def _run(cmds):
    """Run the commands all at once; raise with the output of the first that
    fails. Returns their combined output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in cmds]
    outputs = [p.communicate()[0] for p in procs]
    for cmd, proc, text in zip(cmds, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{text}")
    return "".join(outputs)


def _compile(target: Path) -> None:
    global build_seconds, build_log
    target.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objects = [str(Path(tmp) / (Path(s).stem + ".o")) for s in SOURCES]
        log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC_DIR / src)]
                    for src, obj in zip(SOURCES, objects)])
        # link to a private name, then rename: a concurrent process sees
        # either no library or a whole one
        lib = str(Path(tmp) / LIB_NAME)
        log += _run([[nvcc, "-shared", "-o", lib, *objects]])
        os.replace(lib, target)
    build_seconds = time.perf_counter() - t0
    build_log = log
    (target.parent / "nvcc.log").write_text(build_log)


def _declare(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    fn = lib.dmm_concat_bn_relu_conv1x1
    fn.argtypes = [p, p, p, p, p, p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, p]
    fn.restype = ctypes.c_int
    for name in ("dmm_dense_block_strip", "dmm_dense_block"):
        fn = getattr(lib, name)
        fn.argtypes = [p] * 8 + [ctypes.c_int] * 8 + [p]
        fn.restype = ctypes.c_int
    fn = lib.dmm_dense_block_recompute
    fn.argtypes = [p] * 8 + [ctypes.c_int] * 8 + [p] * 3 + [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    fn = lib.dmm_phase_head
    fn.argtypes = [p] * 9 + [ctypes.c_int] * 8 + [p]
    fn.restype = ctypes.c_int
    fn = lib.dmm_stem_pool
    fn.argtypes = [p] * 5 + [ctypes.c_int] * 6 + [p]
    fn.restype = ctypes.c_int
    fn = lib.dmm_bn_relu
    fn.argtypes = [p] * 4 + [ctypes.c_int64] + [ctypes.c_int] * 3 + [p]
    fn.restype = ctypes.c_int
    fn = lib.dmm_dense_block_plan
    fn.argtypes = [ctypes.c_int] * 6 + [p]
    fn.restype = ctypes.c_int
    fn = lib.dmm_dense_layer_mma_smem
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    fn = lib.dmm_phase_head_mma_smem
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    fn = lib.dmm_stem_pool_mma_smem
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    for name in ("dmm_concat_bn_relu_conv1x1_tile_n", "dmm_concat_bn_relu_conv1x1_mma_smem"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_int


def load() -> ctypes.CDLL:
    """The kernel library, built first if this tree has no build of it."""
    global _lib, build_log
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.is_file():
                _compile(path)
            elif (path.parent / "nvcc.log").is_file():
                build_log = (path.parent / "nvcc.log").read_text()
            lib = ctypes.CDLL(str(path))
            _declare(lib)
            _lib = lib
        return _lib
