"""Build and load the package's hand-written CUDA kernels.

The sources in ``spatial_clip_tpu_torch/csrc/*.cu`` have a plain C interface.
At first use they are compiled with ``nvcc`` for Hopper (``sm_90a``) into one
shared library under ``build/kernels/`` at the repository root, named by a
hash of the sources, so an edited source is rebuilt and an unchanged one is
reused. The library is loaded with :mod:`ctypes`. Nothing here runs at import
time: CPU-only installs import the package freely and never reach ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_library = None


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _source_hash(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(str(Path(os.environ[env]) / "bin" / "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
        "the CUDA kernels of spatial_clip_tpu_torch are built from source")


def build() -> Path:
    """Compile the kernel library if no build of these sources exists."""
    sources = _sources()
    lib = BUILD_DIR / f"libspatial_clip_kernels_{_source_hash(sources)}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr[-4000:]}")
    # ptxas's register / shared-memory / spill report for each kernel
    lib.with_suffix(".ptxas.txt").write_text(proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            lib.sc_attention_fwd.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # qkv, mask, out
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, L, H, hd
                ctypes.c_int, ctypes.c_float, ctypes.c_void_p,  # dtype, scale, stream
            ]
            lib.sc_attention_fwd.restype = ctypes.c_int
            lib.sc_cuda_error_string.argtypes = [ctypes.c_int]
            lib.sc_cuda_error_string.restype = ctypes.c_char_p
            _library = lib
        return _library


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        msg = lib.sc_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
