"""ctypes bindings for the C++ data-loader core (native/tarindex.cpp);
counterpart of ``spatial_clip_tpu.data.datasets._native``, loading the same
built library in place.

Provides fast tar indexing (``index_tar``) used by ShardedSpatialDataset at
startup; falls back to Python tarfile when the shared library has not been
built (``make -C native``). The library is looked up only in the repo root's
``native/`` and in ``$SPATIAL_CLIP_NATIVE``.
"""
from __future__ import annotations

import ctypes
import logging
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

log = logging.getLogger(__name__)

_LIB_NAME = "libspatialclip_native.so"
_lib = None
_checked = False


def _find_lib(name: str = _LIB_NAME) -> Optional[Path]:
    """The built ``name`` in this checkout's ``native/`` (or, for the tar
    indexer, ``$SPATIAL_CLIP_NATIVE``); nothing outside the checkout."""
    env = os.environ.get("SPATIAL_CLIP_NATIVE")
    candidates = []
    if env and name == _LIB_NAME:
        candidates.append(Path(env))
    candidates.append(Path(__file__).resolve().parents[3] / "native" / name)
    for c in candidates:
        if c.is_file():
            return c
    return None


def get_lib():
    global _lib, _checked
    if _checked:
        return _lib
    _checked = True
    path = _find_lib()
    if path is None:
        log.debug("native tar indexer not built; using tarfile fallback")
        return None
    try:
        lib = ctypes.CDLL(str(path))
        lib.tarindex_index.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.tarindex_index.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.tarindex_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.tarindex_pread.restype = ctypes.c_int64
        lib.tarindex_pread.argtypes = [
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        _lib = lib
    except OSError as e:
        log.warning("failed to load %s: %s", path, e)
        _lib = None
    return _lib


def index_tar_native(path: str) -> Optional[Dict[str, Tuple[int, int]]]:
    """name -> (offset_data, size) via the C++ indexer; None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    out_len = ctypes.c_uint64()
    out_count = ctypes.c_uint64()
    buf = lib.tarindex_index(str(path).encode(), ctypes.byref(out_len), ctypes.byref(out_count))
    if not buf:
        return None
    try:
        raw = ctypes.string_at(buf, out_len.value)
    finally:
        lib.tarindex_free(buf)
    out: Dict[str, Tuple[int, int]] = {}
    pos = 0
    import struct

    for _ in range(out_count.value):
        (nl,) = struct.unpack_from("<I", raw, pos)
        pos += 4
        name = raw[pos : pos + nl].decode("utf-8", "replace")
        pos += nl
        offset, size = struct.unpack_from("<QQ", raw, pos)
        pos += 16
        out[name] = (offset, size)
    return out
