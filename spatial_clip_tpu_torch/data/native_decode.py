"""Native PNG/JPEG decode (native/imagedec.cpp) with a PIL fallback;
counterpart of ``spatial_clip_tpu.data.native_decode``, loading the same
built library in place.

Image decode is the measured host bottleneck on both hot host paths —
the tar-shard training loader (tiles/sec/core) and the serving image
endpoint (reports/bench_serve_img.json: decode-bound at 188.7 tiles/sec on
a 1-core host). ``decode_rgb`` returns an (H, W, 3) uint8 array straight
from libpng/libjpeg with no PIL mode machinery; callers keep their PIL
path for formats/features the native path declines (returns None).
"""
from __future__ import annotations

import ctypes
import logging
from typing import Optional

import numpy as np

from spatial_clip_tpu_torch.data.datasets._native import _find_lib

log = logging.getLogger(__name__)

_configured = False
_lib = None


def get_declib():
    """Load + bind libscimagedec.so once; None when absent (PIL fallback).

    The decoder lives in its OWN shared library (not the dependency-free
    tar indexer's) so a host without libpng/libjpeg keeps the indexer."""
    global _configured, _lib
    if _configured:
        return _lib
    _configured = True
    path = _find_lib("libscimagedec.so")
    if path is None:
        log.debug("libscimagedec.so not built; PIL fallback")
        return None
    try:
        lib = ctypes.CDLL(str(path))
        lib.sc_image_info.restype = ctypes.c_int
        lib.sc_image_info.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.sc_decode_rgb.restype = ctypes.c_int
        lib.sc_decode_rgb.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
        ]
        _lib = lib
    except (OSError, AttributeError) as e:
        log.warning("failed to load %s: %s; PIL fallback", path, e)
        _lib = None
    return _lib


def decode_rgb_into(data: bytes, out: np.ndarray) -> bool:
    """Decode PNG/JPEG bytes directly into ``out`` (an (H, W, 3) uint8
    C-contiguous array, e.g. one row of a preallocated batch) when the
    image's dimensions match exactly. Returns False when the native path
    is unavailable, declines the payload, or dims differ (caller falls
    back to :func:`decode_rgb` / PIL + resize). Skipping the per-tile
    allocation + np.stack pass saves ~0.23 ms/tile on the serving path
    (docs/experiments.md round-5 attribution)."""
    lib = get_declib()
    if lib is None:
        return False
    if not (out.flags["C_CONTIGUOUS"] and out.dtype == np.uint8
            and out.ndim == 3 and out.shape[2] == 3):
        return False
    w = ctypes.c_int(0)
    h = ctypes.c_int(0)
    if lib.sc_image_info(data, len(data), ctypes.byref(w),
                         ctypes.byref(h)) != 0:
        return False
    if (h.value, w.value) != out.shape[:2]:
        return False
    rc = lib.sc_decode_rgb(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.nbytes)
    return rc == 0


def decode_rgb(data: bytes) -> Optional[np.ndarray]:
    """Decode PNG/JPEG bytes to an (H, W, 3) uint8 array, or None when the
    native path is unavailable / declines the payload (caller uses PIL)."""
    lib = get_declib()
    if lib is None:
        return None
    w = ctypes.c_int(0)
    h = ctypes.c_int(0)
    if lib.sc_image_info(data, len(data), ctypes.byref(w),
                         ctypes.byref(h)) != 0:
        return None
    out = np.empty((h.value, w.value, 3), dtype=np.uint8)
    rc = lib.sc_decode_rgb(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.nbytes)
    if rc != 0:
        return None
    return out
