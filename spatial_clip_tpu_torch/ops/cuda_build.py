"""Build and load the package's hand-written CUDA kernels.

The sources in ``spatial_clip_tpu_torch/csrc/*.cu`` have a plain C interface.
At first use each is compiled with ``nvcc`` for Hopper (``sm_90a``), all at
once in parallel, and the objects are linked into one shared library under
``build/kernels/`` at the repository root, named by a hash of the sources
(``*.cu`` and the ``*.cuh`` they include), so an edited source is rebuilt and
an unchanged one is reused. The library is loaded with :mod:`ctypes`.
Nothing here runs at import time: CPU-only installs import the package
freely and never reach ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

# the devices on which each wrapper runs its kernel's plain version: the CPU
# (the tests) and meta (shapes only, for ops/flops.py's count); on a CUDA
# tensor a wrapper launches its kernel, and on any other device it raises
PLAIN_DEVICES = ("cpu", "meta")


def plain_device(t: torch.Tensor) -> bool:
    """Whether a wrapper given ``t`` runs its kernel's plain version."""
    return t.device.type in PLAIN_DEVICES


CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the kernels' dtype argument, as every C entry point reads it
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_library = None


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _headers():
    return sorted(CSRC_DIR.glob("*.cuh"))


def _source_hash(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*sources, *_headers()]:
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
    nvcc = find_nvcc()
    tag = f"{lib.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    jobs = [(src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src, obj in zip(sources, objects)]  # one nvcc per source, all at once
    reports, failed = [], []
    for src, proc in jobs:
        out, _ = proc.communicate(timeout=900)
        reports.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"nvcc {src.name} failed ({proc.returncode}):\n{out[-4000:]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objects)],
                          capture_output=True, text=True, timeout=300)
    for obj in objects:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr[-4000:]}")
    # ptxas's register / shared-memory / spill report for each kernel
    lib.with_suffix(".ptxas.txt").write_text("\n".join(reports))
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.sc_attention_fwd.argtypes = [
                ptr, ptr, ptr, ptr,  # qkv, mask, out, lse
                i32, i32, i32, i32,  # B, L, H, hd
                i32, ctypes.c_float, ptr,  # dtype, scale, stream
            ]
            lib.sc_attention_fwd.restype = i32
            lib.sc_attention_bwd.argtypes = [
                ptr, ptr, ptr, ptr,  # qkv, mask, lse, dout
                ptr, ptr, ptr,  # dqkv, db partials, db
                i32, i32, i32, i32,  # B, L, H, hd
                i32, ctypes.c_float, ptr,  # dtype, scale, stream
            ]
            lib.sc_attention_bwd.restype = i32
            lib.sc_attention_bwd_recompute.argtypes = [
                ptr, ptr, ptr, ptr,  # qkv, mask, dout, dqkv
                i32, i32, i32, i32,  # B, L, H, hd
                i32, ctypes.c_float, ptr,  # dtype, scale, stream
            ]
            lib.sc_attention_bwd_recompute.restype = i32
            lib.sc_attention_bwd_recompute_db.argtypes = [
                ptr, ptr, ptr, ptr,  # qkv, mask, dout, dqkv
                ptr, ptr,  # db partials, db
                i32, i32, i32, i32,  # B, L, H, hd
                i32, ctypes.c_float, ptr,  # dtype, scale, stream
            ]
            lib.sc_attention_bwd_recompute_db.restype = i32
            lib.sc_attention_fwd_smem_bytes.argtypes = [i32, i32, i32]  # L, hd, dtype
            lib.sc_attention_fwd_smem_bytes.restype = ctypes.c_size_t
            i32p = ctypes.POINTER(i32)
            lib.sc_attention_fwd_occupancy.argtypes = [i32, i32, i32,  # L, hd, dtype
                                                       i32p, i32p, i32p]  # regs, local B, blocks
            lib.sc_attention_fwd_occupancy.restype = i32
            lib.sc_attention_bwd_smem_bytes.argtypes = [i32, i32, i32]
            lib.sc_attention_bwd_smem_bytes.restype = ctypes.c_size_t
            lib.sc_attention_bwd_occupancy.argtypes = [i32, i32, i32, i32,  # L, hd, dtype, option
                                                       i32p, i32p, i32p]  # regs, local B, blocks
            lib.sc_attention_bwd_occupancy.restype = i32
            for name in ("fwd", "bwd"):
                getattr(lib, f"sc_attention_{name}_max_seq").argtypes = [i32, i32]  # hd, dtype
                getattr(lib, f"sc_attention_{name}_max_seq").restype = i32
            lib.sc_attention_long_fwd.argtypes = lib.sc_attention_fwd.argtypes
            lib.sc_attention_long_bwd_dq.argtypes = [
                ptr, ptr, ptr, ptr,  # qkv, mask, lse, dout
                ptr, ptr, ptr, ptr,  # dqkv, r, db partial rows or null, stats rows (bf16)
                i32, i32, i32, i32,  # B, L, H, hd
                i32, ctypes.c_float, ptr,  # dtype, scale, stream
            ]
            lib.sc_attention_long_bwd_dkdv.argtypes = [
                ptr, ptr, ptr, ptr, ptr,  # qkv, mask, lse, r, dout
                ptr, ptr, ptr,  # dqkv, db partial rows or null, stats rows (bf16)
                i32, i32, i32, i32,  # B, L, H, hd
                i32, ctypes.c_float, ptr,  # dtype, scale, stream
            ]
            lib.sc_attention_long_db.argtypes = [ptr, ptr, ptr,  # dqkv, chunk sums, db
                                                 i32, i32, i32, ptr]  # rows, n, dtype, stream
            lib.sc_attention_long_db_partials.argtypes = [ptr, ptr,  # partial rows, db
                                                          i32, i32, ptr]  # rows, n, stream
            lib.sc_attention_long_fwd_split.argtypes = [
                ptr, ptr, ptr, ptr, ptr,  # qkv, mask, out, lse (row max), lsum
                i32, i32, i32, i32,  # B, L, H, hd
                i32, ctypes.c_float, ptr,  # dtype, scale, stream
            ]
            lib.sc_attention_long_bwd_dq_split.argtypes = [
                ptr, ptr, ptr, ptr, ptr,  # qkv, mask, lse, lsum, dout
                ptr, ptr, ptr, ptr,  # dqkv, r, db partial rows or null, stats rows (bf16)
                i32, i32, i32, i32,  # B, L, H, hd
                i32, ctypes.c_float, ptr,  # dtype, scale, stream
            ]
            lib.sc_attention_long_bwd_dkdv_split.argtypes = [
                ptr, ptr, ptr, ptr, ptr, ptr,  # qkv, mask, lse, lsum, r, dout
                ptr, ptr, ptr,  # dqkv, db partial rows or null, stats rows (bf16)
                i32, i32, i32, i32,  # B, L, H, hd
                i32, ctypes.c_float, ptr,  # dtype, scale, stream
            ]
            for name in ("fwd", "bwd_dq", "bwd_dkdv", "db", "db_partials", "fwd_split",
                         "bwd_dq_split", "bwd_dkdv_split"):
                getattr(lib, f"sc_attention_long_{name}").restype = i32
            lib.sc_attention_long_smem_bytes.argtypes = [i32, i32, i32]  # kind, hd, dtype
            lib.sc_attention_long_smem_bytes.restype = ctypes.c_size_t
            lib.sc_attention_long_plan.argtypes = [ctypes.POINTER(i32)]  # plan[8]
            lib.sc_attention_long_plan.restype = i32
            ce_inputs = [ptr] * 7  # q, kmat, col_ids, gt_ids, nbr, alphas, scale
            ce_scratch = [ptr, ctypes.c_size_t]  # scratch and its f32 elements
            ce_sizes = [i32] * 4  # B, N, D, k
            lib.sc_spatial_ce_scratch.argtypes = [i32, i32, i32, i32,  # kind, B, N, D
                                                  ctypes.POINTER(ctypes.c_size_t)]
            lib.sc_spatial_ce_scratch.restype = i32
            lib.sc_spatial_ce_plan.argtypes = [i32, i32, i32, i32, i32p]  # kind, B, N, D, plan[8]
            lib.sc_spatial_ce_plan.restype = i32
            lib.sc_spatial_ce_fwd.argtypes = [
                *ce_inputs, *ce_scratch, ptr, ptr, ptr,  # loss, lse, mass
                *ce_sizes, ptr,  # stream
            ]
            lib.sc_spatial_ce_fwd.restype = i32
            lib.sc_spatial_ce_dq.argtypes = [
                *ce_inputs, ptr, ptr, ptr,  # lse, mass, g
                *ce_scratch, ptr, ptr,  # dq, dscale
                *ce_sizes, ptr,
            ]
            lib.sc_spatial_ce_dq.restype = i32
            lib.sc_spatial_ce_dk.argtypes = [
                *ce_inputs, ptr, ptr, ptr,  # lse, mass, g
                *ce_scratch, ptr,  # dk
                *ce_sizes, ptr,
            ]
            lib.sc_spatial_ce_dk.restype = i32
            f32 = ctypes.c_float
            lib.sc_layer_norm_fwd.argtypes = [ptr, ptr, ptr, ptr,  # x, gamma, beta, y
                                              i32, i32, i32, f32, ptr]  # R, D, dtype, eps, stream
            lib.sc_layer_norm_fwd.restype = i32
            lib.sc_layer_norm_bwd.argtypes = [ptr, ptr, ptr, ptr,  # x, gamma, dy, dx
                                              ptr, ptr,  # partials, dgamma|dbeta
                                              i32, i32, i32, f32, ptr]
            lib.sc_layer_norm_bwd.restype = i32
            lib.sc_layer_norm_bwd_blocks.argtypes = [i32, i32, i32]  # rows, width, dtype
            lib.sc_layer_norm_bwd_blocks.restype = i32
            lib.sc_layer_norm_bwd_occupancy.argtypes = [i32, i32,  # width, dtype
                                                        i32p, i32p, i32p]  # regs, local B, blocks
            lib.sc_layer_norm_bwd_occupancy.restype = i32
            lib.sc_layer_norm_max_width.argtypes = []
            lib.sc_layer_norm_max_width.restype = i32
            lib.sc_ln_dense_fwd.argtypes = [ptr, ptr, ptr, ptr, ptr,  # x, w1, b1, y, xhat
                                            i32, i32, i32, i32, f32, ptr]  # R, K, N, dtype, eps
            lib.sc_ln_dense_fwd.restype = i32
            lib.sc_ln_dense_bwd_dx.argtypes = [ptr, ptr, ptr, ptr,  # x, g, w1, dx
                                               i32, i32, i32, i32, f32, ptr]
            lib.sc_ln_dense_bwd_dx.restype = i32
            lib.sc_mlp_fwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,  # x, w1, b1, w2, b2, out
                                       i32, i32, i32, i32, ptr]  # R, W, H, dtype, stream
            lib.sc_mlp_fwd.restype = i32
            pair_tower = [ptr, ptr, ptr, i32, i32, i32]  # qkv, mask, out, L, H, hd
            lib.sc_attention_pair_fwd.argtypes = [*pair_tower, *pair_tower,
                                                  i32, i32, f32, f32, ptr]  # B, dtype, scales
            lib.sc_attention_pair_fwd.restype = i32
            pair_tower_bwd = [ptr, ptr, ptr, ptr, i32, i32, i32]  # qkv, mask, g, dqkv, L, H, hd
            lib.sc_attention_pair_bwd.argtypes = [*pair_tower_bwd, *pair_tower_bwd,
                                                  i32, i32, f32, f32, ptr]
            lib.sc_attention_pair_bwd.restype = i32
            lib.sc_block_attn_fwd.argtypes = [
                ptr, ptr, ptr, ptr,  # x, gamma, beta, W_qkv
                ptr, ptr, ptr, ptr,  # b_qkv, W_out, b_out, mask
                ptr, ptr, ptr,  # the q|k|v and context workspaces, out
                i32, i32, i32, i32,  # B, L, D, heads
                i32, f32, f32, ptr,  # dtype, eps, scale, stream
            ]
            lib.sc_block_attn_fwd.restype = i32
            lib.sc_block_attn_smem_bytes.argtypes = [i32, i32, i32, i32]  # L, D, heads, dtype
            lib.sc_block_attn_smem_bytes.restype = ctypes.c_size_t
            lib.sc_block_attn_plan.argtypes = [i32, i32, i32, i32p]  # L, D, heads, plan[15]
            lib.sc_block_attn_plan.restype = i32
            i64, dims = ctypes.c_longlong, [i32, i32, i32, i32]  # B, L, H, hd
            tail = [i32, f32, ptr]  # dtype, scale, stream
            lib.sc_attention_inter_fwd.argtypes = [ptr, ptr, ptr, *dims, i32, *tail]  # hpb
            lib.sc_attention_inter_bwd.argtypes = [ptr, ptr, ptr, ptr, *dims, i32, *tail]
            lib.sc_attention_split_fwd.argtypes = [ptr] * 5 + [*dims, *tail]  # q, k, v, mask, out
            lib.sc_attention_split_bwd.argtypes = [ptr] * 8 + [*dims, *tail]  # .., dout, dq, dk, dv
            lib.sc_attention_t_fwd.argtypes = [ptr, i64, i64, ptr, ptr, ptr, *dims, *tail]
            lib.sc_attention_t_bwd.argtypes = [ptr, i64, i64, ptr, ptr, ptr,  # .., bias, mask, dout
                                               ptr, ptr, ptr,  # dqkv, db partials, db
                                               *dims, *tail]
            lib.sc_attention_slab_fwd.argtypes = [ptr, ptr, ptr, *dims, *tail]
            lib.sc_attention_slab_bwd.argtypes = [ptr, ptr, ptr, ptr, *dims, *tail]
            lib.sc_attention_bwd_dx.argtypes = [ptr, ptr, ptr, ptr,  # qkv, mask, dout, w
                                                ptr, ptr, ptr, ptr,  # dqkv, dx, db partials, db
                                                *dims, i32, *tail]  # .., din
            for name in ("inter_fwd", "inter_bwd", "split_fwd", "split_bwd", "t_fwd", "t_bwd",
                         "slab_fwd", "slab_bwd", "bwd_dx"):
                getattr(lib, f"sc_attention_{name}").restype = i32
            lib.sc_attention_bwd_dx_plan.argtypes = [i32, i32, i32, i32, i32p]  # L, H, hd, din
            lib.sc_attention_bwd_dx_plan.restype = i32
            lib.sc_mlp_max_width.argtypes = []
            lib.sc_mlp_max_width.restype = i32
            lib.sc_mlp_plan.argtypes = [i32, i32, i32, i32p]  # R, W, H, plan[6]
            lib.sc_mlp_plan.restype = i32
            lib.sc_ln_dense_fwd_plan.argtypes = [i32, i32, i32, i32p]  # R, K, N, plan[5]
            lib.sc_ln_dense_fwd_plan.restype = i32
            lib.sc_ln_dense_bwd_dx_plan.argtypes = [i32, i32, i32, i32p]  # R, K, N, plan[7]
            lib.sc_ln_dense_bwd_dx_plan.restype = i32
            lib.sc_cuda_error_string.argtypes = [ctypes.c_int]
            lib.sc_cuda_error_string.restype = ctypes.c_char_p
            _library = lib
        return _library


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        msg = lib.sc_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
