"""Mirror a run directory to another location, once or in the background
(counterpart of ``spatial_clip_tpu.utils.file_sync``).

:func:`remote_sync` copies what is new or has changed size, skipping files
whose path under the run directory holds ``latest`` or ``.tmp`` (they may be
mid-write: the checkpoint writer fills ``.tmp_step_N/`` and then renames
it; the JAX package's local copy looks at the file's name alone, so it
copies a checkpoint still being written);
:func:`start_sync_process` returns a daemon process that syncs every
``sync_every`` seconds (the caller starts it after one synchronous sync
succeeds). Protocols:

- ``local``: a filesystem copy (a mounted bucket or NFS);
- ``fsspec``: an fsspec mapper copy, where fsspec is installed;
- ``s3``: ``aws s3 sync``, where the aws CLI is installed.

Each returns False, and logs why, when it fails or its tool is absent.
"""
from __future__ import annotations

import logging
import multiprocessing
import shutil
import subprocess
import time
from pathlib import Path

log = logging.getLogger(__name__)

# files that may be mid-write when the sync fires (atomic-replace targets)
SKIP_SUBSTRINGS = ("latest", ".tmp")


def _should_skip(name: str) -> bool:
    return any(s in name for s in SKIP_SUBSTRINGS)


def remote_sync_local(local_dir: str, remote_dir: str) -> bool:
    src, dst = Path(local_dir), Path(remote_dir)
    try:
        dst.mkdir(parents=True, exist_ok=True)
        for p in src.rglob("*"):
            if p.is_dir() or _should_skip(str(p.relative_to(src))):
                continue
            target = dst / p.relative_to(src)
            if target.exists() and target.stat().st_size == p.stat().st_size:
                continue
            target.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy2(p, target)
        return True
    except OSError as e:
        log.error("local remote-sync failed: %s", e)
        return False


def remote_sync_fsspec(local_dir: str, remote_dir: str) -> bool:
    try:
        import fsspec
    except ImportError:
        log.error("fsspec not installed; use protocol 'local' or 's3'")
        return False
    a, b = fsspec.get_mapper(local_dir), fsspec.get_mapper(remote_dir)
    ok = True
    for k in a:
        if _should_skip(k):
            continue
        try:
            if k in b and len(a[k]) == len(b[k]):
                continue
            b[k] = a[k]
        except Exception as e:  # noqa: BLE001 (remote backends raise anything)
            log.error("fsspec sync error for %s: %s", k, e)
            ok = False
    return ok


def remote_sync_s3(local_dir: str, remote_dir: str) -> bool:
    try:
        result = subprocess.run(
            ["aws", "s3", "sync", local_dir, remote_dir, "--exclude", "*latest*"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    except FileNotFoundError:
        log.error("the aws CLI is not installed; use protocol 'local' or 'fsspec'")
        return False
    if result.returncode != 0:
        log.error("aws s3 sync failed: %s", result.stderr.decode())
        return False
    return True


_PROTOCOLS = {"local": remote_sync_local, "fsspec": remote_sync_fsspec, "s3": remote_sync_s3}


def remote_sync(local_dir: str, remote_dir: str, protocol: str = "local") -> bool:
    fn = _PROTOCOLS.get(protocol)
    if fn is None:
        log.error("unknown remote-sync protocol %r", protocol)
        return False
    return fn(local_dir, remote_dir)


def _keep_running(sync_every: float, local_dir: str, remote_dir: str, protocol: str):
    while True:
        time.sleep(sync_every)
        remote_sync(local_dir, remote_dir, protocol)


def start_sync_process(sync_every: float, local_dir: str, remote_dir: str,
                       protocol: str = "local") -> multiprocessing.Process:
    """A daemon process that syncs every ``sync_every`` seconds (not yet
    started). Spawned, not forked: a fork of a trainer that runs threads
    (the checkpoint writer, PyTorch's pools) can inherit a held lock."""
    return multiprocessing.get_context("spawn").Process(
        target=_keep_running, args=(sync_every, local_dir, remote_dir, protocol), daemon=True)
