"""Run a function on every rank of a process group of spawned processes.

:func:`spawn` is how one machine simulates a data-parallel run
(``trainer.sim_devices``, the JAX package's ``jax_num_cpu_devices``): it
starts ``world_size`` processes with the ``spawn`` method, joins them in a
group through a ``FileStore`` (no port to pick), runs ``fn(rank, *args)`` on
each and returns the results in rank order. A rank that fails, or dies,
stops the others and raises here with its traceback.
"""
from __future__ import annotations

import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from spatial_clip_tpu_torch.parallel.mesh import init_distributed


def _child(fn, rank: int, world_size: int, backend: str, store_path: str,
           device: Optional[str], threads: Optional[int], args, results) -> None:
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = torch.device(device) if device is not None else None
        if dev is not None and dev.type == "cuda":
            torch.cuda.set_device(dev)
        init_distributed(backend, rank, world_size, store_path=store_path, device=dev)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        # by value: a queue would pass tensors as shared memory that this
        # process takes with it when it exits
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn: Callable[..., Any], world_size: int, args: Sequence[Any] = (),
          backend: str = "gloo", device: Optional[str] = None, threads: Optional[int] = None,
          timeout: float = 600.0) -> List[Any]:
    """``[fn(0, *args), ..., fn(world_size - 1, *args)]``, each run in a
    process of its own, in a ``backend`` group. ``fn`` and ``args`` are
    pickled (``fn`` a module-level function); so are the results.
    ``device``: each rank's device (``cuda:0`` for ranks that share one
    card over gloo). ``threads``: each rank's intra-op threads. The ranks
    meet through a file in a temporary directory."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = str(Path(tmp) / "store")
        procs = [ctx.Process(target=_child, daemon=False,
                             args=(fn, r, world_size, backend, store, device, threads, args,
                                   results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        out, failures = {}, []
        deadline = time.monotonic() + timeout
        try:
            while len(out) < world_size and not failures:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [i for i, p in enumerate(procs) if p.exitcode not in (None, 0)
                            and i not in out]
                    if dead:
                        failures.append(f"rank {dead[0]} exited with code "
                                        f"{procs[dead[0]].exitcode}")
                    elif time.monotonic() > deadline:
                        failures.append(f"ranks {sorted(set(range(world_size)) - set(out))} "
                                        f"did not finish in {timeout:.0f} s")
                    continue
                if ok:
                    out[rank] = pickle.loads(value)
                else:
                    failures.append(f"rank {rank} failed:\n{value}")
        finally:
            for p in procs:
                if failures:
                    p.kill()
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
    if failures:
        raise RuntimeError("spawned ranks failed: " + "\n".join(failures))
    return [out[r] for r in range(world_size)]
