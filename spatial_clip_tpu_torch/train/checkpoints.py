"""Checkpoints of the training state, and weight files to trade with the JAX
package and open_clip (counterpart of ``spatial_clip_tpu.train.checkpoints``).

:class:`CheckpointManager` keeps the JAX package's layout and retention:
``ckpt_dir/step_{N}/`` holding the state file and ``meta.json``
(``{"step": N, "metrics": {...}}``), written into ``.tmp_step_{N}`` and then
renamed, with all but the newest ``keep`` steps pruned after each write. At
most one write is in flight on a writer thread; :meth:`~CheckpointManager.wait`
joins it, and every read waits for it first. ``restore(step=None)`` restores
the newest step.

The JAX package writes ``state.msgpack`` with flax. This package writes
``state.pt`` (``torch.save``, read back with ``weights_only=True``), which
carries:

- ``params``: the flat float32 parameter buffer of
  :class:`~spatial_clip_tpu_torch.train.loop.TrainState` (the alignment gaps
  hold zeros), with ``order``, ``offsets`` and ``shapes``, its layout;
- ``mu`` and ``nu``: the optimizer's moments' flat buffers in their storage
  dtypes (Adam's in bfloat16 by default; SGD's trace or Lion's moment in
  ``mu``, f32, with ``nu`` empty);
- ``count`` (the optimizer's step count) and ``step`` (the train step's);
- ``generator`` and ``generator_device``: the state of
  ``TrainState.generator``, which draws the augmentations, so that a resumed
  run draws the flips and jitters the unbroken run would have drawn.

:meth:`~CheckpointManager.save` copies the state to host memory before it
returns: the optimizer updates the flat buffers in place, so a copy still in
flight when the next step runs would be torn. Only the serialization runs on
the writer thread.

:func:`save_params_npz` / :func:`load_params_npz` read and write the JAX
package's flat ``params.npz`` (its flax key names, ``/``-joined), and
:func:`export_torch_state_dict` writes an open_clip state dict.
"""
from __future__ import annotations

import json
import logging
import re
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

log = logging.getLogger(__name__)

_STEP_RE = re.compile(r"step_(\d+)")
STATE_FILE = "state.pt"
FORMAT = 1


def flatten_params(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(flatten_params(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def unflatten_params(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def host_state(state) -> Dict[str, Any]:
    """A complete host copy of a TrainState, in the state file's schema. A
    copy from the GPU to pageable memory waits for the device, so the copy
    is finished when this returns."""
    flat = state.flat
    return {
        "format": FORMAT,
        "order": list(state.order),
        "offsets": [int(state.offsets[k]) for k in state.order],
        "shapes": [list(state.params[k].shape) for k in state.order],
        "params": flat["params"].detach().to("cpu", copy=True),
        "mu": flat["mu"].detach().to("cpu", copy=True),
        "nu": flat["nu"].detach().to("cpu", copy=True),
        "count": int(state.count),
        "step": int(state.step),
        "generator": state.generator.get_state().clone(),
        "generator_device": state.generator.device.type,
    }


def state_file_params(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """The parameters in a state file (a ``step_N`` directory or its
    ``state.pt``), by this package's names, as float32 CPU tensors."""
    path = Path(path)
    if path.is_dir():
        path = path / STATE_FILE
    host = torch.load(path, map_location="cpu", weights_only=True)
    flat = host["params"]
    return {k: flat[off:off + int(np.prod(shape))].view(shape).clone()
            for k, off, shape in zip(host["order"], host["offsets"], host["shapes"])}


def load_host_state(host: Dict[str, Any], target):
    """Copy a host state (:func:`host_state`'s schema) into ``target``, a
    TrainState with the same layout, in place; returns ``target``."""
    layout = (list(target.order), [int(target.offsets[k]) for k in target.order],
              [list(target.params[k].shape) for k in target.order])
    if host.get("format") != FORMAT:
        raise ValueError(f"state file format {host.get('format')!r}, want {FORMAT}")
    if (host["order"], host["offsets"], host["shapes"]) != layout:
        raise ValueError("the checkpoint's parameter layout differs from the trainer's model")
    for key in ("params", "mu", "nu"):
        src, dst = host[key], target.flat[key]
        if src.dtype != dst.dtype or src.shape != dst.shape:
            raise ValueError(f"checkpoint {key} is {src.dtype} {tuple(src.shape)}, the state's "
                             f"{dst.dtype} {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(src)
    target.count, target.step = int(host["count"]), int(host["step"])
    if host["generator_device"] == target.generator.device.type:
        target.generator.set_state(host["generator"])
    else:
        log.warning("checkpoint's augmentation generator was on %s, the state's is on %s: "
                    "kept the state's", host["generator_device"], target.generator.device.type)
    return target


class CheckpointManager:
    """Step-indexed checkpoints under ``ckpt_dir``, the newest ``keep`` kept."""

    def __init__(self, ckpt_dir: Union[str, Path], keep: int = 3):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None
        self.dir.mkdir(parents=True, exist_ok=True)

    def save(self, state, step: int, metrics: Optional[Dict] = None):
        """Checkpoint ``state`` (a TrainState) at ``step``: the host copy is
        made here, the write runs on the writer thread after any earlier
        write has finished."""
        host = host_state(state)
        self.wait()  # at most one write in flight
        self._pending = self._pool.submit(self._write, host, step, metrics)

    def wait(self):
        """Block until any in-flight write completes (raising its error)."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def _write(self, host: Dict[str, Any], step: int, metrics: Optional[Dict]):
        target = self.dir / f"step_{step}"
        tmp = self.dir / f".tmp_step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        torch.save(host, tmp / STATE_FILE)
        (tmp / "meta.json").write_text(
            json.dumps({"step": step, "metrics": metrics or {}}, default=float))
        if target.exists():
            shutil.rmtree(target)
        tmp.rename(target)
        self._prune()
        log.info("Saved checkpoint %s", target)

    def _scan_steps(self):
        steps = []
        for p in self.dir.iterdir():
            # fullmatch: a torn write's .tmp_step_N is no step (the JAX
            # package's search counts it, so its resume misses the real ones)
            m = _STEP_RE.fullmatch(p.name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def _prune(self):
        # runs on the writer thread: must not wait() on itself
        steps = self._scan_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    def all_steps(self):
        self.wait()  # reads must observe an in-flight write
        return self._scan_steps()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target_state, step: Optional[int] = None):
        """Restore into ``target_state`` (a TrainState laid out as the saved
        one), in place; step=None restores the newest. Returns (state, step)."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = self.dir / f"step_{step}" / STATE_FILE
        if not path.is_file():
            raise FileNotFoundError(f"no checkpoint at {path}")
        host = torch.load(path, map_location="cpu", weights_only=True)
        return load_host_state(host, target_state), step


def save_params_npz(params: Dict[str, torch.Tensor], path: Union[str, Path]):
    """The parameters (this package's state-dict names) as the JAX package's
    flat ``params.npz``, in float32."""
    from spatial_clip_tpu_torch.models.convert import to_jax_params

    np.savez(path, **flatten_params(to_jax_params(params)))


def load_params_npz(path: Union[str, Path]) -> Dict[str, Any]:
    """A flat ``params.npz`` as nested JAX-layout params (numpy arrays)."""
    with np.load(path) as data:
        return unflatten_params(dict(data))


def export_torch_state_dict(params: Dict[str, torch.Tensor], path: Union[str, Path]):
    """Write an open_clip-compatible torch checkpoint (float32, on the CPU)."""
    torch.save({k: v.detach().to("cpu", torch.float32).clone() for k, v in params.items()},
               path)
