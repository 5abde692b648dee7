"""The device mesh as a ``torch.distributed`` process group (counterpart of
``spatial_clip_tpu.parallel.mesh``).

JAX builds a ``Mesh`` over the devices of one controller and lets XLA place
the collectives. Here each device has a process of its own, and the
``data`` axis of the mesh is the process group: :func:`make_mesh` returns a
:class:`Mesh` naming the group, this process's rank, the group's size and
the device this process drives, so that ``Trainer(mesh=make_mesh(...))``
reads as it does in JAX. Only the data axis is ported: a ``model`` axis
(dp x tp) and the hybrid DCN mesh raise NotImplementedError (ROADMAP Queue
1 item 7).

The backend is always the caller's choice, ``nccl`` for CUDA tensors and
``gloo`` for CPU tensors; nothing here picks or changes it. Gloo also takes
``all_gather``, ``all_reduce`` and ``broadcast`` on CUDA tensors, staged
through the host, which is how two processes share one card (NCCL refuses
two ranks on one device); its point-to-point ops take CPU tensors only.
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from spatial_clip_tpu_torch.parallel.collectives import rank_size

DATA_AXIS = "data"
BACKENDS = ("nccl", "gloo")
TIMEOUT = datetime.timedelta(minutes=10)


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to spatial_clip_tpu_torch "
                               "(ROADMAP Queue 1 item 7)")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}; got {backend!r}")


def _card(device) -> torch.device:
    """``device`` with the current card's index when it names ``cuda``
    without one, so that it compares equal to a tensor's device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def init_distributed(backend: str, rank: int, world_size: int,
                     store_path: Optional[str] = None,
                     device: Optional[torch.device] = None) -> None:
    """Join a process group of ``world_size`` as ``rank``: rendezvous through
    a ``FileStore`` at ``store_path`` (every rank names the same file), or
    without one through torchrun's environment (``env://``). ``device``,
    for ``nccl``, is the card this process drives."""
    _check_backend(backend)
    kwargs: Dict[str, Any] = {"rank": rank, "world_size": world_size, "timeout": TIMEOUT}
    if store_path is not None:
        kwargs["store"] = dist.FileStore(store_path, world_size)
    else:
        kwargs["init_method"] = "env://"
    if backend == "nccl":
        device = _card(device if device is not None else "cuda")
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(backend, **kwargs)


def maybe_init_distributed(backend: str) -> bool:
    """Join the process group that torchrun describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``) when its world has more than one process; a single
    process does nothing. Returns whether a group is up."""
    _check_backend(backend)
    if dist.is_initialized():
        return True
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    init_distributed(backend, rank, world,
                     device=torch.device("cuda", local) if backend == "nccl" else None)
    return True


@dataclass(frozen=True)
class Mesh:
    """A one-axis (``data``) mesh: the process group (None for one process
    with no group), this process's rank in it, its size and this process's
    device."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.size}


def make_mesh(axes: Sequence[str] = (DATA_AXIS,), axis_sizes: Optional[Sequence[int]] = None,
              device=None) -> Mesh:
    """The data mesh over the default process group (without one, a mesh of
    this process alone). ``device`` defaults to ``cuda:{LOCAL_RANK}``
    (``'cuda'`` alone means the current card); pass ``'cpu'`` for a CPU
    run. Any axis besides ``data`` with a size above 1 raises
    NotImplementedError."""
    sizes = list(axis_sizes) if axis_sizes is not None else [None] + [1] * (len(axes) - 1)
    for axis, size in zip(axes, sizes):
        if axis != DATA_AXIS and (size is None or size > 1):
            raise _unported(f"a {axis!r} mesh axis (dp x tp, the hybrid DCN mesh)")
    group = dist.group.WORLD if dist.is_initialized() else None
    rank, size = (dist.get_rank(group), dist.get_world_size(group)) if group is not None else (0, 1)
    want = sizes[list(axes).index(DATA_AXIS)] if DATA_AXIS in axes else None
    if want is not None and want != size:
        raise ValueError(f"a data axis of {want} over a process group of {size}")
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return Mesh(group, rank, size, _card(device))


def local_batch_size(global_batch_size: int, mesh: Mesh, axis: str = DATA_AXIS) -> int:
    n = mesh.shape[axis]
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by {axis} axis size {n}")
    return global_batch_size // n


def _default(group: Optional[dist.ProcessGroup]) -> Optional[dist.ProcessGroup]:
    """``group``, or the default group where none is named and one is up."""
    if group is None and dist.is_initialized():
        return dist.group.WORLD
    return group


def process_shard_indices(n: int, group: Optional[dist.ProcessGroup] = None) -> Tuple[int, int]:
    """The contiguous ``[start, stop)`` range of ``n`` dataset indices this
    process owns; the last rank takes the remainder."""
    rank, size = rank_size(_default(group))
    per = n // size
    start = rank * per
    return start, (start + per if rank < size - 1 else n)


def broadcast_object(obj: Any = None, src: int = 0,
                     group: Optional[dist.ProcessGroup] = None) -> Any:
    """Every process returns the ``src`` rank's object (pickled: send only
    what this program made)."""
    if rank_size(_default(group))[1] == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def all_gather_object(obj: Any, group: Optional[dist.ProcessGroup] = None) -> list:
    """Every process's object, in rank order."""
    size = rank_size(_default(group))[1]
    if size == 1:
        return [obj]
    out = [None] * size
    dist.all_gather_object(out, obj, group=group)
    return out
