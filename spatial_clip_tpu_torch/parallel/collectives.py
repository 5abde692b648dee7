"""The collectives the distributed losses and the trainer differentiate
through, over a ``torch.distributed`` process group.

The gradient convention is data parallelism's: each rank backpropagates its
own local loss, and the ranks average their parameter gradients afterwards
(``Trainer``). So a collective's backward hands each rank the gradient its
inputs take over every rank's loss, summed: :func:`all_gather` gathers the
rows forward and all-reduces (sums) the gathered gradient backward, taking
this rank's rows; :func:`shift` passes a block around the ring and its
gradient back the other way; :func:`mean_over_ranks` gives the ranks' mean
as the value and passes the gradient to this rank's local term unchanged.
Averaging the parameter gradients then gives the one-process gradient of
the global loss.

``group=None`` means no group (one process): every function returns its
input. For the default group pass ``dist.group.WORLD``. A group of one runs
the collectives all the same (they return the same bits), except
:func:`shift`, which has nothing to exchange.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


def rank_size(group: Group) -> Tuple[int, int]:
    """(this process's rank, the group's size); (0, 1) without a group."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _gather_list(x: torch.Tensor, group, size: int) -> List[torch.Tensor]:
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return parts


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.group, ctx.rank, ctx.rows = group, rank, x.shape[0]
        return torch.cat(_gather_list(x.contiguous(), group, size))

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        lo = ctx.rank * ctx.rows
        return grad[lo:lo + ctx.rows], None, None, None


def all_gather(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Every rank's ``x`` (the same number of rows on each), concatenated in
    rank order along dim 0; gradients flow back to each rank's rows, summed
    over the ranks' losses. Under no grad it is a plain all-gather."""
    if group is None:
        return x
    rank, size = rank_size(group)
    if not (torch.is_grad_enabled() and x.requires_grad):
        return torch.cat(_gather_list(x.contiguous(), group, size))
    return _AllGather.apply(x, group, rank, size)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of every rank's ``x``; its gradient is the sum of the ranks'
    gradients of it."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


class _MeanOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size):
        out = x.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out / size

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def mean_over_ranks(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Value: the mean of ``x`` over the ranks (the same bits on each).
    Gradient: passed to this rank's ``x`` unchanged, since the ranks average
    their gradients afterwards."""
    if group is None:
        return x
    return _MeanOverRanks.apply(x, group, rank_size(group)[1])


def _exchange(x: torch.Tensor, group, to: int, frm: int) -> torch.Tensor:
    if x.is_cuda and dist.get_backend(group) == "gloo":
        raise ValueError("gloo runs point-to-point ops on CPU tensors only: the ring losses "
                         "on CUDA tensors take an nccl group")
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, to), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, frm), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, size, step):
        ctx.group, ctx.rank, ctx.size, ctx.step = group, rank, size, step
        return _exchange(x.contiguous(), group, (rank + step) % size, (rank - step) % size)

    @staticmethod
    def backward(ctx, grad):
        r, n, s = ctx.rank, ctx.size, ctx.step
        grad = _exchange(grad.contiguous(), ctx.group, (r - s) % n, (r + s) % n)
        return grad, None, None, None, None


def shift(x: torch.Tensor, group: Group, step: int = 1) -> torch.Tensor:
    """JAX's ``ppermute`` by ``step`` around the ring: rank r sends ``x`` to
    rank r + step and returns what rank r - step sent; the gradient goes
    back the other way."""
    rank, size = rank_size(group)
    if size == 1:
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        return _exchange(x.contiguous(), group, (rank + step) % size, (rank - step) % size)
    return _Shift.apply(x, group, rank, size, step)
