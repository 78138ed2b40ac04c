"""The collectives of the port's mesh paths, on ``torch.distributed``.

Each helper runs one collective over ``group``, a ``ProcessGroup``
(``dist.group.WORLD`` for the whole mesh), and counts it in
:data:`CALLS` by operation and backend. A ``group`` of ``None`` stands
for an axis that is not split, and then the helper is the identity; so
is every helper without a process group (a one-rank mesh in one
process).

The tensors stay on their device. Several ranks on one card run on gloo
(NCCL refuses two ranks on one device), and gloo takes CUDA tensors for
both collectives used here: torch 2.11's gloo ran all_reduce,
all_gather, broadcast, reduce, reduce_scatter_tensor and
all_to_all_single on an H100's tensors (``chip_smoke.py`` phase 16), so
nothing is staged through host memory.
"""
from __future__ import annotations

import collections
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# (operation, backend) -> calls
CALLS: collections.Counter = collections.Counter()


def active(group) -> bool:
    """True when a collective over ``group`` combines anything."""
    return group is not None and dist.is_initialized()


def size(group) -> int:
    """The ranks of ``group`` (1 when it is not active)."""
    return dist.get_world_size(group) if active(group) else 1


def all_reduce(tensor: torch.Tensor, group) -> torch.Tensor:
    """Sum ``tensor`` over ``group`` in place; returns it."""
    if not active(group):
        return tensor
    CALLS[("all_reduce", dist.get_backend(group))] += 1
    dist.all_reduce(tensor, group=group)
    return tensor


def all_reduce_flat(tensors: Sequence[torch.Tensor], group
                    ) -> list[torch.Tensor]:
    """Sum same-dtype tensors over ``group`` in one collective (one flat
    buffer); returns new tensors of their shapes, or the inputs
    themselves when ``group`` is not active."""
    if not active(group):
        return list(tensors)
    flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors]), group)
    return [part.view_as(t) for part, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def all_gather(tensor: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Concatenate every rank's ``tensor`` along ``dim``, in rank order
    within ``group``."""
    if not active(group):
        return tensor
    CALLS[("all_gather", dist.get_backend(group))] += 1
    src = tensor.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim)


class _AllReduceSum(torch.autograd.Function):
    """y = sum over the group's ranks of x, on every rank. Every rank's
    loss reads y, so dL/dx is the sum over the ranks of dL_r/dy: the
    backward is the same all-reduce."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group``; ``x`` itself when
    ``group`` is not active."""
    if not active(group):
        return x
    return _AllReduceSum.apply(x, group)
