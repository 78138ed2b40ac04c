"""The collectives of the port's mesh paths, on ``torch.distributed``.

Each helper runs one collective over ``group``, a ``ProcessGroup``
(``dist.group.WORLD`` for the whole mesh), and counts it in
:data:`CALLS` by operation and backend, its bytes in :data:`BYTES` (the
whole tensor: what an all-reduce sums, what an all-gather or gather
builds, what a reduce-scatter reduces) and the bytes a rank sends over
its links in a ring in :data:`LINK_BYTES` ((n - 1) / n of the whole
tensor, twice for an all-reduce). The dry run
(``repro_torch.launch.dryrun``) reads the same counters. A ``group`` of
``None`` stands for an axis that is not split, and then the helper is the
identity; so is every helper without a process group (a one-rank mesh in
one process).

The tensors stay on their device. Several ranks on one card run on gloo
(NCCL refuses two ranks on one device), and gloo takes CUDA tensors for
every collective used here: torch 2.11's gloo ran all_reduce,
all_gather, broadcast, reduce, reduce_scatter_tensor and
all_to_all_single on an H100's tensors (``chip_smoke.py`` phase 16), so
nothing is staged through host memory by the port.

Serving on that mesh (``repro_torch.serving.steps``) gathers the weights
the same way, without a backward, and splits work over ``model`` with
:func:`shard` and :func:`all_gather`: the compact products' output
columns, a decode cache's sequence slots (each rank's partial
attention all-gathered and combined by log-sum-exp), an SSM state's
heads and conv channels; :func:`unshard` puts the parts back together.

The LM on a ``(data, model)`` mesh (``repro_torch.train.step``) keeps
each weight as its shards and computes with it whole: :func:`gather_shards`
all-gathers a leaf in the forward and reduce-scatters its float32
gradient back onto the leaf's placements in the backward (the FSDP pair),
and :func:`batch_mean` takes a mean over the batch rows of every rank.
Where its ``model`` ranks share their rows, each compact product splits
its output columns over them as serving does, and its backward sums the
partial input gradient over them with one float32 :func:`all_reduce_flat`.
"""
from __future__ import annotations

import collections
import contextlib
import warnings
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# (operation, backend) -> calls, whole bytes, ring link bytes a rank
CALLS: collections.Counter = collections.Counter()
BYTES: collections.Counter = collections.Counter()
LINK_BYTES: collections.Counter = collections.Counter()


def clear() -> None:
    """Set every counter to 0."""
    CALLS.clear()
    BYTES.clear()
    LINK_BYTES.clear()


def _count(op: str, group, whole: torch.Tensor, n: int) -> None:
    key = (op, dist.get_backend(group))
    nbytes = whole.numel() * whole.element_size() * (
        n if op in ("all_gather", "gather") else 1)
    CALLS[key] += 1
    BYTES[key] += nbytes
    LINK_BYTES[key] += nbytes * (n - 1) / n * (2 if op == "all_reduce"
                                               else 1)


def active(group) -> bool:
    """True when a collective over ``group`` combines anything."""
    return group is not None and dist.is_initialized()


def size(group) -> int:
    """The ranks of ``group`` (1 when it is not active)."""
    return dist.get_world_size(group) if active(group) else 1


def rank(group) -> int:
    """This rank's index within ``group`` (0 when it is not active)."""
    return dist.get_rank(group) if active(group) else 0


def shard(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim`` among ``group``'s equal
    chunks, in rank order (a view; ``x`` itself when ``group`` is not
    active). :func:`all_gather` along ``dim`` is its inverse."""
    n = size(group)
    return x if n == 1 else x.chunk(n, dim)[rank(group)]


def unshard(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The inverse of :func:`shard`: every rank's chunk concatenated
    along ``dim`` (:func:`all_gather`); ``x`` itself on a group of one
    rank or none, with no collective."""
    return x if size(group) == 1 else all_gather(x, group, dim)


def all_reduce(tensor: torch.Tensor, group) -> torch.Tensor:
    """Sum ``tensor`` over ``group`` in place; returns it."""
    if not active(group):
        return tensor
    _count("all_reduce", group, tensor, dist.get_world_size(group))
    if tensor.is_contiguous():
        dist.all_reduce(tensor, group=group)
    else:                       # NCCL and gloo's CUDA path take dense ones
        buf = tensor.contiguous()
        dist.all_reduce(buf, group=group)
        tensor.copy_(buf)
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
    src = tensor.contiguous()
    _count("all_gather", group, src, dist.get_world_size(group))
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


def reduce_scatter(tensor: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Sum ``tensor`` over ``group`` and keep this rank's chunk of the sum
    along ``dim`` (equal chunks in rank order)."""
    if not active(group):
        return tensor
    n = dist.get_world_size(group)
    if tensor.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(tensor.shape)}"
                         f" does not divide over {n} ranks")
    _count("reduce_scatter", group, tensor, n)
    src = tensor.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    with warnings.catch_warnings():     # renamed reduce_scatter_single later
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


def gather_to_first(tensor: torch.Tensor, group, dim: int):
    """Concatenate every rank's ``tensor`` along ``dim``, in rank order, on
    the group's first rank; ``None`` on the others (whose part only
    leaves them)."""
    if not active(group):
        return tensor
    src = tensor.contiguous()
    _count("gather", group, src, dist.get_world_size(group))
    first = dist.get_rank(group) == 0
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(
        group))] if first else None
    dist.gather(src, parts, dst=dist.get_global_rank(group, 0), group=group)
    return torch.cat(parts, dim) if first else None


def gather_whole(local: torch.Tensor, layout) -> torch.Tensor:
    """The whole tensor from this rank's shard. ``layout``: one ``(group,
    dim)`` a mesh dimension, outermost first, ``dim`` the tensor dimension
    that mesh dimension splits or None; the innermost split is gathered
    first."""
    t = local
    for group, d in reversed(layout):
        if d is not None:
            t = all_gather(t, group, d)
    return t


def reduce_to_shard(grad: torch.Tensor, layout) -> torch.Tensor:
    """``grad`` summed over every rank of the mesh, this rank keeping its
    shard (``layout`` as :func:`gather_whole`'s): reduce-scattered over
    the mesh dimensions that split the tensor, those that split its dim 0
    first (no transposed copy), then all-reduced over the others, on the
    smallest tensor left. Mesh dimensions that split one tensor dimension
    keep their order, outermost first."""
    order = sorted(layout, key=lambda gd: (gd[1] is None, gd[1] != 0))
    for group, d in order:
        grad = all_reduce(grad, group) if d is None else \
            reduce_scatter(grad, group, d)
    return grad


class _GatherShards(torch.autograd.Function):
    """Forward: the whole weight from its shards (:func:`gather_whole`).
    Backward: the whole weight's gradient, in float32, summed over every
    rank of the mesh onto this rank's shard (:func:`reduce_to_shard`),
    times ``scale``, cast back to the gradient's dtype."""

    @staticmethod
    def forward(ctx, local, layout, scale):
        ctx.layout, ctx.scale = layout, scale
        return gather_whole(local, layout)

    @staticmethod
    def backward(ctx, grad):
        g = reduce_to_shard(grad.float(), ctx.layout)
        return (g * ctx.scale).to(grad.dtype), None, None


def gather_shards(local: torch.Tensor, layout, scale: float = 1.0
                  ) -> torch.Tensor:
    """Differentiable :func:`gather_whole` (see :class:`_GatherShards`).
    ``scale`` weighs the summed gradient (1 / the ranks of the mesh, whose
    losses are each a mean over their own rows)."""
    return _GatherShards.apply(local, layout, scale)


# The groups the batch rows are split over while a mesh step runs its
# forward (see ``rows_over``); empty outside one.
_ROW_GROUPS: list = []


@contextlib.contextmanager
def rows_over(groups: Sequence):
    """Within the block, :func:`batch_mean` averages over the rows of
    every rank of ``groups`` (the mesh dimensions whose ranks hold
    distinct rows of the global batch, outermost first, as
    ``partition.batch_rows`` splits the rows over them)."""
    _ROW_GROUPS.append(tuple(g for g in groups if g is not None))
    try:
        yield
    finally:
        _ROW_GROUPS.pop()


def holds_distinct_rows(group) -> bool:
    """True when ``group`` is one of :func:`rows_over`'s groups: its ranks
    hold distinct rows of the running step's batch."""
    return any(g is group for g in (_ROW_GROUPS[-1] if _ROW_GROUPS
                                    else ()))


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean of ``x`` over dim 0, its rows, and over the rows of the other
    ranks of :func:`rows_over`'s groups (differentiable: the sums go
    through :func:`all_reduce_sum`); ``x.mean(0)`` outside a mesh step."""
    groups = _ROW_GROUPS[-1] if _ROW_GROUPS else ()
    if all(size(g) == 1 for g in groups):
        return x.mean(0)
    total, n = x.sum(0), x.shape[0]
    for g in groups:
        total = all_reduce_sum(total, g)
        n *= size(g)
    return total / n


def row_block() -> tuple[int, int]:
    """``(index, count)``: this rank's block of rows among the distinct
    blocks of the global batch within :func:`rows_over`'s groups, in the
    batch's order; ``(0, 1)`` outside a mesh step."""
    index, count = 0, 1
    for g in (_ROW_GROUPS[-1] if _ROW_GROUPS else ()):
        n = size(g)
        index = index * n + (dist.get_rank(g) if n > 1 else 0)
        count *= n
    return index, count


def rows_before(counts: torch.Tensor) -> torch.Tensor:
    """``counts`` of this rank's rows summed over the row blocks that come
    before its own in the global batch (:func:`row_block`): each rank
    writes its counts into a table of every block's, summed over each
    group of :func:`rows_over`. Zeros outside a mesh step."""
    index, count = row_block()
    if count == 1:
        return torch.zeros_like(counts)
    table = counts.new_zeros((count, *counts.shape))
    table[index] = counts
    for g in _ROW_GROUPS[-1]:
        all_reduce(table, g)
    return table[:index].sum(0)
