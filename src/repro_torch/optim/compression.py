"""Top-k gradient compression with error feedback for the DP all-reduce.

Port of ``repro.optim.compression``. ``compressed_allreduce`` sends only
the top-k magnitude entries of each gradient leaf (``k = ratio * size``)
and keeps the rest locally as a residual that the next call adds back
(error feedback, Karimireddy et al. '19). With FLGW on, (1 - 1/G) of a
weight gradient is exactly zero, so ``ratio`` ~ 1/G mostly sends the
entries the grouping keeps.

Each process sends the dense scatter of its selection (the union of the
processes' supports is what the sum sees) and the sent scatters are
averaged, the JAX package's ``pmean``. As in the JAX package, no
training loop calls it.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.optim.optimizers import tree_map
from repro_torch.sharding import collectives


class CompressionState(NamedTuple):
    error: Any      # residual tree (error feedback memory), f32


def compression_init(params) -> CompressionState:
    return CompressionState(error=tree_map(
        lambda p: torch.zeros_like(p, dtype=torch.float32), params))


def topk_compress(g: torch.Tensor, ratio: float):
    """The top-k |values| of a flat leaf: (values, int32 indices, k), with
    the static ``k = max(1, int(ratio * size))``."""
    flat = g.reshape(-1).float()
    k = max(1, int(ratio * flat.shape[0]))
    idx = torch.topk(flat.abs(), k).indices
    return flat[idx], idx.to(torch.int32), k


def topk_decompress(values: torch.Tensor, indices: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    size = 1
    for s in shape:
        size *= s
    out = torch.zeros((size,), dtype=dtype, device=values.device)
    out[indices.long()] = values.to(dtype)
    return out.reshape(shape)


def compressed_allreduce(grads, state: CompressionState, group, *,
                         ratio: float = 0.1):
    """Error-feedback top-k all-reduce over ``group`` (a ``ProcessGroup``;
    ``None`` for one process).

    Each process adds its residual, takes its local top-k and sends the
    dense scatter of it; the scatters are averaged over the group. The
    residual keeps what was not sent. Returns (reduced grads, new state).
    """
    n = collectives.size(group)

    def one(g, e):
        g32 = g.float() + e
        vals, idx, _ = topk_compress(g32, ratio)
        s = topk_decompress(vals, idx, g.shape)
        return s, g32 - s

    pairs = tree_map(one, grads, state.error)
    sent = tree_map(lambda g, p: p[0], grads, pairs)
    error = tree_map(lambda g, p: p[1], grads, pairs)
    leaves = _leaves(sent)
    summed = collectives.all_reduce_flat(leaves, group)
    by_id = {id(s): r for s, r in zip(leaves, summed)}
    reduced = tree_map(lambda g, s: (by_id[id(s)] / n).to(g.dtype),
                       grads, sent)
    return reduced, CompressionState(error=error)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]
