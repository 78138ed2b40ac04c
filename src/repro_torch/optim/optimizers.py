"""Optimizers as plain functions on tensor trees.

Port of ``repro.optim.optimizers``: ``rmsprop`` is the paper's optimizer
(lr 1e-3), ``adamw`` the LM training path's. Trees are nested dicts of
tensors (the params' own nesting). Both keep float32 state whatever the
parameter dtype, compute the update in float32 and cast the parameter
back, with the JAX package's constants, term for term; they are not
``torch.optim`` classes so that the update is exactly that one.

``adamw`` and ``rmsprop`` write the new params and state into the
tensors they are given and return them, unlike the JAX functions, which
return new arrays: at gemma2-2b's size a fresh copy of the params and the
21 GB of moments would cost an allocation and a write of ~26 GB a step.
The trees passed in are consumed: after the call they hold the updated
values, not the old ones.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.sharding import collectives


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest`` of the same
    structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts in sorted key order (``jax.tree``'s)."""
    if isinstance(tree, dict):
        return [leaf for _, v in sorted(tree.items())
                for leaf in tree_leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# Utilities
# ---------------------------------------------------------------------------

def global_norm(tree, *, owned=None, group=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32. On a mesh
    ``tree`` holds this rank's shards, ``owned`` (a tree of bools like
    it) the leaves this rank counts (a replicated leaf is counted by one
    rank), and the sum is all-reduced over ``group``, one scalar."""
    leaves = tree_leaves(tree)
    if owned is not None:
        leaves = [l for l, o in zip(leaves, tree_leaves(owned)) if o]
    sq = sum(l.float().square().sum() for l in leaves)
    if group is not None:
        sq = collectives.all_reduce(torch.as_tensor(sq).reshape(1),
                                    group)[0]
    return torch.sqrt(sq)


def clip_by_global_norm(grads, max_norm: float, *, owned=None, group=None):
    """Scale the whole gradient tree so its global norm is <= max_norm.
    Returns (clipped tree, the norm before clipping). ``owned`` and
    ``group``: a mesh's shards, see :func:`global_norm`."""
    norm = global_norm(grads, owned=owned, group=group)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


# ---------------------------------------------------------------------------
# RMSprop (paper section IV-A: lr = 1e-3)
# ---------------------------------------------------------------------------

def rmsprop_init(params):
    """Square-average accumulator, float32, same tree as params."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def rmsprop(params, grads, state, *, lr: float = 1e-3, decay: float = 0.99,
            eps: float = 1e-8):
    """One RMSprop step, in place. Returns (params, state)."""

    def upd(p, g, s):
        g32 = g.float()
        s.mul_(decay).add_((1.0 - decay) * g32.square())
        step = lr * g32 / (torch.sqrt(s) + eps)
        p.copy_(p.float() - step)

    with torch.no_grad():
        tree_map(upd, params, grads, state)
    return params, state


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

class AdamWState(NamedTuple):
    mu: Any              # first moment, float32 tree
    nu: Any              # second moment, float32 tree
    count: torch.Tensor  # int32 scalar


def adamw_init(params) -> AdamWState:
    def z(p):
        return torch.zeros_like(p, dtype=torch.float32)
    dev = tree_leaves(params)[0].device
    return AdamWState(mu=tree_map(z, params), nu=tree_map(z, params),
                      count=torch.zeros((), dtype=torch.int32, device=dev))


def adamw(params, grads, state: AdamWState, *, lr: float = 3e-4,
          b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1):
    """One AdamW step, in place. Returns (params, new state)."""
    count = state.count + 1
    c1 = 1.0 - b1 ** count.float()
    c2 = 1.0 - b2 ** count.float()

    def upd(p, g, m, v):
        g32 = g.float()
        m.mul_(b1).add_((1.0 - b1) * g32)
        v.mul_(b2).add_((1.0 - b2) * g32.square())
        step = lr * (m / c1) / (torch.sqrt(v / c2) + eps)
        p32 = p.float()
        p.copy_(p32 - step - lr * weight_decay * p32)

    with torch.no_grad():
        tree_map(upd, params, grads, state.mu, state.nu)
    return params, state._replace(count=count)
