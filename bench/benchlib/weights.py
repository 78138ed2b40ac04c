"""Parameters and inputs from the seed.

The weights of a cell are drawn on the device in one ``torch.randn``
call for each dtype of the parameter tree, each leaf a view of its
dtype's buffer scaled in place, so the same seed gives the same weights
on the same card and the reference can draw them again after the
program has updated its own in place.
"""
from __future__ import annotations

import math

import torch

WEIGHTS, TRAFFIC = 1, 2      # the generator streams a seed feeds


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of ``seed`` (any whole
    number; the driver's exceed 32 bits)."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 4 + stream) % 2 ** 63)


def flatten(tree, prefix: str = "") -> dict:
    """``{"a.b": leaf}`` of a nested dict, keys in sorted order."""
    out = {}
    for k in sorted(tree):
        v, name = tree[k], f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, name + "."))
        else:
            out[name] = v
    return out


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for name, v in flat.items():
        node = tree
        *head, last = name.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def make(shapes: dict, seed: int, device, scale) -> dict:
    """A tree like ``shapes`` (tensors of any device, read for shape and
    dtype) of weights drawn from ``seed`` on ``device``; ``scale(name,
    shape)`` gives each leaf's standard deviation. Returns the flat dict
    of :func:`flatten`'s names."""
    by_dtype: dict = {}
    for name, t in flatten(shapes).items():
        by_dtype.setdefault(t.dtype, []).append((name, tuple(t.shape)))
    gen = generator(seed, WEIGHTS, device)
    out = {}
    for dtype in sorted(by_dtype, key=str):
        group = by_dtype[dtype]
        sizes = [math.prod(s) for _, s in group]
        flat = torch.randn(sum(sizes), generator=gen, device=device,
                           dtype=dtype)
        for (name, shape), part in zip(group, flat.split(sizes)):
            leaf = part.view(shape)
            s = scale(name, shape)
            if s != 1.0:
                leaf.mul_(s)
            out[name] = leaf
    return out
