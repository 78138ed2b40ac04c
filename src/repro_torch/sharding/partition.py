"""Logical-axis partitioning: spec trees -> DTensor placements.

Port of ``repro.sharding.partition``. Every initializer names each
parameter's dimensions with *logical* axes (``"embed"``, ``"ffn"``,
``"heads"``, ...); the rules table maps them onto *mesh* axes
(``"pod"``, ``"data"``, ``"model"``, and the MARL mesh's ``"env"`` and
``"agent"``), so one model definition serves any mesh.

A spec resolves to a :class:`P`, the tuple of mesh axes (or ``None``)
per tensor dimension, trailing ``None`` trimmed: ``tuple()`` of it
equals ``tuple()`` of the JAX package's ``PartitionSpec``. A name whose
mesh axis is missing from the mesh is replicated, a mesh axis shards at
most one dimension of a tensor, and :func:`constrained_pspec` also drops
an axis that does not divide its dimension. Where the JAX package builds
a ``NamedSharding`` the port gives the ``DeviceMesh``'s placements, one
``Shard(d)`` or ``Replicate()`` per mesh dimension, for
``distribute_tensor``.

A mesh here is a ``DeviceMesh`` or any object with ``axis_names`` and
``devices.shape`` (the JAX ``Mesh``'s attributes).
"""
from __future__ import annotations

import contextlib
from typing import Any, Mapping, Optional, Sequence

from torch.distributed.tensor import Replicate, Shard

# Logical name -> mesh axis (or tuple of mesh axes, or None = replicate):
# the JAX package's table, FSDP(data) x TP(model) for the weights, the
# batch over every data-parallel axis, the MARL mesh's env and agent axes.
LOGICAL_RULES: dict[str, Any] = {
    # --- weights -----------------------------------------------------------
    "embed": "data",          # d_model dim: FSDP shard
    "ffn": "model",           # FFN hidden dim -- intra-layer parallelism
    "heads": "model",         # attention heads
    "kv_heads": "model",      # GQA KV heads (fewer than heads; may not divide)
    "vocab": "model",         # embedding / unembedding rows
    "expert": None,           # MoE expert axis: inner dims carry the sharding
    "layers": None,           # scan axis: always replicated
    "groups": None,           # FLGW group dim: replicated
    "flgw_cap": "model",      # FLGW compact tiles' capN (output) dim
    # --- activations -------------------------------------------------------
    "batch": ("pod", "data"),  # global batch over all data-parallel axes
    "seq": None,               # sequence: local (no SP by default)
    "seq_sp": "model",         # sequence parallelism opt-in
    "seq_kv": "model",         # decode KV caches: shard the KV sequence dim
    # --- ic3net (tiny, replicated) ------------------------------------------
    "in": None, "out": None, "hidden": None, "gates": None,
    # --- marl mesh (repro_torch.launch.mesh.make_marl_mesh) -----------------
    "env": "env",
    "agent": "agent",
}


class P(tuple):
    """A partition spec: one mesh axis, a tuple of them, or ``None`` per
    tensor dimension, trailing ``None`` trimmed."""

    def __new__(cls, *parts):
        parts = list(parts)
        while parts and parts[-1] is None:
            parts.pop()
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: width}`` of a ``DeviceMesh`` or a JAX-style mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def logical_to_pspec(spec: Sequence[Optional[str]], mesh,
                     rules: Optional[Mapping[str, Any]] = None) -> P:
    """One logical spec tuple -> the :class:`P` valid on ``mesh``."""
    rules = LOGICAL_RULES if rules is None else rules
    axes = axis_sizes(mesh)
    used: set[str] = set()
    out = []
    for name in spec:
        axis = rules.get(name) if name is not None else None
        if axis is None:
            out.append(None)
            continue
        cand = axis if isinstance(axis, tuple) else (axis,)
        keep = tuple(a for a in cand if a in axes and a not in used)
        used.update(keep)
        out.append(None if not keep else keep[0] if len(keep) == 1
                   else keep)
    return P(*out)


def constrained_pspec(spec: Sequence[Optional[str]], shape, mesh,
                      rules: Optional[Mapping[str, Any]] = None) -> P:
    """Shape-aware resolution: a mesh axis that does not divide what is
    left of its dimension is dropped (that dimension replicated)."""
    rules = LOGICAL_RULES if rules is None else rules
    sizes = axis_sizes(mesh)
    used: set[str] = set()
    out = []
    for i, name in enumerate(spec):
        dim = shape[i] if i < len(shape) else 1
        axis = rules.get(name) if name is not None else None
        if axis is None:
            out.append(None)
            continue
        cand = axis if isinstance(axis, tuple) else (axis,)
        keep = []
        for a in cand:
            if a in sizes and a not in used and dim % sizes[a] == 0:
                keep.append(a)
                dim //= sizes[a]
        used.update(keep)
        out.append(None if not keep
                   else keep[0] if len(keep) == 1 else tuple(keep))
    return P(*out)


def placements(pspec: Sequence, mesh) -> tuple:
    """A :class:`P` -> the ``DeviceMesh`` placements: per mesh dimension
    ``Shard(d)`` for the tensor dimension ``d`` it splits, else
    ``Replicate()``."""
    dim_of = {}
    for d, entry in enumerate(pspec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in axis_sizes(mesh))


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def map_specs(fn, specs, *rest):
    """``fn`` over the spec leaves of nested dicts, lists and tuples
    (``rest`` of the same structure)."""
    if _is_spec(specs):
        return fn(specs, *rest)
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, *(r[k] for r in rest))
                for k, v in specs.items()}
    return type(specs)(map_specs(fn, v, *(r[i] for r in rest))
                       for i, v in enumerate(specs))


def shardings_for(specs, mesh, rules: Optional[Mapping[str, Any]] = None):
    """Spec tree -> placements tree (same structure)."""
    return map_specs(
        lambda s: placements(logical_to_pspec(s, mesh, rules), mesh), specs)


def param_shardings(specs, mesh, rules: Optional[Mapping[str, Any]] = None):
    """Alias of :func:`shardings_for`, named for call-site clarity."""
    return shardings_for(specs, mesh, rules)


def constrained_shardings(specs, shaped, mesh,
                          rules: Optional[Mapping[str, Any]] = None):
    """(spec tree, tree of anything with ``.shape``) -> placements tree,
    each from :func:`constrained_pspec`."""
    return map_specs(
        lambda s, a: placements(
            constrained_pspec(s, tuple(a.shape), mesh, rules), mesh),
        specs, shaped)


def batch_pspec(mesh, ndim: int = 2,
                rules: Optional[Mapping[str, Any]] = None) -> P:
    """(batch, seq, ...) activation spec: batch over all data axes."""
    return logical_to_pspec(["batch"] + [None] * (ndim - 1), mesh, rules)


def batch_sharding(mesh, ndim: int = 2,
                   rules: Optional[Mapping[str, Any]] = None) -> tuple:
    """The placements of :func:`batch_pspec`."""
    return placements(batch_pspec(mesh, ndim, rules), mesh)


def activation_rules(mesh) -> dict[str, P]:
    """Rules resolved against ``mesh`` (for introspection and tests)."""
    return {k: logical_to_pspec((k,), mesh) for k in LOGICAL_RULES}


_CONSTRAINT_MESH: list = []


@contextlib.contextmanager
def use_constraints(mesh):
    """Make ``mesh`` the constraint mesh of :func:`constrain` inside the
    block."""
    _CONSTRAINT_MESH.append(mesh)
    try:
        yield
    finally:
        _CONSTRAINT_MESH.pop()


def constrain(x, spec: Sequence[Optional[str]],
              rules: Optional[Mapping[str, Any]] = None):
    """The identity. The JAX package hints GSPMD how one global program's
    activation is laid out; in eager PyTorch each rank's tensors already
    are its shards (``marl.train`` picks them with
    :func:`constrained_pspec`), so there is nothing to constrain.
    ``spec`` and ``rules`` are kept for the reference's call sites."""
    return x
