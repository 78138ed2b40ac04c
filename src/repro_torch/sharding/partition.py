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

A state on a mesh (the LM's weights, moments and plans) holds one
``DTensor`` a leaf, each rank only its shards: :func:`distribute` cuts
every rank's shards out of the same global tree, :func:`gather` puts
the whole tensors back together with the counted collectives of
``repro_torch.sharding.collectives``, and :func:`layout` tells a
mesh step which collectives build each leaf whole.
"""
from __future__ import annotations

import contextlib
from typing import Any, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.sharding import collectives

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
    """``fn`` over the spec leaves of nested dicts, lists, tuples and
    NamedTuples (``rest`` of the same structure); ``None`` stays."""
    if specs is None:
        return None
    if _is_spec(specs):
        return fn(specs, *rest)
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, *(r[k] for r in rest))
                for k, v in specs.items()}
    parts = [map_specs(fn, v, *(r[i] for r in rest))
             for i, v in enumerate(specs)]
    return type(specs)(*parts) if hasattr(specs, "_fields") \
        else type(specs)(parts)


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
    each from :func:`constrained_pspec`. An empty spec whose counterpart
    holds no tensor (the plans of a state off the grouped path) stays
    empty."""
    def one(s, a):
        if not hasattr(a, "shape"):
            return a
        return placements(constrained_pspec(s, tuple(a.shape), mesh, rules),
                          mesh)
    return map_specs(one, specs, shaped)


# ---------------------------------------------------------------------------
# State trees on a mesh
# ---------------------------------------------------------------------------

def map_tree(fn, tree, *rest):
    """``fn`` over the tensor leaves of nested dicts, lists, tuples and
    NamedTuples, ``rest`` indexed alongside (so a placements tree's
    tuples reach ``fn`` whole); ``None`` and other leaves stay."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        parts = [map_tree(fn, v, *(r[i] for r in rest))
                 for i, v in enumerate(tree)]
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else type(tree)(parts)
    return tree


def leaves(tree) -> list:
    """The tensor leaves of a state tree, in :func:`map_tree`'s order."""
    out = []
    map_tree(out.append, tree)
    return out


def mesh_groups(mesh) -> tuple:
    """The process group of each mesh dimension (``None`` each without a
    process group: a one-process mesh, whose collectives are the
    identity)."""
    names = mesh.mesh_dim_names
    if not dist.is_initialized():
        return (None,) * len(names)
    return tuple(mesh.get_group(n) for n in names)


def mesh_coords(mesh) -> tuple:
    """This rank's coordinate along each mesh dimension."""
    c = mesh.get_coordinate()
    if c is None:
        raise ValueError("this rank is not in the mesh")
    return tuple(c)


def shard_of(full: torch.Tensor, placement, mesh) -> torch.Tensor:
    """This rank's shard of ``full`` under ``placement`` (a view): mesh
    dimension by mesh dimension, outermost first, the chunk of the
    dimension it splits."""
    t = full
    for n, c, p in zip(tuple(mesh.shape), mesh_coords(mesh), placement):
        if isinstance(p, Shard):
            if t.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(full.shape)} does "
                                 f"not divide over {n} ranks")
            t = t.chunk(n, p.dim)[c]
    return t


def distribute(tree, shardings, mesh):
    """``tree`` (every rank's copy of the same global values) -> DTensors
    of ``shardings``' placements on ``mesh``, each holding a copy of this
    rank's shard only (no collective)."""
    def one(x, placement):
        if placement is None:
            placement = (Replicate(),) * len(tuple(mesh.shape))
        local = shard_of(x.detach(), placement, mesh).clone()
        return DTensor.from_local(local, mesh, list(placement),
                                  run_check=False, shape=x.shape,
                                  stride=x.contiguous().stride())
    return map_tree(one, tree, shardings)


def from_local(tree, shardings, mesh):
    """Local shards (this rank's, already cut) -> DTensors of
    ``shardings``' placements on ``mesh`` (even shards: the whole shape
    follows from the local one)."""
    return map_tree(lambda x, p: DTensor.from_local(
        x, mesh, list(p), run_check=False), tree, shardings)


def replicate(tree, mesh):
    """``tree`` as DTensors replicated over ``mesh``."""
    rep = (Replicate(),) * len(tuple(mesh.shape))
    return map_tree(lambda x: DTensor.from_local(x, mesh, list(rep),
                                                 run_check=False), tree)


def mesh_of(tree):
    """The mesh of the first DTensor of ``tree`` (None without one)."""
    for x in leaves(tree):
        if isinstance(x, DTensor):
            return x.device_mesh
    return None


def shardings_of(tree):
    """The placements of every DTensor leaf (other leaves: None)."""
    return map_tree(lambda x: tuple(x.placements)
                    if isinstance(x, DTensor) else None, tree)


def layout(x: DTensor, lead: int = 0) -> tuple:
    """``((group, dim), ...)``, one a mesh dimension: the tensor dimension
    it splits (less ``lead``, for a slice that drops leading dims) or
    None. What ``collectives.gather_whole`` takes."""
    return tuple((g, p.dim - lead if isinstance(p, Shard) else None)
                 for g, p in zip(mesh_groups(x.device_mesh), x.placements))


def local(tree):
    """Each DTensor leaf's local shard (a view that shares its storage:
    writes to it write the DTensor); other leaves as they are."""
    return map_tree(lambda x: x.to_local() if isinstance(x, DTensor) else x,
                    tree)


def gather(tree):
    """Each DTensor leaf whole on every rank, built from the shards with
    the counted collectives (every rank of the mesh must call it); other
    leaves as they are."""
    def one(x):
        if not isinstance(x, DTensor):
            return x
        with torch.no_grad():
            return collectives.gather_whole(x.to_local(), layout(x))
    return map_tree(one, tree)


def gather_to_first(x: DTensor):
    """One DTensor leaf whole on the mesh's first rank (coordinate 0 on
    every dimension), on the host; ``None`` on every other rank. The
    innermost split is gathered first, onto the ranks at coordinate 0 of
    its dimension, which then gather the next (every rank of the mesh must
    call it). Less traffic than :func:`gather`, where every rank receives
    the whole; a checkpoint save needs it on one rank."""
    lay = layout(x)
    part = x.to_local()
    if all(g is None or dist.get_backend(g) == "gloo" for g, _ in lay):
        part = part.cpu()              # gloo gathers host tensors directly
    with torch.no_grad():
        for group, d in reversed(lay):
            if d is not None and part is not None:
                part = collectives.gather_to_first(part, group, d)
    if part is None or any(c for c in mesh_coords(x.device_mesh)):
        return None
    return part.cpu()


def gather_grouping(params, weights: bool = False) -> dict:
    """The FLGW grouping matrices of a (sharded) param tree, whole: a tree
    of the params' nesting holding only each FLGW layer's ``ig`` and
    ``og``, which is what a plan encode reads. ``weights=True`` also
    keeps each layer's ``w`` as it is (a shard: the compact-weight
    attach gathers one layer's at a time, ``core.grouped.attach_compact``)."""
    out = {}
    for name, p in params.items():
        if not isinstance(p, dict):
            continue
        if "ig" in p:
            out[name] = gather({"ig": p["ig"], "og": p["og"]})
            if weights:
                out[name]["w"] = p["w"]
        else:
            sub = gather_grouping(p, weights)
            if sub:
                out[name] = sub
    return out


def whole(x):
    """``x`` whole on every rank: a DTensor gathered (:func:`gather`),
    anything else as it is."""
    return gather(x) if isinstance(x, DTensor) else x


def gatherer(params, scale: float = 1.0):
    """The ``gather(tree, path, lead=0)`` hook of ``transformer.lm_apply``
    for a tree of DTensors: the subtree of ``params`` at ``path``, given
    as this rank's local shards (``lead`` leading dims sliced off), built
    whole by each leaf's placements through
    ``collectives.gather_shards``, whose backward reduce-scatters each
    gradient onto the shards times ``scale`` (a training step's 1 / the
    mesh's ranks; a serving step records no gradient)."""
    def gather_hook(tree, path, lead=0):
        node = params
        for k in path:
            node = node[k]
        return map_tree(lambda x, d: collectives.gather_shards(
            x, layout(d, lead), scale), tree, node)
    return gather_hook


def split_group(x: DTensor, dim: int):
    """The process group of the one mesh dimension that shards tensor
    dimension ``dim`` of ``x`` (None when none does, or ``x`` is not a
    DTensor). Two mesh dimensions on one tensor dimension raise: the
    decode paths that read it split a dimension over one group."""
    if not isinstance(x, DTensor):
        return None
    groups = [g for g, d in layout(x) if d == dim]
    if len(groups) > 1:
        raise ValueError(f"dim {dim} of a {tuple(x.shape)} leaf is split "
                         f"over {len(groups)} mesh dimensions; one expected")
    return groups[0] if groups else None


def zeros(shape, dtype, placement, mesh, device) -> DTensor:
    """A DTensor of zeros of the global ``shape`` on ``mesh``, each rank
    allocating only its shard under ``placement`` (even shards)."""
    local = list(shape)
    for n, p in zip(tuple(mesh.shape), placement):
        if isinstance(p, Shard):
            if local[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"divide over {n} ranks")
            local[p.dim] //= n
    return DTensor.from_local(
        torch.zeros(local, dtype=dtype, device=device), mesh,
        list(placement), run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def state_bytes(tree) -> tuple[int, int]:
    """(bytes of this rank's shards, bytes of the whole tensors) of a
    state tree; a replicated leaf counts whole in both."""
    local = whole = 0
    for x in leaves(tree):
        n = x.element_size()
        whole += x.numel() * n
        local += (x.to_local().numel() if isinstance(x, DTensor)
                  else x.numel()) * n
    return local, whole


def batch_rows(mesh, batch: int, rules: Optional[Mapping[str, Any]] = None,
               *, spread: bool = True) -> tuple[int, int, tuple]:
    """This rank's rows ``[lo, hi)`` of a global batch of ``batch`` rows,
    and the names of the mesh dimensions whose ranks hold distinct rows.

    The rows split over the batch's mesh axes (:func:`batch_pspec`, the
    reference's ``batch_sharding``; they must divide the batch), then
    again over each other mesh dimension that divides what is left, so
    that no rank repeats another's rows; a dimension that does not
    divide leaves its ranks the same rows.

    ``spread=False`` (a serving step's rows) splits over the batch's own
    axes only, as :func:`constrained_pspec` lays out a ``"batch"``
    dimension: an axis that does not divide what is left is dropped,
    its ranks holding the same rows (``long_500k``'s batch of 1), and
    the ranks of every other axis hold the same rows (a decode cache
    splits its sequence over ``model``, whose ranks then score the same
    rows' slices)."""
    sizes = axis_sizes(mesh)
    coords = dict(zip(sizes, mesh_coords(mesh)))
    data = batch_pspec(mesh, 1, rules)
    data_axes = [a for e in data for a in (e if isinstance(e, tuple)
                                             else (e,)) if a is not None]
    others = [a for a in sizes if a not in data_axes] if spread else []
    lo, rows, split = 0, batch, []
    for a in data_axes + others:
        if rows % sizes[a]:
            if a in data_axes and spread:
                raise ValueError(f"global batch {batch} does not divide "
                                 f"over the {a!r} axis ({sizes[a]})")
            continue
        rows //= sizes[a]
        lo += coords[a] * rows
        split.append(a)
    return lo, lo + rows, tuple(split)


def step_rows(mesh, batch: int, microbatches: int = 1,
              rules: Optional[Mapping[str, Any]] = None
              ) -> tuple[list[int], tuple]:
    """This rank's rows of a global batch of ``batch`` rows for a step in
    ``microbatches`` microbatches, and the names of the mesh dimensions
    whose ranks hold distinct rows. Global microbatch i is rows ``[i·m,
    (i+1)·m)``, ``m = batch // microbatches``, as the reference slices
    it; the rank holds :func:`batch_rows` of ``m`` of each, in
    microbatch order, so that chunk i of its rows is its share of global
    microbatch i (an MoE layer's capacity then counts over the global
    microbatch). One microbatch: ``range(*batch_rows(mesh, batch))``."""
    if batch % microbatches:
        raise ValueError(f"global batch {batch} does not split into "
                         f"{microbatches} microbatches")
    per = batch // microbatches
    lo, hi, split = batch_rows(mesh, per, rules)
    return [i * per + r for i in range(microbatches)
            for r in range(lo, hi)], split


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
    ``spec`` and ``rules`` are kept for the reference's call sites.
    Where a constraint splits work, the port splits it explicitly: the
    compact product's ``"flgw_cap"`` columns (:func:`constraint_group`)."""
    return x


def constraint_group(name: str, size: int,
                     rules: Optional[Mapping[str, Any]] = None):
    """The process group that splits a dimension of ``size`` named
    ``name`` on the constraint mesh (:func:`use_constraints`): that of the
    mesh axis the rules map ``name`` to, when the mesh has it wider than
    1, it divides ``size`` and its ranks hold the same rows. None
    otherwise: outside :func:`use_constraints`, without a process group,
    where the axis does not divide, which :func:`constrained_pspec` would
    drop (the dimension stays whole on every rank), and where the
    running mesh train step spreads its rows over the axis
    (``collectives.rows_over``): splitting columns among ranks of
    distinct rows and all-gathering them would mix the rows. The compact
    product splits its ``"flgw_cap"`` (capN) columns over it in a
    serving step, whose rows never spread over ``model``, and in a mesh
    train step whose model ranks share their rows
    (``core.grouped._core_matmul``, forward and backward)."""
    if not _CONSTRAINT_MESH or not dist.is_initialized():
        return None
    mesh = _CONSTRAINT_MESH[-1]
    axis = (LOGICAL_RULES if rules is None else rules).get(name)
    sizes = axis_sizes(mesh)
    if not isinstance(axis, str) or sizes.get(axis, 1) == 1 \
            or size % sizes[axis]:
        return None
    group = mesh.get_group(axis)
    return None if collectives.holds_distinct_rows(group) else group
