"""The train step.

Port of ``repro.train.step``'s ``make_train_step``: ``(state, batch) ->
(state, metrics)`` runs the forward (remat'd layer slots, chunked CE),
the backward, optional microbatch gradient accumulation in float32, the
global-norm clip and the optimizer update. On the FLGW grouped path the
step first passes ``state.plans`` through ``encoder.maybe_refresh``, so
every projection of the step, its recomputation and its backward
consume one encode.

On a ``(data, model)`` mesh (``mesh=``) the state's leaves are DTensors,
each rank holding its shards (``sharding.partition.distribute``), and
the step runs on each rank's rows of the global batch
(``partition.step_rows``: with microbatches, its rows of each global
microbatch, so an MoE layer's capacity and aux count over the global
microbatch as the reference's do) with explicit, counted collectives
(``sharding.collectives``): the grouping matrices are gathered whole for
the plan encode, so every rank encodes the same replicated plans; each
layer slot's weights are all-gathered just before the slot computes,
inside its remat (the backward gathers again), and the gradient of each
weight is reduce-scattered back onto its shards in float32
(``collectives.gather_shards``), summed over every rank and divided by
their number (each rank's loss is a mean over its rows, so ranks that
hold the same rows count once). Where the ``model`` ranks hold the same
rows (the rows do not divide over them: the reference's layout, its
batch over the data axes only), every compact product splits its capN
output columns over them in the forward, the remat recomputation and
the backward (``partition.use_constraints(mesh)`` around the three;
``core.grouped._grouped_bwd`` says how its split gradients count once);
where the rows spread over ``model`` each rank computes whole tiles
of its own rows. The clip's norm is one scalar
all-reduce, each replicated leaf counted once; the optimizer updates
each rank's shards. The loss, the metrics, the clip and the update are
the one-process step's up to the order of the sums, and on a one-rank
mesh bitwise.

The optimizer updates ``state``'s params and moments in place (see
``repro_torch.optim``) and the returned state holds the same tensors:
the state passed in is consumed, and a caller that needs the old values
copies them first. The step function carries ``mutates_state = True``,
so ``repro_torch.runtime.StepRunner`` never retries it from a state a
failed attempt may have written.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.analysis import contracts
from repro_torch.core import encoder as planenc
from repro_torch.core.flgw import FLGWConfig
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import (AdamWState, adamw,
                                          clip_by_global_norm, rmsprop,
                                          tree_map)
from repro_torch.sharding import collectives, partition
from repro_torch.train.loss import chunked_cross_entropy
from repro_torch.train.state import TrainState

# the param tree's top-level leaves a mesh step gathers before the
# forward (the layer slots gather their own, inside their remat)
_TOP = ("embed", "final_norm", "enc_norm")


def pick_q_chunk(s: int, pref: int = 512) -> int:
    """Largest divisor of ``s`` that is <= pref and a multiple of 128 (or
    s)."""
    if s <= pref:
        return s
    for c in range(pref, 127, -128):
        if s % c == 0:
            return c
    for c in range(pref, 0, -1):
        if s % c == 0:
            return c
    return s


def _loss_fn(params, batch, cfg: ModelConfig, q_chunk: int,
             banded: bool = False, ce_chunk: int = 512, plans=None,
             gather=None):
    if gather is not None:
        params = dict(params, **{k: gather(params[k], (k,))
                                 for k in _TOP if k in params})
    hidden, aux, _ = transformer.lm_apply(
        params, cfg, batch["tokens"], batch["positions"],
        patch_embeds=batch.get("patch_embeds"), frames=batch.get("frames"),
        q_chunk=q_chunk,
        banded=banded, return_hidden=True, plans=plans, gather=gather)
    ce = chunked_cross_entropy(
        hidden, params["embed"]["embedding"], batch["targets"],
        logit_softcap=cfg.logit_softcap, chunk=ce_chunk)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def loss_and_grads(params, batch, cfg: ModelConfig, *, q_chunk: int,
                   banded: bool = False, ce_chunk: int = 512, plans=None,
                   gather=None):
    """``(loss, metrics, grads)`` of :func:`_loss_fn`, the grads a tree
    like ``params`` (leaves no graph reaches get zeros). ``gather(tree,
    path, lead=0)``: a mesh step's, building the subtree of the params at
    ``path`` whole from its shards (``params`` then holds this rank's
    shards, and each grad is the mesh's, reduce-scattered onto them)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = _loss_fn(leaves, batch, cfg, q_chunk, banded,
                                 ce_chunk, plans, gather)
        loss.backward()
    grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                     else p.grad, leaves)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _owned(tree, mesh):
    """True at each leaf this rank counts in a global sum: the rank at
    coordinate 0 of every mesh dimension that replicates the leaf."""
    coords = partition.mesh_coords(mesh)
    return partition.map_tree(
        lambda x: all(c == 0 for c, p in zip(coords, x.placements)
                      if not p.is_shard()), tree)


def _world(mesh):
    """The process group of the whole mesh (a mesh step's reductions of
    scalars); the mesh must span the group."""
    if not dist.is_initialized():
        return None
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"a mesh step needs a mesh over the whole group: "
                         f"{mesh.size()} of {dist.get_world_size()} ranks")
    return dist.group.WORLD


def _rewrap_opt(sharded, opt, mesh):
    """The optimizer state after an update of its local views: AdamW's
    new ``count`` replicated beside the sharded moments."""
    if isinstance(opt, AdamWState):
        return sharded._replace(count=partition.replicate(opt.count, mesh))
    return sharded


def make_train_step(cfg: ModelConfig, *, optimizer: str = "adamw",
                    lr: float = 3e-4, clip: float = 1.0,
                    microbatches: int = 1, banded: bool = False,
                    q_chunk: Optional[int] = None, ce_chunk: int = 512,
                    schedule=None, mesh=None,
                    global_batch: Optional[int] = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch``: ``tokens``, ``targets``, ``positions`` (B, S) integer
    tensors on the state's device, for a VLM ``patch_embeds`` (B, P, d),
    whose positions the loss skips, and for an encoder-decoder (whisper)
    ``frames`` (B, T, d), the encoder's input. ``banded``: the chunked
    attention core attends each chunk's KV band only. ``schedule``: the
    plan-refresh ``SparsitySchedule`` (None: re-encode every step).
    ``microbatches`` splits the batch and averages float32-accumulated
    grads. ``mesh``: a ``(data, model)`` DeviceMesh; ``state`` then holds
    DTensors (``partition.distribute``) and ``batch`` this rank's rows
    (``partition.step_rows`` of ``global_batch`` and ``microbatches``,
    which a mesh step needs), see the module docstring. The step
    consumes ``state``: its params and optimizer tensors are updated in
    place and shared with the returned state.
    """
    uses_plans = cfg.flgw_groups > 1 and cfg.flgw_path == "grouped"
    fl_cfg = FLGWConfig(groups=cfg.flgw_groups, path=cfg.flgw_path)
    if optimizer not in ("adamw", "rmsprop"):
        raise ValueError(optimizer)

    row_groups = ()     # the groups whose ranks hold distinct rows
    # the forward, its remat recomputation and the backward split the
    # compact products' capN columns over the model ranks that share rows
    constraints = (contextlib.nullcontext if mesh is None else
                   functools.partial(partition.use_constraints, mesh))
    if mesh is not None:
        if global_batch is None:
            raise ValueError("a mesh step needs global_batch")
        world = _world(mesh)
        rows, split = partition.step_rows(mesh, global_batch, microbatches)
        groups = dict(zip(mesh.mesh_dim_names, partition.mesh_groups(mesh)))
        row_groups = [groups[a] for a in split]     # in batch_rows' order

    def train_step(state: TrainState, batch):
        contracts.record("train_step", state, batch)
        s = batch["tokens"].shape[1]
        qc = q_chunk or pick_q_chunk(s)
        sharded = state
        if mesh is not None:
            state = partition.local(state)
            # each gradient weighed by 1 / the mesh's ranks
            gather = partition.gatherer(sharded.params, 1.0 / mesh.size())
            grouping = partition.gather_grouping(sharded.params) \
                if uses_plans else state.params
        else:
            gather, grouping = None, state.params
        plans = state.plans
        if uses_plans and isinstance(plans, planenc.PlanState):
            plans = planenc.maybe_refresh(grouping, plans, state.step,
                                          fl_cfg, schedule)
        kw = dict(q_chunk=qc, banded=banded, ce_chunk=ce_chunk,
                  plans=plans if uses_plans else None, gather=gather)
        if mesh is not None and batch["tokens"].shape[0] != len(rows):
            raise ValueError(f"a mesh step takes this rank's {len(rows)} "
                             f"rows of the global batch, got "
                             f"{batch['tokens'].shape[0]}")

        if microbatches == 1:
            with collectives.rows_over(row_groups), constraints():
                loss, metrics, grads = loss_and_grads(state.params, batch,
                                                      cfg, **kw)
        else:
            grads = tree_map(lambda p: torch.zeros_like(p,
                                                        dtype=torch.float32),
                             state.params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for b_i in zip(*(v.chunk(microbatches) for v in batch.values())):
                with collectives.rows_over(row_groups), constraints():
                    l_i, _, g_i = loss_and_grads(
                        state.params, dict(zip(batch, b_i)), cfg, **kw)
                grads = tree_map(torch.add, grads, g_i)
                loss = loss + l_i
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}

        with torch.no_grad():
            if mesh is None:
                grads, gnorm = clip_by_global_norm(grads, clip)
            else:
                # every rank's mean, weighed as the gradients are
                metrics = dict(metrics, loss=loss)
                total = collectives.all_reduce(
                    torch.stack(list(metrics.values())), world) / mesh.size()
                metrics = dict(zip(metrics, total.unbind()))
                loss = metrics.pop("loss")
                grads, gnorm = clip_by_global_norm(
                    grads, clip, owned=_owned(sharded.params, mesh),
                    group=world)
            update = adamw if optimizer == "adamw" else rmsprop
            params, opt = update(state.params, grads, state.opt, lr=lr)
        new_state = TrainState(params=params, opt=opt, step=state.step + 1,
                               plans=plans)
        if mesh is not None:
            # params and moments were updated in place through the local
            # views; the new scalars and plans are replicated
            new_state = TrainState(
                params=sharded.params,
                opt=_rewrap_opt(sharded.opt, opt, mesh),
                step=partition.replicate(new_state.step, mesh),
                plans=partition.replicate(plans, mesh))
        return new_state, dict(metrics, loss=loss, grad_norm=gnorm)

    train_step.mutates_state = True
    return train_step
