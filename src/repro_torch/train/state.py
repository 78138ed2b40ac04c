"""Train state: params, optimizer state, step and cached plans.

Port of ``repro.train.state``: the state, its init, its spec trees
(``state_specs`` mirrors the state with logical-axis tuples, so the
whole of it, the float32 AdamW/RMSprop moments included, shards with one
rules table: each moment takes its parameter's spec), the abstract
state (shapes and dtypes on the ``meta`` device) and the plans-aware
restore.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import AdamWState, adamw_init, rmsprop_init
from repro_torch.sharding import partition


class TrainState(NamedTuple):
    params: Any                   # the lm_init tree
    opt: Any                      # AdamWState | the rmsprop tree
    step: torch.Tensor            # 0-d int32
    # Cached FLGW metadata (PlanState) on the grouped path; () otherwise.
    plans: Any = ()


def _uses_plans(cfg: ModelConfig) -> bool:
    return cfg.flgw_groups > 1 and cfg.flgw_path == "grouped"


def init_state(generator: torch.Generator, cfg: ModelConfig, *,
               optimizer: str = "adamw") -> TrainState:
    """Params from ``generator`` (on its device), zeroed optimizer state
    and, on the grouped path, the plans of the initial params."""
    params = transformer.lm_init(generator, cfg)
    if optimizer == "adamw":
        opt = adamw_init(params)
    elif optimizer == "rmsprop":
        opt = rmsprop_init(params)
    else:
        raise ValueError(optimizer)
    with torch.no_grad():
        plans = transformer.encode_plans(params, cfg) if _uses_plans(cfg) \
            else ()
    step = torch.zeros((), dtype=torch.int32, device=generator.device)
    return TrainState(params=params, opt=opt, step=step, plans=plans)


def param_specs(cfg: ModelConfig):
    """Logical spec tree of the params (``transformer.lm_specs``)."""
    return transformer.lm_specs(cfg)


def plan_specs(cfg: ModelConfig):
    """Logical spec tree of the cached PlanState (replicated); ``()`` off
    the grouped path. Shared with the serving cache
    (``transformer.plan_specs``)."""
    return transformer.plan_specs(cfg)


def state_specs(cfg: ModelConfig, *, optimizer: str = "adamw") -> TrainState:
    """Logical spec tree with the structure of :func:`init_state`'s
    output."""
    pspecs = param_specs(cfg)
    if optimizer == "adamw":
        opt = AdamWState(mu=pspecs, nu=pspecs, count=())
    elif optimizer == "rmsprop":
        opt = pspecs
    else:
        raise ValueError(optimizer)
    return TrainState(params=pspecs, opt=opt, step=(), plans=plan_specs(cfg))


def abstract_state(cfg: ModelConfig, *, optimizer: str = "adamw"
                   ) -> TrainState:
    """The state :func:`init_state` would build, as ``meta`` tensors of
    its shapes and dtypes: the init runs under a ``FakeTensorMode``, so
    nothing is allocated and no random number is drawn."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = init_state(torch.Generator(), cfg, optimizer=optimizer)
    return partition.map_tree(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), fake)


def init_sharded_state(generator: torch.Generator, cfg: ModelConfig, mesh,
                       shardings: TrainState, *, optimizer: str = "adamw"
                       ) -> TrainState:
    """:func:`init_state`'s state as DTensors of ``shardings``' placements
    on ``mesh`` (``partition.distribute`` of it, value for value): the
    params are drawn whole, every rank the same, and cut to this rank's
    shards; the optimizer state is made from the shards alone, so the
    whole float32 moments never exist on a rank."""
    params = transformer.lm_init(generator, cfg)
    with torch.no_grad():
        plans = transformer.encode_plans(params, cfg) if _uses_plans(cfg) \
            else ()
    params = partition.distribute(params, shardings.params, mesh)
    local = partition.local(params)
    if optimizer == "adamw":
        opt = adamw_init(local)
    elif optimizer == "rmsprop":
        opt = rmsprop_init(local)
    else:
        raise ValueError(optimizer)
    step = torch.zeros((), dtype=torch.int32, device=generator.device)
    return TrainState(params=params,
                      opt=partition.from_local(opt, shardings.opt, mesh),
                      step=partition.replicate(step, mesh),
                      plans=partition.replicate(plans, mesh))


def reencode_plans(state: TrainState, cfg: ModelConfig) -> TrainState:
    """Fresh plans from the state's own params (no-op off the grouped
    path)."""
    if not _uses_plans(cfg):
        return state
    with torch.no_grad():
        return state._replace(plans=transformer.encode_plans(state.params,
                                                             cfg))


def restore_state(ckpt_dir, state: TrainState, cfg: ModelConfig, *,
                  shardings=None, step=None) -> tuple[TrainState, int]:
    """Restore a :class:`TrainState` into ``state``'s tensors (in place,
    see ``restore_checkpoint``; with ``shardings``, a placements tree of
    the state's structure, onto each rank's shards of a mesh),
    re-encoding plans from the restored params instead of loading them
    (on a mesh from the gathered grouping matrices, replicated).

    Dropping the plans from the restore target migrates pre-plans grouped
    manifests, which have no ``plans`` leaves; and the re-encode never
    trusts checkpointed plans, which may be stale under the refresh
    policy, so the first resumed step is bitwise the uninterrupted run's
    under any refresh mode.
    """
    if shardings is not None and hasattr(shardings, "_replace"):
        shardings = shardings._replace(plans=())
    restored, s = ckpt.restore_checkpoint(ckpt_dir, state._replace(plans=()),
                                          shardings=shardings, step=step)
    if shardings is None or not _uses_plans(cfg):
        return reencode_plans(restored, cfg), s
    with torch.no_grad():
        plans = transformer.encode_plans(
            partition.gather_grouping(restored.params), cfg)
    return restored._replace(
        plans=partition.replicate(plans, partition.mesh_of(restored))), s
