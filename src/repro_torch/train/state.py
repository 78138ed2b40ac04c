"""Train state: params, optimizer state, step and cached plans.

Port of ``repro.train.state``'s state, init and plans-aware restore.
``state_specs``, ``abstract_state`` and ``plan_specs`` wait for the
sharding slice (ROADMAP, Queue 1).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import adamw_init, rmsprop_init


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


def reencode_plans(state: TrainState, cfg: ModelConfig) -> TrainState:
    """Fresh plans from the state's own params (no-op off the grouped
    path)."""
    if not _uses_plans(cfg):
        return state
    with torch.no_grad():
        return state._replace(plans=transformer.encode_plans(state.params,
                                                             cfg))


def restore_state(ckpt_dir, state: TrainState, cfg: ModelConfig, *,
                  step=None) -> tuple[TrainState, int]:
    """Restore a :class:`TrainState` into ``state``'s tensors (in place,
    see ``restore_checkpoint``), re-encoding plans from the restored
    params instead of loading them.

    Dropping the plans from the restore target migrates pre-plans grouped
    manifests, which have no ``plans`` leaves; and the re-encode never
    trusts checkpointed plans, which may be stale under the refresh
    policy, so the first resumed step is bitwise the uninterrupted run's
    under any refresh mode.
    """
    restored, s = ckpt.restore_checkpoint(ckpt_dir, state._replace(plans=()),
                                          step=step)
    return reencode_plans(restored, cfg), s
