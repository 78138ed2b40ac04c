"""The train step.

Port of ``repro.train.step``'s ``make_train_step``: ``(state, batch) ->
(state, metrics)`` runs the forward (remat'd layer slots, chunked CE),
the backward, optional microbatch gradient accumulation in float32, the
global-norm clip and the optimizer update. On the FLGW grouped path the
step first passes ``state.plans`` through ``encoder.maybe_refresh``, so
every projection of the step, its recomputation and its backward
consume one encode.

The optimizer updates ``state``'s params and moments in place (see
``repro_torch.optim``) and the returned state holds the same tensors:
the state passed in is consumed, and a caller that needs the old values
copies them first. The step function carries ``mutates_state = True``,
so ``repro_torch.runtime.StepRunner`` never retries it from a state a
failed attempt may have written.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import encoder as planenc
from repro_torch.core.flgw import FLGWConfig
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import (adamw, clip_by_global_norm, rmsprop,
                                          tree_map)
from repro_torch.train.loss import chunked_cross_entropy
from repro_torch.train.state import TrainState


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
             banded: bool = False, ce_chunk: int = 512, plans=None):
    hidden, aux, _ = transformer.lm_apply(
        params, cfg, batch["tokens"], batch["positions"],
        patch_embeds=batch.get("patch_embeds"), q_chunk=q_chunk,
        banded=banded, return_hidden=True, plans=plans)
    ce = chunked_cross_entropy(
        hidden, params["embed"]["embedding"], batch["targets"],
        logit_softcap=cfg.logit_softcap, chunk=ce_chunk)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def loss_and_grads(params, batch, cfg: ModelConfig, *, q_chunk: int,
                   banded: bool = False, ce_chunk: int = 512, plans=None):
    """``(loss, metrics, grads)`` of :func:`_loss_fn`, the grads a tree
    like ``params`` (leaves no graph reaches get zeros)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = _loss_fn(leaves, batch, cfg, q_chunk, banded,
                                 ce_chunk, plans)
        loss.backward()
    grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                     else p.grad, leaves)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: ModelConfig, *, optimizer: str = "adamw",
                    lr: float = 3e-4, clip: float = 1.0,
                    microbatches: int = 1, banded: bool = False,
                    q_chunk: Optional[int] = None, ce_chunk: int = 512,
                    schedule=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch``: ``tokens``, ``targets``, ``positions`` (B, S) integer
    tensors on the state's device, and for a VLM ``patch_embeds`` (B, P,
    d), whose positions the loss skips. ``banded``: the chunked attention
    core attends each chunk's KV band only. ``schedule``: the plan-refresh
    ``SparsitySchedule`` (None: re-encode every step). ``microbatches``
    splits the batch and averages float32-accumulated grads. The step
    consumes ``state``: its params and optimizer tensors are updated in
    place and shared with the returned state.
    """
    uses_plans = cfg.flgw_groups > 1 and cfg.flgw_path == "grouped"
    fl_cfg = FLGWConfig(groups=cfg.flgw_groups, path=cfg.flgw_path)
    if optimizer not in ("adamw", "rmsprop"):
        raise ValueError(optimizer)

    def train_step(state: TrainState, batch):
        s = batch["tokens"].shape[1]
        qc = q_chunk or pick_q_chunk(s)
        plans = state.plans
        if uses_plans and isinstance(plans, planenc.PlanState):
            plans = planenc.maybe_refresh(state.params, plans, state.step,
                                          fl_cfg, schedule)
        kw = dict(q_chunk=qc, banded=banded, ce_chunk=ce_chunk,
                  plans=plans if uses_plans else None)

        if microbatches == 1:
            loss, metrics, grads = loss_and_grads(state.params, batch, cfg,
                                                  **kw)
        else:
            grads = tree_map(lambda p: torch.zeros_like(p,
                                                        dtype=torch.float32),
                             state.params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for b_i in zip(*(v.chunk(microbatches) for v in batch.values())):
                l_i, _, g_i = loss_and_grads(state.params,
                                             dict(zip(batch, b_i)), cfg, **kw)
                grads = tree_map(torch.add, grads, g_i)
                loss = loss + l_i
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}

        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, clip)
            update = adamw if optimizer == "adamw" else rmsprop
            params, opt = update(state.params, grads, state.opt, lr=lr)
        new_state = TrainState(params=params, opt=opt, step=state.step + 1,
                               plans=plans)
        return new_state, dict(metrics, loss=loss, grad_norm=gnorm)

    train_step.mutates_state = True
    return train_step
