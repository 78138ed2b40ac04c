"""Conversion between the JAX package's trees and the port's types.

The trees arrive as numpy arrays (``np.asarray`` of each JAX leaf), so
this module needs neither ``jax`` nor ``repro``. JAX's bfloat16 leaves
arrive as ``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy``
rejects; they go through float32, which holds every bf16 value exactly.
:func:`tree_to_numpy` goes the other way (bf16 as float32), for
comparisons.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.encoder import PlanState
from repro_torch.core.grouped import GroupPlan
from repro_torch.marl.async_train import Trajectory
from repro_torch.marl.ic3net import IC3Net, IC3NetConfig
from repro_torch.optim.optimizers import AdamWState, rmsprop_init
from repro_torch.sharding import partition
from repro_torch.train.state import TrainState, state_specs


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """One leaf -> a tensor of the same dtype (bfloat16 included)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree: dict, _prefix: str = "") -> dict[str, torch.Tensor]:
    """A JAX param tree (nested dicts of arrays) -> the port's state dict:
    ``{"enc": {"w": ...}, "lstm_b": ...}`` becomes
    ``{"enc.w": ..., "lstm_b": ...}``, ready for ``load_state_dict``."""
    out: dict[str, torch.Tensor] = {}
    for name, v in tree.items():
        if isinstance(v, dict):
            out.update(params_from_numpy(v, f"{_prefix}{name}."))
        else:
            out[f"{_prefix}{name}"] = tensor_from_numpy(v)
    return out


def lm_params_from_numpy(tree: dict, device=None) -> dict:
    """A JAX LM param tree (nested dicts, stacked block leaves) -> the
    same nesting of tensors, as ``repro_torch.models.transformer`` takes
    it."""
    return {name: (lm_params_from_numpy(v, device) if isinstance(v, dict)
                   else tensor_from_numpy(v, device))
            for name, v in tree.items()}


def plan_from_numpy(plan, device=None) -> GroupPlan:
    """A JAX ``GroupPlan`` (any object with its fields, as arrays) -> the
    port's GroupPlan: ids and groups int64, validity masks bool, ``wc``
    (when attached) in its own dtype. Leading (stacked) dims are kept."""
    def conv(a, dtype):
        return torch.from_numpy(np.asarray(a).astype(dtype)).to(device)
    wc = None if plan.wc is None else tensor_from_numpy(plan.wc, device)
    return GroupPlan(conv(plan.row_ids, np.int64), conv(plan.col_ids, np.int64),
                     conv(plan.row_valid, bool), conv(plan.col_valid, bool),
                     conv(plan.row_group, np.int64),
                     conv(plan.col_group, np.int64), wc)


def plans_from_numpy(plans, device=None):
    """A nested dict of JAX GroupPlans (a PlanState's ``plans``) -> the
    same nesting of the port's GroupPlans."""
    if isinstance(plans, dict):
        return {k: plans_from_numpy(v, device) for k, v in plans.items()}
    return plan_from_numpy(plans, device)


def train_state_from_numpy(state, device=None, *, mesh=None,
                           cfg=None) -> TrainState:
    """A JAX ``TrainState`` with numpy leaves -> the port's: params,
    the optimizer state (AdamW ``mu``/``nu``/``count``, or RMSprop's
    tree), ``step`` and, on the grouped path, the PlanState (``sig`` as
    the port's int64 scalar). ``mesh``: a ``(data, model)`` DeviceMesh;
    the carried state is then sharded onto it by the placements of
    ``partition.constrained_shardings`` of ``cfg``'s ``state_specs``
    (every rank passes the same state and keeps its shards)."""
    out = _train_state_from_numpy(state, device)
    if mesh is None:
        return out
    opt = "adamw" if isinstance(out.opt, AdamWState) else "rmsprop"
    shardings = partition.constrained_shardings(
        state_specs(cfg, optimizer=opt), out, mesh)
    return partition.distribute(out, shardings, mesh)


def _train_state_from_numpy(state, device=None) -> TrainState:
    opt = state.opt
    if hasattr(opt, "mu"):
        opt = AdamWState(mu=lm_params_from_numpy(opt.mu, device),
                         nu=lm_params_from_numpy(opt.nu, device),
                         count=tensor_from_numpy(opt.count, device))
    else:
        opt = lm_params_from_numpy(opt, device)
    plans = state.plans
    if hasattr(plans, "sig"):
        plans = PlanState(plans_from_numpy(plans.plans, device),
                          torch.tensor(int(plans.sig), dtype=torch.int64,
                                       device=device))
    return TrainState(params=lm_params_from_numpy(state.params, device),
                      opt=opt, step=tensor_from_numpy(state.step, device),
                      plans=plans)


def ic3net_from_numpy(cfg: IC3NetConfig, params: dict, opt_state=None,
                      device=None):
    """A JAX IC3Net train state -> the port's ``(IC3Net, RMSprop state)``:
    ``params`` and ``opt_state`` (the square-average tree, or None for a
    fresh one) as numpy trees; ``cfg`` with ``obs_dim`` filled in.
    ``device=None`` means the CUDA card."""
    model = IC3Net(cfg, device=device)
    model.load_state_dict(params_from_numpy(params))
    opt = rmsprop_init(model.params) if opt_state is None else \
        lm_params_from_numpy(opt_state, model.device)
    return model, opt


def trajectory_from_numpy(traj, device=None) -> Trajectory:
    """A JAX ``async_train.Trajectory`` (any object with its fields, as
    arrays) -> the port's: actions int64 (the port's action dtype), the
    rest in their own dtypes. ``device=None`` means the CPU."""
    def conv(a, dtype=None):
        a = np.asarray(a)
        return torch.from_numpy(np.array(a if dtype is None
                                         else a.astype(dtype))).to(device)
    return Trajectory(obs=conv(traj.obs), act=conv(traj.act, np.int64),
                      gates=conv(traj.gates), rew=conv(traj.rew),
                      logp=conv(traj.logp), succ=conv(traj.succ, bool))


def tree_to_numpy(tree):
    """Tensors of nested dicts and NamedTuples -> numpy copies (bf16 as
    float32) in the same structure; other leaves pass. Copies, because
    the optimizers update their tensors in place."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return np.array((t.float() if t.dtype == torch.bfloat16
                         else t).numpy())
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_to_numpy(v) for v in tree))
    return tree
