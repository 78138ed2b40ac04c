"""Conversion of the JAX package's trees into the port's types.

The trees arrive as numpy arrays (``np.asarray`` of each JAX leaf), so
this module needs neither ``jax`` nor ``repro``. JAX's bfloat16 leaves
arrive as ``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy``
rejects; they go through float32, which holds every bf16 value exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.grouped import GroupPlan


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
