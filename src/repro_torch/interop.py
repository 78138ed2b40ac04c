"""Conversion of the JAX package's trees into the port's types.

The trees arrive as numpy arrays (``np.asarray`` of each JAX leaf), so
this module needs neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.grouped import GroupPlan


def params_from_numpy(tree: dict, _prefix: str = "") -> dict[str, torch.Tensor]:
    """A JAX param tree (nested dicts of arrays) -> the port's state dict:
    ``{"enc": {"w": ...}, "lstm_b": ...}`` becomes
    ``{"enc.w": ..., "lstm_b": ...}``, ready for ``load_state_dict``."""
    out: dict[str, torch.Tensor] = {}
    for name, v in tree.items():
        if isinstance(v, dict):
            out.update(params_from_numpy(v, f"{_prefix}{name}."))
        else:
            out[f"{_prefix}{name}"] = torch.from_numpy(np.array(v))
    return out


def plan_from_numpy(plan, device=None) -> GroupPlan:
    """A JAX ``GroupPlan`` (any object with its fields, as arrays) -> the
    port's GroupPlan: ids and groups int64, validity masks bool."""
    def conv(a, dtype):
        return torch.from_numpy(np.asarray(a).astype(dtype)).to(device)
    return GroupPlan(conv(plan.row_ids, np.int64), conv(plan.col_ids, np.int64),
                     conv(plan.row_valid, bool), conv(plan.col_valid, bool),
                     conv(plan.row_group, np.int64),
                     conv(plan.col_group, np.int64))
