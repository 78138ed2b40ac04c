"""Balanced group assignment and compact FLGW execution, forward half.

Port of ``repro.core.grouped``. A capacity-balanced assignment gives every
group ``cap = ceil(M/G * slack)`` row slots and as many column slots by
the same rule; the masked product then runs as G dense
``(capM, capN)`` tiles (``repro_torch.kernels.flgw_matmul``). The
assignment runs on the plan-encode kernels
(``repro_torch.kernels.plan_encode``).

Two consume paths, forward only (the backward of the compact product
waits for the training slice): a bare plan takes the gather path
(``grouped_matmul`` on ``grouped_bmm``); a plan carrying compact weights
(``GroupPlan.wc``, attached once per params version by serving) takes
the fused path (``grouped_matmul_fused`` on ``fused_bmm``).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.flgw import forward_only
from repro_torch.kernels.flgw_matmul import ops as kops
from repro_torch.kernels.plan_encode import ops as pe_ops


class GroupPlan(NamedTuple):
    """Static-shape compact layout of one FLGW layer's mask.

    ``wc`` is the optional weight half of the encode output: the dense W
    compacted to ``(G, capM, capN)`` (:func:`attach_compact`). Serving
    attaches it once per params version; plans from :func:`make_plan`
    leave it ``None``. It snapshots weight values, which no plan
    signature covers, so it is always re-derived from the params being
    served and never rides the process-wide plan cache.
    """
    row_ids: torch.Tensor    # (G, capM) int64 -- rows assigned to each group
    col_ids: torch.Tensor    # (G, capN) int64
    row_valid: torch.Tensor  # (G, capM) bool -- padding slots are False
    col_valid: torch.Tensor  # (G, capN) bool
    row_group: torch.Tensor  # (M,) int64 -- balanced group of each row
    col_group: torch.Tensor  # (N,) int64
    wc: Optional[torch.Tensor] = None  # (G, capM, capN) compact weights


def balanced_assign(scores: torch.Tensor, axis: int,
                    slack: float = 1.0) -> torch.Tensor:
    """Deal items into equal-capacity groups by argmax preference:
    (..., M, G) scores with axis==1, or (..., G, N) with axis==0 ->
    (..., G, cap) item ids; padding slots hold the item count."""
    return pe_ops.balanced_assign(scores, axis, slack)


def _group_of_item(ids: torch.Tensor, size: int) -> torch.Tensor:
    """(..., G, cap) unclipped item ids -> (..., size) group of each item.

    Padding slots hold ``size`` and scatter into one sink slot that is
    sliced off, so every item gets the group that actually holds it.
    """
    lead = ids.shape[:-2]
    g = ids.shape[-2]
    flat = ids.reshape(-1, ids.shape[-2] * ids.shape[-1])
    gid = torch.arange(g, device=ids.device).repeat_interleave(ids.shape[-1])
    out = torch.zeros((flat.shape[0], size + 1), dtype=torch.int64,
                      device=ids.device)
    out.scatter_(1, flat, gid.expand_as(flat))
    return out[:, :size].reshape(*lead, size)


def make_plan(ig: torch.Tensor, og: torch.Tensor,
              slack: float = 1.0) -> GroupPlan:
    """Build the compact layout from the grouping matrices ``ig``
    (..., M, G) and ``og`` (..., G, N); leading dims go through one
    launch of each encode kernel."""
    m = ig.shape[-2]
    n = og.shape[-1]
    row_ids = balanced_assign(ig, axis=1, slack=slack)
    col_ids = balanced_assign(og, axis=0, slack=slack)
    row_group = _group_of_item(row_ids, m)
    col_group = _group_of_item(col_ids, n)
    return GroupPlan(row_ids.clamp(max=m - 1), col_ids.clamp(max=n - 1),
                     row_ids < m, col_ids < n, row_group, col_group)


def transpose_plan(plan: GroupPlan) -> GroupPlan:
    """Plan of Mask^T: the row/column swap of the same layout."""
    wc = None if plan.wc is None else plan.wc.transpose(-1, -2)
    return GroupPlan(row_ids=plan.col_ids, col_ids=plan.row_ids,
                     row_valid=plan.col_valid, col_valid=plan.row_valid,
                     row_group=plan.col_group, col_group=plan.row_group,
                     wc=wc)


RawPlans = dict[str, Any]


def iter_flgw_layers(params: dict, _path=()):
    """Yield ``(path, layer_dict)`` for every FLGW-carrying projection
    (a nested dict holding ``ig``/``og``), in sorted key order -- the order
    the plan signature's per-layer salts follow in both packages."""
    for name, p in sorted(params.items()):
        if not isinstance(p, dict):
            continue
        if "ig" in p:
            yield (*_path, name), p
        else:
            yield from iter_flgw_layers(p, (*_path, name))


def encode_plans(params: dict, cfg) -> RawPlans:
    """One encoding pass over a param tree: a :class:`GroupPlan` for every
    FLGW layer, nested as the params are."""
    plans: RawPlans = {}
    for path, p in iter_flgw_layers(params):
        node = plans
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = make_plan(p["ig"], p["og"], cfg.capacity_slack)
    return plans


def _map_plans(plans: RawPlans, params: dict, fn) -> RawPlans:
    """Rebuild ``plans`` with ``fn(plan, layer_params)`` at every FLGW
    projection, walking params and plans in lockstep."""
    out: RawPlans = {}
    for path, p in iter_flgw_layers(params):
        node_in, node_out = plans, out
        for name in path[:-1]:
            node_in = node_in[name]
            node_out = node_out.setdefault(name, {})
        node_out[path[-1]] = fn(node_in[path[-1]], p)
    return out


def attach_compact(plans: RawPlans, params: dict) -> RawPlans:
    """Attach the compact weights ``W_c`` to every plan: one batched
    gather per projection (stacked layers included), after which
    :func:`grouped_apply` takes the fused kernel path. Re-attach whenever
    the params change."""
    def one(plan: GroupPlan, p: dict) -> GroupPlan:
        return plan._replace(wc=kops.compact_weights(
            p["w"], plan.row_ids, plan.col_ids, plan.row_valid,
            plan.col_valid))
    return _map_plans(plans, params, one)


def strip_compact(plans: RawPlans) -> RawPlans:
    """Drop every plan's ``wc``: back to the pure layout."""
    if isinstance(plans, GroupPlan):
        return plans._replace(wc=None)
    return {k: strip_compact(v) for k, v in plans.items()}


def has_compact(plans) -> bool:
    """Whether any plan in the tree carries attached compact weights."""
    if isinstance(plans, GroupPlan):
        return plans.wc is not None
    return isinstance(plans, dict) and any(has_compact(v)
                                           for v in plans.values())


def _core_matmul(x: torch.Tensor, w: torch.Tensor,
                 plan: GroupPlan) -> torch.Tensor:
    """One compact product: the fused path on attached compact weights,
    else the gather path."""
    if plan.wc is not None:
        return kops.grouped_matmul_fused(x, plan.wc, plan.row_ids,
                                         plan.row_valid, plan.col_ids,
                                         plan.col_valid, n=w.shape[1])
    return kops.grouped_matmul(x, w, plan.row_ids, plan.col_ids,
                               plan.row_valid, plan.col_valid)


def grouped_apply(x: torch.Tensor, w: torch.Tensor, ig: torch.Tensor,
                  og: torch.Tensor, cfg, *, transpose: bool = False,
                  plan: Optional[GroupPlan] = None) -> torch.Tensor:
    """Compact FLGW linear, forward only. ``x``: (..., M) (or (..., N)
    when transposed). ``plan`` is the cached metadata of the
    untransposed layer; ``None`` encodes one here."""
    forward_only(x, w, ig, og)
    if transpose:
        w, ig, og = w.T, og.T, ig.T
        plan = transpose_plan(plan) if plan is not None else None
    if plan is None:
        plan = make_plan(ig, og, cfg.capacity_slack)
    lead = x.shape[:-1]
    y = _core_matmul(x.reshape(-1, x.shape[-1]), w, plan)
    return y.reshape(*lead, -1)
