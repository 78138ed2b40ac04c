"""Balanced group assignment and compact FLGW execution.

Port of ``repro.core.grouped``. A capacity-balanced assignment gives every
group ``cap = ceil(M/G * slack)`` row slots and as many column slots by
the same rule; the masked product then runs as G dense
``(capM, capN)`` tiles (``repro_torch.kernels.flgw_matmul``). The
assignment runs on the plan-encode kernels
(``repro_torch.kernels.plan_encode``).

Two consume paths: a bare plan takes the gather path (``grouped_matmul``
on ``grouped_bmm``); a plan carrying compact weights (``GroupPlan.wc``,
attached once per params version by serving) takes the fused path
(``grouped_matmul_fused`` on ``fused_bmm``). :class:`_GroupedCore` makes
either differentiable: dx and dW exactly, through the transposed compact
products, and dIG/dOG through the sparse-restricted straight-through
estimator, with the plan an input that the backward reuses. Stacked
experts (a leading expert axis on W, IG, OG, x and the plan) run every
expert's tiles in one launch, forward only.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F

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


def make_plan(ig: torch.Tensor, og: torch.Tensor,
              slack: float = 1.0) -> GroupPlan:
    """Build the compact layout from the grouping matrices ``ig``
    (..., M, G) and ``og`` (..., G, N); leading dims go through one
    launch of the encode kernel a side. Each item's group comes from the
    unclipped assignment (the group whose slot holds it)."""
    m = ig.shape[-2]
    n = og.shape[-1]
    row_ids, row_group = pe_ops.assign(ig, 1, slack)
    col_ids, col_group = pe_ops.assign(og, 0, slack)
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
    else the gather path. x (B, M) and w (M, N), or with a leading
    expert axis x (E, B, M), w (E, M, N) and the plan's leaves (E, G,
    cap): one kernel launch either way."""
    if plan.wc is not None:
        return kops.grouped_matmul_fused(x, plan.wc, plan.row_ids,
                                         plan.row_valid, plan.col_ids,
                                         plan.col_valid, n=w.shape[-1])
    return kops.grouped_matmul(x, w, plan.row_ids, plan.col_ids,
                               plan.row_valid, plan.col_valid)


def _grouped_bwd(x: torch.Tensor, w: torch.Tensor, ig: torch.Tensor,
                 og: torch.Tensor, plan: GroupPlan, temperature: float,
                 gy: torch.Tensor):
    """(dx, dW, dIG, dOG) of one compact product, as the JAX package's
    ``_grouped_bwd``. Its two products are XLA einsums there, outside any
    Pallas kernel, so here they are ``torch.bmm`` in the operands' dtype
    (f32 accumulation); the scatters send padding slots to a sink row or
    column that is sliced off."""
    b = x.shape[0]
    m, g = ig.shape
    n = og.shape[1]
    cap_n = plan.col_ids.shape[1]
    xg = kops.gather_x(x, plan.row_ids, plan.row_valid)
    wc = plan.wc if plan.wc is not None else kops.compact_weights(
        w, plan.row_ids, plan.col_ids, plan.row_valid, plan.col_valid)
    gc = gy[:, plan.col_ids.reshape(-1)].reshape(b, g, cap_n).permute(1, 0, 2)
    gc = torch.where(plan.col_valid[:, None, :], gc, 0)

    # dX: the transposed compact product (Mask^T has the same structure
    # with IG/OG swapped, so the compact tiles are reused).
    flat_rows = torch.where(plan.row_valid, plan.row_ids, m).reshape(-1)
    flat_cols = torch.where(plan.col_valid, plan.col_ids, n).reshape(-1)
    dxc = torch.bmm(gc, wc.transpose(1, 2))                  # (G, B, capM)
    dx = x.new_zeros((b, m + 1))
    dx[:, flat_rows] = dxc.permute(1, 0, 2).reshape(b, -1)

    # dW: compact outer products scattered to the dense weight.
    dwc = torch.bmm(xg.transpose(1, 2), gc)                  # (G, capM, capN)
    dw = w.new_zeros((m + 1, n + 1))
    dw[flat_rows.reshape(g, -1, 1), flat_cols.reshape(g, 1, -1)] = dwc

    # dIG/dOG: the mask gradient on surviving entries is dW * W, reduced
    # to per-row / per-column scalars and pushed through the softmax
    # Jacobian at the assigned group.
    dmask = dwc * wc
    s_row = torch.zeros(m + 1, dtype=torch.float32, device=x.device)
    s_row[flat_rows] = dmask.sum(2).float().reshape(-1)
    s_col = torch.zeros(n + 1, dtype=torch.float32, device=x.device)
    s_col[flat_cols] = dmask.sum(1).float().reshape(-1)
    s_row, s_col = s_row[:m], s_col[:n]

    tau = temperature
    soft_ig = torch.softmax(ig / tau, dim=1)                 # (M, G)
    pg_row = F.one_hot(plan.row_group, g).to(soft_ig.dtype)
    sel_r = (soft_ig * pg_row).sum(1, keepdim=True)
    dig = (s_row[:, None] / tau) * sel_r * (pg_row - soft_ig)
    soft_og = torch.softmax(og / tau, dim=0)                 # (G, N)
    pg_col = F.one_hot(plan.col_group, g).T.to(soft_og.dtype)
    sel_c = (soft_og * pg_col).sum(0, keepdim=True)
    dog = (s_col[None, :] / tau) * sel_c * (pg_col - soft_og)
    return dx[:, :m], dw[:m, :n], dig.to(ig.dtype), dog.to(og.dtype)


class _GroupedCore(torch.autograd.Function):
    """The compact product against a precomputed plan. The plan is an
    input, not rebuilt in the backward: one encode serves the forward,
    any recomputation and the backward of a step. It and ``wc`` get no
    gradient (the weight's flows through dW)."""

    @staticmethod
    def forward(ctx, x, w, ig, og, plan, temperature):
        ctx.plan, ctx.temperature = plan, temperature
        ctx.save_for_backward(x, w, ig, og)
        return _core_matmul(x, w, plan)

    @staticmethod
    def backward(ctx, gy):
        x, w, ig, og = ctx.saved_tensors
        return (*_grouped_bwd(x, w, ig, og, ctx.plan, ctx.temperature, gy),
                None, None)


_MOE_TRAINING = (
    "training a grouped MoE (the compact product's backward over a "
    "leading expert axis) is not ported to repro_torch yet (ROADMAP, "
    "Queue 1: MoE training); serve it under torch.inference_mode, or "
    "train on the masked or dense path")


def grouped_apply(x: torch.Tensor, w: torch.Tensor, ig: torch.Tensor,
                  og: torch.Tensor, cfg, *, transpose: bool = False,
                  plan: Optional[GroupPlan] = None) -> torch.Tensor:
    """Compact FLGW linear, differentiable in x, W, IG and OG. ``x``:
    (..., M) (or (..., N) when transposed). ``plan`` is the cached
    metadata of the untransposed layer; ``None`` encodes one here.

    Stacked experts: w (E, M, N), ig (E, M, G), og (E, G, N), x (E, ...,
    M) and plan leaves (E, G, cap) run every expert's tiles in one kernel
    launch, forward only: when autograd records, this raises
    ``NotImplementedError`` (ROADMAP, Queue 1: MoE training)."""
    experts = w.dim() == 3
    if experts and torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w, ig, og)):
        raise NotImplementedError(_MOE_TRAINING)
    if transpose:
        w, ig, og = w.mT, og.mT, ig.mT
        plan = transpose_plan(plan) if plan is not None else None
    if plan is None:
        plan = make_plan(ig.detach(), og.detach(), cfg.capacity_slack)
    lead = x.shape[:-1]
    if experts:
        y = _core_matmul(x.reshape(w.shape[0], -1, x.shape[-1]), w, plan)
    else:
        y = _GroupedCore.apply(x.reshape(-1, x.shape[-1]), w, ig, og, plan,
                               cfg.ste_temperature)
    return y.reshape(*lead, -1)
