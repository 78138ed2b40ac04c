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
expert's tiles in one launch, and their backward as one batch of E·G
tiles.
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


def _scatter_weight(dwc: torch.Tensor, plan: GroupPlan, m: int,
                    n: int) -> torch.Tensor:
    """dW's scatter: compact tiles (E·G, capM, capN) -> the dense (E, M,
    N) gradient, or (M, N) for a plan without the expert axis. Each
    entry goes to one flat int64 offset row·(N+1) + col of an (E·(M+1),
    N+1) buffer, expert e's rows offset by e·(M+1), padding slots to a
    sink row or column that is sliced off. The offsets are built for as
    many tiles at a time as keep them near ``kops._INDEX_BYTES``:
    indexing with separate row and column tensors would broadcast both
    to the tiles' shape, 16 B of index for each 2-byte entry (~5 GB a
    projection at mixtral-8x22b's width)."""
    e = plan.row_ids.shape[0] if plan.row_ids.dim() == 3 else 1
    rows = torch.where(plan.row_valid, plan.row_ids, m)
    cols = torch.where(plan.col_valid, plan.col_ids, n)
    if e > 1:
        rows = rows + torch.arange(e, device=rows.device)[:, None, None] * (
            m + 1)
    cap_m, cap_n = rows.shape[-1], cols.shape[-1]
    rows, cols = rows.reshape(-1, cap_m, 1), cols.reshape(-1, 1, cap_n)
    dw = dwc.new_zeros((e * (m + 1) * (n + 1),))
    step = max(1, kops._INDEX_BYTES // (8 * cap_m * cap_n))
    for i in range(0, dwc.shape[0], step):
        j = min(i + step, dwc.shape[0])
        dw[(rows[i:j] * (n + 1) + cols[i:j]).reshape(-1)] = \
            dwc[i:j].reshape(-1)
    dw = dw.view(e, m + 1, n + 1)[:, :m, :n]
    return dw if plan.row_ids.dim() == 3 else dw[0]


def _scatter_rows(sc: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
                  m: int) -> torch.Tensor:
    """Per-slot sums (E·G, cap) -> per-item float32 (E, M), or (M,)
    without the expert axis; padding slots go to a sliced-off sink."""
    e = ids.shape[0] if ids.dim() == 3 else 1
    flat = torch.where(valid, ids, m)
    if e > 1:
        flat = flat + torch.arange(e, device=ids.device)[:, None, None] * (
            m + 1)
    out = torch.zeros(e * (m + 1), dtype=torch.float32, device=sc.device)
    out[flat.reshape(-1)] = sc.float().reshape(-1)
    out = out.view(e, m + 1)[:, :m]
    return out if ids.dim() == 3 else out[0]


def _grouped_bwd(x: torch.Tensor, w: torch.Tensor, ig: torch.Tensor,
                 og: torch.Tensor, plan: GroupPlan, temperature: float,
                 gy: torch.Tensor):
    """(dx, dW, dIG, dOG) of one compact product, as the JAX package's
    ``_grouped_bwd``: x (B, M), w (M, N), ig (M, G), og (G, N), plan
    leaves (G, cap) and gy (B, N); or, with a leading expert axis, x (E,
    B, M), w (E, M, N), ig (E, M, G), og (E, G, N), leaves (E, G, cap)
    and gy (E, B, N), every expert's gradients at once (JAX vmaps its
    backward over the experts). Its two products are XLA einsums there,
    outside any Pallas kernel, so here they are ``torch.bmm`` over the
    E·G tiles in the operands' dtype (f32 accumulation); the scatters
    send padding slots to a sink row or column that is sliced off."""
    m, g = ig.shape[-2:]
    n = og.shape[-1]
    xg = kops.gather_x(x, plan.row_ids, plan.row_valid)      # (E·G, B, capM)
    gc = kops.gather_x(gy, plan.col_ids, plan.col_valid)     # (E·G, B, capN)
    wc = (plan.wc if plan.wc is not None else kops.compact_weights(
        w, plan.row_ids, plan.col_ids, plan.row_valid, plan.col_valid)
    ).flatten(0, -3)                                        # (E·G, capM, capN)

    # dX: the transposed compact product (Mask^T has the same structure
    # with IG/OG swapped, so the compact tiles are reused).
    dxc = torch.bmm(gc, wc.transpose(1, 2))                  # (E·G, B, capM)
    dx = kops.scatter_cols(dxc, plan.row_ids, plan.row_valid, m)

    # dW: compact outer products scattered to the dense weight.
    dwc = torch.bmm(xg.transpose(1, 2), gc)                  # (E·G, capM, capN)
    dw = _scatter_weight(dwc, plan, m, n)

    # dIG/dOG: the mask gradient on surviving entries is dW * W, reduced
    # to per-row / per-column scalars and pushed through the softmax
    # Jacobian at the assigned group, expert by expert over G.
    dmask = dwc * wc
    s_row = _scatter_rows(dmask.sum(2), plan.row_ids, plan.row_valid, m)
    s_col = _scatter_rows(dmask.sum(1), plan.col_ids, plan.col_valid, n)

    tau = temperature
    soft_ig = torch.softmax(ig / tau, dim=-1)                # (E, M, G)
    pg_row = F.one_hot(plan.row_group, g).to(soft_ig.dtype)
    sel_r = (soft_ig * pg_row).sum(-1, keepdim=True)
    dig = (s_row[..., None] / tau) * sel_r * (pg_row - soft_ig)
    # over G as the last axis: the CPU's softmax over a middle axis
    # rounds by the batch's layout, so one expert of a batch would not be
    # bitwise that expert alone
    soft_og = torch.softmax(og.mT / tau, dim=-1).mT          # (E, G, N)
    pg_col = F.one_hot(plan.col_group, g).mT.to(soft_og.dtype)
    sel_c = (soft_og * pg_col).sum(-2, keepdim=True)
    dog = (s_col[..., None, :] / tau) * sel_c * (pg_col - soft_og)
    return dx, dw, dig.to(ig.dtype), dog.to(og.dtype)


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


def grouped_apply(x: torch.Tensor, w: torch.Tensor, ig: torch.Tensor,
                  og: torch.Tensor, cfg, *, transpose: bool = False,
                  plan: Optional[GroupPlan] = None) -> torch.Tensor:
    """Compact FLGW linear, differentiable in x, W, IG and OG. ``x``:
    (..., M) (or (..., N) when transposed). ``plan`` is the cached
    metadata of the untransposed layer; ``None`` encodes one here.

    Stacked experts: w (E, M, N), ig (E, M, G), og (E, G, N), x (E, ...,
    M) and plan leaves (E, G, cap) run every expert's tiles in one kernel
    launch, and the backward every expert's gradients at once."""
    if transpose:
        w, ig, og = w.mT, og.mT, ig.mT
        plan = transpose_plan(plan) if plan is not None else None
    if plan is None:
        plan = make_plan(ig.detach(), og.detach(), cfg.capacity_slack)
    lead = x.shape[:-1]
    rows = (w.shape[0], -1) if w.dim() == 3 else (-1,)
    y = _GroupedCore.apply(x.reshape(*rows, x.shape[-1]), w, ig, og, plan,
                           cfg.ste_temperature)
    return y.reshape(*lead, -1)
