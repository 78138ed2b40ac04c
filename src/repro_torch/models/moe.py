"""Token-choice top-k Mixture-of-Experts with capacity-bounded dispatch.

Port of ``repro.models.moe``. Gather-based dispatch (no (T, E, C)
one-hot tensors): sort the token assignments by expert, keep the first
``capacity`` of each expert, run every expert's gated FFN at once on the
stacked (E, ...) weights, and combine with the router weights.

On the FLGW grouped path each of the three expert projections is one
compact product over all E experts (``core.grouped.grouped_apply`` with a
leading expert axis): one ``fused_bmm`` launch when the plans carry
compact weights (serving), else one ``grouped_bmm`` launch. This is the
counterpart of the JAX package's vmap of ``proj`` over the experts,
which folds the expert axis into the Pallas kernels' grids. Every path
trains through autograd; the grouped backward takes all experts' tiles
at once (``core.grouped._grouped_bwd``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.flgw import FLGWConfig, init_grouping
from repro_torch.models.layers import plan_of, proj
from repro_torch.sharding import collectives


def _expert_weights(generator: torch.Generator, lead: tuple, e: int, m: int,
                    n: int, dtype: torch.dtype) -> torch.Tensor:
    """(*lead, e, m, n) weights N(0, 1/m) in ``dtype``, drawn in float32
    one (m, n) matrix at a time: a whole float32 (E, m, n) temporary
    would be 12.9 GB for mixtral's experts."""
    w = torch.empty((*lead, e, m, n), dtype=dtype, device=generator.device)
    for mat in w.view(-1, m, n):
        mat.copy_(torch.randn((m, n), generator=generator,
                              device=generator.device) / m ** 0.5)
    return w


def moe_init(generator: torch.Generator, cfg, *,
             flgw: Optional[FLGWConfig] = None, lead: tuple = ()) -> dict:
    """Router (*lead, d, E) float32 N(0, 1/d); stacked expert FFNs ``up``
    and ``gate`` (*lead, E, d, ff) and ``down`` (*lead, E, ff, d) in
    ``cfg.dtype``; with FLGW, each expert projection's own IG/OG
    (``init_grouping`` with the expert axis in ``lead``). The tree is the
    JAX package's ``moe_init``; :func:`moe_specs` gives its specs."""
    d = cfg.d_model
    ff = cfg.moe_d_ff or cfg.d_ff
    e = cfg.n_experts
    dev = generator.device
    params = {
        "router": torch.randn((*lead, d, e), generator=generator,
                              device=dev) / d ** 0.5,
        "up": {"w": _expert_weights(generator, lead, e, d, ff, cfg.dtype)},
        "gate": {"w": _expert_weights(generator, lead, e, d, ff, cfg.dtype)},
        "down": {"w": _expert_weights(generator, lead, e, ff, d, cfg.dtype)},
    }
    if flgw is not None and flgw.groups > 1:
        for name, (m, n) in (("up", (d, ff)), ("gate", (d, ff)),
                             ("down", (ff, d))):
            params[name].update(init_grouping(generator, m, n, flgw.groups,
                                              lead=(*lead, e)))
    return params


def moe_specs(*, flgw: Optional[FLGWConfig] = None) -> dict:
    """Spec tree of :func:`moe_init`: the expert axis leads every expert
    leaf (``"expert"``, replicated: the inner dims carry the sharding)."""
    specs = {"router": ("embed", None),
             "up": {"w": ("expert", "embed", "ffn")},
             "gate": {"w": ("expert", "embed", "ffn")},
             "down": {"w": ("expert", "ffn", "embed")}}
    if flgw is not None and flgw.groups > 1:
        for name, (m, n) in (("up", ("embed", "ffn")),
                             ("gate", ("embed", "ffn")),
                             ("down", ("ffn", "embed"))):
            specs[name]["ig"] = ("expert", m, None)
            specs[name]["og"] = ("expert", None, n)
    return specs


def _expert_ffn(p: dict, xe: torch.Tensor, flgw: Optional[FLGWConfig],
                plans=None) -> torch.Tensor:
    """xe (E, C, d) -> (E, C, d), each expert's GeGLU FFN. ``plans``: the
    layer's ``up``/``gate``/``down`` GroupPlans, stacked (E, ...)."""
    if flgw is not None and flgw.enabled and "ig" in p["up"]:
        up = proj(p["up"], xe, flgw, plan=plan_of(plans, "up"))
        up = F.gelu(proj(p["gate"], xe, flgw, plan=plan_of(plans, "gate")),
                    approximate="tanh") * up
        return proj(p["down"], up, flgw, plan=plan_of(plans, "down"))
    up = torch.matmul(xe, p["up"]["w"])
    gate = F.gelu(torch.matmul(xe, p["gate"]["w"]), approximate="tanh")
    return torch.matmul(up * gate, p["down"]["w"])


def capacity(t: int, cfg, dropless: bool) -> int:
    """Rows each expert computes for ``t`` tokens: ``t * top_k`` when
    dropless, else ``round(t * k / E * capacity_factor)`` (Python's
    round, half to even, on Python floats as the JAX package computes
    it), at least 1 and at most t."""
    k = cfg.top_k
    if dropless:
        return t * k
    return min(int(max(1, round(t * k / cfg.n_experts
                                * cfg.capacity_factor))), t)


def moe(p: dict, x: torch.Tensor, cfg, *, flgw: Optional[FLGWConfig] = None,
        dropless: bool = False, plans=None):
    """x (B, S, d) -> (out (B, S, d), aux_loss).

    ``plans``: this layer's entry of a cached PlanState (None: the
    grouped path encodes per call). ``dropless=True`` gives every expert
    t·k rows, so no token is dropped (serving: a dropped token would
    corrupt its sequence's cache); otherwise the dispatch is capacity
    bounded and tokens past an expert's capacity are dropped.
    """
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    xf = x.reshape(t, d)

    logits = xf.float() @ p["router"]                          # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # top-k as jax.lax.top_k: a stable descending sort keeps the lower
    # expert index first on ties (torch.topk promises no order)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_e = top_w[:, :k], top_e[:, :k]
    gate_w = gate_w / gate_w.sum(-1, keepdim=True)

    # load-balancing auxiliary loss (Switch-style); in a mesh step the
    # means are over the global batch, every rank's rows
    me = collectives.batch_mean(probs)
    ce = collectives.batch_mean(F.one_hot(gate_e[:, 0], e).float())
    aux = e * (me * ce).sum()

    # sort the (token, slot) assignments by expert; the first `cap` of each
    # expert's run are kept
    flat_e = gate_e.reshape(-1)                                # (T*k,)
    flat_t = torch.arange(t, device=x.device).repeat_interleave(k)
    flat_w = gate_w.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    pos_in_e = (torch.arange(t * k, device=x.device)
                - torch.searchsorted(se, se, right=False))
    # the capacity bounds an expert's run at `at`; `width`: its slots here
    cap = width = capacity(t, cfg, dropless)
    at = pos_in_e
    _, blocks = collectives.row_block()
    if blocks > 1 and not dropless:
        # in a mesh step, the global batch's run, as the reference's one
        # program bounds it: this rank's rows come after the earlier
        # blocks' assignments to the expert, and fill at most t slots of
        # it (top-k picks distinct experts)
        cap = capacity(t * blocks, cfg, False)
        width = min(cap, t)
        at = pos_in_e + collectives.rows_before(
            torch.zeros(e, dtype=torch.int64, device=x.device)
            .scatter_add_(0, flat_e, torch.ones_like(flat_e)))[se]
    slot = torch.where(at < cap, se * width + pos_in_e, e * width)

    # slot e*width is the drop sink, sliced off
    tok_of_slot = torch.full((e * width + 1,), t, dtype=torch.int64,
                             device=x.device)
    tok_of_slot[slot] = st
    tok_of_slot = tok_of_slot[:-1]                             # (E*C,)
    w_of_slot = torch.zeros(e * width + 1, dtype=torch.float32,
                            device=x.device)
    w_of_slot[slot] = sw
    w_of_slot = w_of_slot[:-1]

    xe = xf[tok_of_slot.clamp(max=t - 1)]
    xe = torch.where((tok_of_slot < t)[:, None], xe, 0).reshape(e, width, d)
    ye = _expert_ffn(p, xe, flgw, plans).reshape(e * width, d)
    ye = ye * w_of_slot[:, None].to(ye.dtype)

    # row t is the sink of the empty slots, sliced off
    out = x.new_zeros((t + 1, d)).index_add_(0, tok_of_slot, ye)[:-1]
    return out.reshape(b, s, d), aux
