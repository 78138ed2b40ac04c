"""Projection primitives: the port of ``repro.models.layers``' dense part.

Parameters are plain dicts of tensors (``{"w", "ig", "og"}`` for an FLGW
layer), as in the JAX package, so a param tree converts one to one.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.encoder import PlanState
from repro_torch.core.flgw import FLGWConfig, flgw_linear
from repro_torch.core.grouped import GroupPlan


def dense_init(generator: torch.Generator, m: int, n: int, *,
               flgw: Optional[FLGWConfig] = None) -> dict[str, torch.Tensor]:
    """One float32 projection W: (m, n), N(0, 1/m), drawn from
    ``generator`` on its device, with grouping matrices IG (m, G) and
    OG (G, n) when FLGW is on."""
    dev = generator.device
    params = {"w": torch.randn((m, n), generator=generator, device=dev)
              / m ** 0.5}
    if flgw is not None and flgw.groups > 1:
        params["ig"] = torch.randn((m, flgw.groups), generator=generator,
                                   device=dev)
        params["og"] = torch.randn((flgw.groups, n), generator=generator,
                                   device=dev)
    return params


def proj(p: dict, x: torch.Tensor, flgw: Optional[FLGWConfig] = None, *,
         transpose: bool = False,
         plan: Optional[GroupPlan] = None) -> torch.Tensor:
    """y = x @ W (or x @ W^T), FLGW-masked when grouping params exist.

    ``plan`` is this layer's cached GroupPlan for the grouped path;
    ``None`` re-encodes inside the projection.
    """
    w = p["w"]
    if flgw is None or "ig" not in p:
        return x @ (w.T if transpose else w)
    return flgw_linear(x, w, p["ig"], p["og"], flgw, transpose=transpose,
                       plan=plan)


def plan_of(plans, name: str):
    """Look one entry up in a PlanState or nested plans dict (None when
    absent)."""
    if isinstance(plans, PlanState):
        plans = plans.plans
    if not plans:
        return None
    return plans.get(name)
