"""Layer primitives: the port of ``repro.models.layers``.

Parameters are plain dicts of tensors (``{"w", "ig", "og"}`` for an FLGW
layer), as in the JAX package, so a param tree converts one to one.
Initialisers draw from an explicit ``torch.Generator`` on its device.
Where the JAX initialisers return ``(params, specs)``, the port's return
the params, and a sibling ``*_specs`` function gives the spec tree: the
same nesting with a tuple of *logical* axis names per leaf, consumed by
``repro_torch.sharding.partition``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.encoder import PlanState
from repro_torch.core.flgw import FLGWConfig, flgw_linear, init_grouping
from repro_torch.core.grouped import GroupPlan


# ---------------------------------------------------------------------------
# Dense / FLGW projection
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, m: int, n: int, *,
               flgw: Optional[FLGWConfig] = None,
               dtype: torch.dtype = torch.float32,
               lead: tuple = ()) -> dict[str, torch.Tensor]:
    """One projection W: (*lead, m, n), N(0, 1/m) drawn in float32 and
    cast to ``dtype``, on ``generator``'s device, with float32 grouping
    matrices IG (*lead, m, G) and OG (*lead, G, n) when FLGW is on.
    ``lead`` stacks independent layers (the LM's block axis)."""
    dev = generator.device
    w = torch.randn((*lead, m, n), generator=generator, device=dev) / m ** 0.5
    params = {"w": w.to(dtype)}
    if flgw is not None and flgw.groups > 1:
        params.update(init_grouping(generator, m, n, flgw.groups, lead=lead))
    return params


def dense_specs(axes=("in", "out"), *,
                flgw: Optional[FLGWConfig] = None) -> dict:
    """Spec tree of :func:`dense_init`: W by ``axes``, IG (``axes[0]``,
    None) and OG (None, ``axes[1]``) when FLGW is on."""
    specs = {"w": tuple(axes)}
    if flgw is not None and flgw.groups > 1:
        specs["ig"] = (axes[0], None)
        specs["og"] = (None, axes[1])
    return specs


def proj(p: dict, x: torch.Tensor, flgw: Optional[FLGWConfig] = None, *,
         transpose: bool = False,
         plan: Optional[GroupPlan] = None) -> torch.Tensor:
    """y = x @ W (or x @ W^T), FLGW-masked when grouping params exist.
    Stacked expert params (W (E, M, N)) pass straight through: x (E, C,
    M) gives (E, C, N).

    ``plan`` is this layer's cached GroupPlan for the grouped path;
    ``None`` re-encodes inside the projection.
    """
    w = p["w"]
    if flgw is None or "ig" not in p:
        return x @ (w.mT if transpose else w)
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


# ---------------------------------------------------------------------------
# Norms / activations / embeddings
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, *, device=None, lead: tuple = ()) -> dict:
    return {"scale": torch.zeros((*lead, d), dtype=torch.float32,
                                 device=device)}


def rmsnorm_specs() -> dict:
    return {"scale": (None,)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Gemma RMSNorm: normalised in float32, scaled by ``1 + scale``."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf * (1.0 + p["scale"])).to(x.dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype = torch.bfloat16) -> dict:
    e = torch.randn((vocab, d), generator=generator,
                    device=generator.device) * 0.02
    return {"embedding": e.to(dtype)}


def embed_specs() -> dict:
    return {"embedding": ("vocab", "embed")}


def embed(p: dict, tokens: torch.Tensor, d_model: int) -> torch.Tensor:
    """Gemma-style lookup scaled by sqrt(d), the factor cast to the
    embedding's dtype first (as the JAX package does)."""
    e = p["embedding"]
    return e[tokens] * torch.tensor(d_model ** 0.5, dtype=e.dtype,
                                    device=e.device)


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["embedding"].T


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap > 0 else x


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) integer."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs               # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (FLGW-capable)
# ---------------------------------------------------------------------------

def mlp_init(generator: torch.Generator, d: int, ff: int, *,
             gated: bool = True, flgw: Optional[FLGWConfig] = None,
             dtype: torch.dtype = torch.bfloat16, lead: tuple = ()) -> dict:
    params = {"up": dense_init(generator, d, ff, flgw=flgw, dtype=dtype,
                               lead=lead)}
    if gated:
        params["gate"] = dense_init(generator, d, ff, flgw=flgw, dtype=dtype,
                                    lead=lead)
    params["down"] = dense_init(generator, ff, d, flgw=flgw, dtype=dtype,
                                lead=lead)
    return params


def mlp_specs(*, gated: bool = True,
              flgw: Optional[FLGWConfig] = None) -> dict:
    """Spec tree of :func:`mlp_init`: ``up``/``gate`` ("embed", "ffn"),
    ``down`` ("ffn", "embed")."""
    specs = {"up": dense_specs(("embed", "ffn"), flgw=flgw)}
    if gated:
        specs["gate"] = dense_specs(("embed", "ffn"), flgw=flgw)
    specs["down"] = dense_specs(("ffn", "embed"), flgw=flgw)
    return specs


def mlp(p: dict, x: torch.Tensor, flgw: Optional[FLGWConfig] = None,
        plans=None) -> torch.Tensor:
    """GeGLU MLP. ``jax.nn.gelu`` defaults to the tanh approximation, so
    this uses it too."""
    up = proj(p["up"], x, flgw, plan=plan_of(plans, "up"))
    if "gate" in p:
        gate = proj(p["gate"], x, flgw, plan=plan_of(plans, "gate"))
        up = F.gelu(gate, approximate="tanh") * up
    else:
        up = F.gelu(up, approximate="tanh")
    return proj(p["down"], up, flgw, plan=plan_of(plans, "down"))
