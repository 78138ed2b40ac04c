"""Mamba2 (SSD, state-space duality) mixer layer.

Port of ``repro.models.ssm``. A prefill runs the chunked SSD algorithm:
within a chunk the quadratic, attention-like form as batched matmuls;
across chunks a Python loop (``lax.scan`` in JAX) carries the (B, H, P,
N) float32 state. A decode step is one O(1) state update per token,
written into the cache's buffers in place, as the KV path's ring
buffers are.

Layout: heads H = d_inner / head_dim (P = head_dim), state width N, one
B/C group shared across heads (n_groups = 1, as mamba2-1.3b). The SSD
scan is XLA einsums in the JAX package, outside any Pallas kernel, so
it is plain PyTorch here on both devices; the ``in`` and ``out``
projections go through ``proj`` (the FLGW target ``"ssm"``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.flgw import FLGWConfig
from repro_torch.models.layers import (dense_init, dense_specs, plan_of, proj,
                                       rmsnorm)


def ssm_init(generator: torch.Generator, cfg, *,
             flgw: Optional[FLGWConfig] = None, lead: tuple = ()) -> dict:
    """The JAX package's ``ssm_init`` tree (:func:`ssm_specs` its specs):
    ``in`` (d, 2·d_inner + 2N + H) and ``out`` (d_inner, d) projections
    in ``cfg.dtype`` (with IG/OG when FLGW is on), the depthwise
    ``conv_w`` (W, d_inner + 2N) N(0, 0.2²) in ``cfg.dtype``, and the
    float32 ``A_log`` (log of 1..16 spaced over the heads), ``D`` (ones),
    ``dt_bias`` (zeros) and the gated norm's ``scale`` (zeros). ``lead``
    stacks independent layers."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dev = generator.device
    # in_proj -> [z (di), xBC (di + 2N), dt (H)]
    p = {"in": dense_init(generator, d, 2 * di + 2 * n + h, flgw=flgw,
                          dtype=cfg.dtype, lead=lead),
         "out": dense_init(generator, di, d, flgw=flgw, dtype=cfg.dtype,
                           lead=lead)}
    p["conv_w"] = (torch.randn((*lead, cfg.conv_width, di + 2 * n),
                               generator=generator, device=dev) * 0.2
                   ).to(cfg.dtype)
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
    p["A_log"] = a_log.expand(*lead, h).clone()
    p["D"] = torch.ones((*lead, h), device=dev)
    p["dt_bias"] = torch.zeros((*lead, h), device=dev)
    p["norm"] = {"scale": torch.zeros((*lead, di), device=dev)}
    return p


def ssm_specs(*, flgw: Optional[FLGWConfig] = None) -> dict:
    """Spec tree of :func:`ssm_init`."""
    return {"in": dense_specs(("embed", "ffn"), flgw=flgw),
            "out": dense_specs(("ffn", "embed"), flgw=flgw),
            "conv_w": (None, "ffn"), "A_log": ("heads",), "D": ("heads",),
            "dt_bias": ("heads",), "norm": {"scale": (None,)}}


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, x (B, S, C), w (W, C), in x's dtype."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + xp[:, i:i + s] * w[i]
    return out


def _ssd_chunked(xh: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
                 dt: torch.Tensor, a_neg: torch.Tensor,
                 chunk: int) -> torch.Tensor:
    """Chunked SSD scan. xh (B, S, H, P); bm, cm (B, S, N) float32; dt
    (B, S, H) float32; a_neg (H,) negative. Returns y (B, S, H, P) in
    xh's dtype. ``chunk`` must divide S.

    The four-operand einsum ``blm,blmh,bmh,bmhp->blhp`` of the JAX
    package runs as an (L x L) weight per (b, h) times (L x P): in
    argument order it would build a (B, L, L, H, P) intermediate, 8.6 GB
    a chunk at jamba-1.5-large's width (H 128, P 128, L 256) at B = 2.
    """
    b, s, h, p = xh.shape
    n = bm.shape[-1]
    if s % chunk:
        raise ValueError(f"the SSD chunk {chunk} must divide S = {s}")
    li = torch.arange(chunk, device=xh.device)
    causal = (li[:, None] >= li[None, :])[None, :, :, None]   # (1, L, L, 1)
    hstate = xh.new_zeros((b, h, p, n), dtype=torch.float32)
    ys = []
    for i in range(0, s, chunk):
        x_i = xh[:, i:i + chunk].float()                      # (B, L, H, P)
        b_i, c_i, dt_i = bm[:, i:i + chunk], cm[:, i:i + chunk], \
            dt[:, i:i + chunk]
        cs = torch.cumsum(dt_i * a_neg, dim=1)                # (B, L, H)
        # off-diagonal: the incoming state's contribution
        y_off = (c_i @ hstate.reshape(b, h * p, n).mT).view(
            b, chunk, h, p) * torch.exp(cs)[..., None]
        # within the chunk: the quadratic form. The mask goes before the
        # exp: seg is positive above the diagonal, where exp overflows to
        # inf, and the reference's where(causal, exp(seg), 0)
        # (src/repro/models/ssm.py:89) then multiplies a zero cotangent
        # by inf, a NaN gradient. exp(-inf) is 0, the same forward, and
        # its gradient is finite.
        seg = cs[:, :, None, :] - cs[:, None, :, :]           # (B, L, L, H)
        decay = torch.exp(seg.masked_fill(~causal, float("-inf")))
        wgt = (c_i @ b_i.mT)[..., None] * decay * dt_i[:, None]   # blmh
        y_diag = (wgt.permute(0, 3, 1, 2) @ x_i.transpose(1, 2)
                  ).transpose(1, 2)                           # (B, L, H, P)
        # state update: h' = exp(sum a) h + sum_t exp(cs_end - cs_t) dt B x
        u = (dt_i * torch.exp(cs[:, -1:] - cs))[..., None] * x_i
        dbx = (u.permute(0, 2, 3, 1).reshape(b, h * p, chunk) @ b_i).view(
            b, h, p, n)
        hstate = hstate * torch.exp(cs[:, -1])[..., None, None] + dbx
        ys.append((y_off + y_diag).to(xh.dtype))
    return torch.cat(ys, dim=1)


def ssm_step(hstate: torch.Tensor, x_t: torch.Tensor, b_t: torch.Tensor,
             c_t: torch.Tensor, dt_t: torch.Tensor, a_neg: torch.Tensor):
    """One decode step. hstate (B, H, P, N) float32; x_t (B, H, P); b_t,
    c_t (B, N) float32; dt_t (B, H). Returns (new state, y_t (B, H, P)
    in x_t's dtype)."""
    decay = torch.exp(dt_t * a_neg)                           # (B, H)
    dbx = (dt_t[..., None] * x_t.float())[..., None] * b_t[:, None, None]
    hstate = hstate * decay[..., None, None] + dbx
    y = (hstate @ c_t[:, None, :, None])[..., 0]              # (B, H, P)
    return hstate, y.to(x_t.dtype)


def ssm(p: dict, x: torch.Tensor, cfg, *, cache: Optional[dict] = None,
        chunk: int = 256, flgw: Optional[FLGWConfig] = None,
        plans=None) -> torch.Tensor:
    """Mamba2 block, x (B, S, d) -> (B, S, d).

    ``cache``: ``{"state": (B, H, P, N) float32, "conv": (B, W-1,
    d_inner + 2N)}``, one decode step (S = 1) written into both in place;
    None runs the chunked prefill over ``min(chunk, S)``-token chunks.
    ``plans``: this layer's entry of a cached PlanState, GroupPlans for
    the ``in``/``out`` projections (None: the grouped path encodes per
    call)."""
    b, s, _ = x.shape
    di, n, h, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = proj(p["in"], x, flgw, plan=plan_of(plans, "in"))
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * n, h], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])                # (B, S, H)
    a_neg = -torch.exp(p["A_log"])                            # (H,)

    if cache is None:
        xbc = F.silu(_causal_conv(xbc, p["conv_w"]))
        xh, bm, cm = torch.split(xbc, [di, n, n], dim=-1)
        xh = xh.reshape(b, s, h, hd)
        y = _ssd_chunked(xh, bm.float(), cm.float(), dt, a_neg,
                         min(chunk, s))
    else:
        if s != 1:
            raise ValueError(f"an SSM decode step takes one token (got {s}); "
                             "a prompt goes through the cache-free prefill "
                             "or one token a step")
        # the conv ring and an O(1) state update
        window = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)], 1)
        xbc_t = F.silu(torch.einsum(
            "bwc,wc->bc", window.float(), p["conv_w"].float()
        ).to(xbc.dtype))
        xh, bm, cm = torch.split(xbc_t, [di, n, n], dim=-1)
        xh = xh.reshape(b, h, hd)
        hstate, y = ssm_step(cache["state"], xh, bm.float(), cm.float(),
                             dt[:, 0], a_neg)
        cache["state"].copy_(hstate)
        cache["conv"].copy_(window[:, 1:])
        y, xh = y[:, None], xh[:, None]                       # (B, 1, H, P)

    y = y + (p["D"][:, None] * xh.float()).to(y.dtype)
    y = y.reshape(b, s, di)
    y = rmsnorm(p["norm"], y * F.silu(z.float()).to(y.dtype))
    return proj(p["out"], y, flgw, plan=plan_of(plans, "out"))
