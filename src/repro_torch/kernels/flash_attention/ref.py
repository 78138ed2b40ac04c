"""Plain PyTorch versions of the flash-attention kernels.

The same semantics as the CUDA kernels and as the TPU kernels they replace:
GQA (q heads grouped onto kv heads), causal and/or sliding-window masks
by absolute positions starting at 0, the gemma-style logit softcap, f32
math, the output in the query dtype and an f32 logsumexp. A row with no
allowed key gives output 0 and lse ``NEG_INF`` (the kernels' ``l = 0``
flush). The backward recomputes ``p`` from the forward's ``lse`` and
differentiates the softcap exactly, as ``_recompute_p_dz`` of the TPU
kernels. They materialise the (S, T) logits, so they are the CPU path and
the oracle, never the card's.
"""
from __future__ import annotations

import torch

NEG_INF = -2.3819763e38


def allowed_mask(s: int, t: int, *, causal: bool, window: int,
                 device=None) -> torch.Tensor:
    """(S, T) bool: query i may attend key j."""
    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(t, device=device)[None, :]
    allowed = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        allowed &= kpos <= qpos
    if window > 0:
        allowed &= kpos > qpos - window
    return allowed


def ref_flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, softcap: float = 0.0
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """q: (B, Hq, S, D); k/v: (B, Hkv, T, D) -> (out (B, Hq, S, D) in q's
    dtype, lse (B, Hq, S) float32); logits scaled by D ** -0.5."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    qpk = hq // hkv
    scale = d ** -0.5
    qg = q.reshape(b, hkv, qpk, s, d).float()
    z = torch.einsum("bgqsd,bgtd->bgqst", qg, k.float()) * scale
    if softcap > 0:
        z = torch.tanh(z / softcap) * softcap
    allowed = allowed_mask(s, t, causal=causal, window=window,
                           device=q.device)
    z = torch.where(allowed, z, NEG_INF)
    m = z.amax(-1, keepdim=True)
    p = torch.where(allowed, torch.exp(z - m), 0.0)
    l = p.sum(-1)
    l_safe = torch.where(l == 0, 1.0, l)
    out = torch.einsum("bgqst,bgtd->bgqsd", p, v.float()) / l_safe[..., None]
    lse = torch.where(l == 0, NEG_INF, m[..., 0] + torch.log(l_safe))
    return (out.reshape(b, hq, s, d).to(q.dtype),
            lse.reshape(b, hq, s))


def delta_of(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """(B, Hq, S) float32 ``sum(do * out)`` per query row: the backward's
    row term, computed outside the kernels as the TPU wrapper does."""
    return (do.float() * out.float()).sum(-1)


def ref_flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                  causal: bool = True, window: int = 0, softcap: float = 0.0
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of :func:`ref_flash_fwd`'s ``out`` given its cotangent
    ``do``: (dq, dk, dv) in q's, k's and v's dtypes, f32 math. ``p =
    exp(z - lse)`` is recomputed and masked to 0; ``dz = p (do.v -
    delta)``, times ``1 - tanh(z_raw / softcap)^2`` under the softcap; dk
    and dv sum over the q heads of each kv head."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    qpk = hq // hkv
    scale = d ** -0.5
    qg = q.reshape(b, hkv, qpk, s, d).float()
    dog = do.reshape(b, hkv, qpk, s, d).float()
    kf, vf = k.float(), v.float()
    z_raw = torch.einsum("bgqsd,bgtd->bgqst", qg, kf) * scale
    z = torch.tanh(z_raw / softcap) * softcap if softcap > 0 else z_raw
    allowed = allowed_mask(s, t, causal=causal, window=window,
                           device=q.device)
    lse_g = lse.reshape(b, hkv, qpk, s, 1)
    p = torch.where(allowed, torch.exp(torch.where(allowed, z, NEG_INF)
                                       - lse_g), 0.0)
    delta = delta_of(out, do).reshape(b, hkv, qpk, s, 1)
    dp = torch.einsum("bgqsd,bgtd->bgqst", dog, vf)
    dz = p * (dp - delta)
    if softcap > 0:
        dz = dz * (1.0 - torch.tanh(z_raw / softcap).square())
    dq = torch.einsum("bgqst,bgtd->bgqsd", dz, kf) * scale
    dk = torch.einsum("bgqst,bgqsd->bgtd", dz, qg) * scale
    dv = torch.einsum("bgqst,bgqsd->bgtd", p, dog)
    return (dq.reshape(b, hq, s, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
