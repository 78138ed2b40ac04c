"""Plain PyTorch version of the flash-attention forward kernel.

The same semantics as the CUDA kernel and as the TPU kernel it replaces:
GQA (q heads grouped onto kv heads), causal and/or sliding-window masks
by absolute positions starting at 0, the gemma-style logit softcap, f32
math, the output in the query dtype and an f32 logsumexp. A row with no
allowed key gives output 0 and lse ``NEG_INF`` (the kernels' ``l = 0``
flush). It materialises the (S, T) logits, so it is the CPU path and the
oracle, never the card's.
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
