"""Sequence-chunked cross-entropy.

Port of ``repro.train.loss``. At a 256k vocabulary the full (B, S, V)
logits never exist: the loss walks the sequence in chunks, each chunk
unembeds, applies the softcap and reduces to a scalar NLL under its own
``torch.utils.checkpoint``, so the backward recomputes it and one
(B, chunk, V) float32 tile (and its gradient) is live at a time.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import softcap


def _pick_chunk(s: int, pref: int = 512) -> int:
    """The largest divisor of ``s`` that is <= pref (or ``s``)."""
    if s <= pref:
        return s
    for c in range(pref, 0, -1):
        if s % c == 0:
            return c
    return s


def _chunk_nll(x: torch.Tensor, targets: torch.Tensor,
               embedding: torch.Tensor, logit_softcap: float) -> torch.Tensor:
    """Summed NLL of one (B, C) chunk. The JAX package takes the product
    in float32 from bf16 operands; here a bf16 model's product comes out
    of the GEMM in bf16 (float32 accumulation) and is widened, one bf16
    rounding of the logits more."""
    logits = softcap((x @ embedding.T).float(), logit_softcap)
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, targets[..., None]).squeeze(-1)
    return (logz - ll).sum()


def chunked_cross_entropy(hidden: torch.Tensor, embedding: torch.Tensor,
                          targets: torch.Tensor, *,
                          logit_softcap: float = 0.0,
                          chunk: int = 512) -> torch.Tensor:
    """Mean next-token NLL. hidden (B, S, D); embedding (V, D); targets
    (B, S) integer. Gradients flow to both hidden and embedding."""
    b, s, _ = hidden.shape
    chunk = _pick_chunk(s, chunk)
    targets = targets.long()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        total = total + checkpoint(
            _chunk_nll, hidden[:, c0:c0 + chunk], targets[:, c0:c0 + chunk],
            embedding, logit_softcap, use_reentrant=False)
    return total / (b * s)
