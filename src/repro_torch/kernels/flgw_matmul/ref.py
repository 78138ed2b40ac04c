"""Plain PyTorch versions of the compact FLGW matmul kernels."""
from __future__ import annotations

import torch


def ref_grouped_bmm(xg: torch.Tensor, wc: torch.Tensor) -> torch.Tensor:
    """(G, B, capM) @ (G, capM, capN) -> (G, B, capN), f32 accumulation."""
    return torch.einsum("gbm,gmn->gbn", xg.float(), wc.float()).to(xg.dtype)


def ref_fused_bmm(xt: torch.Tensor, wc: torch.Tensor,
                  ids: torch.Tensor) -> torch.Tensor:
    """(M+1, B) xt (the activations transposed) gathered by (G, capM)
    ids, times (G, capM, capN) wc -> (G, B, capN) in xt's dtype, f32
    accumulation. Row M of xt is the zero sink that invalid slots point
    at."""
    xg = xt[ids.long()]                                     # (G, capM, B)
    return torch.einsum("gmb,gmn->gbn", xg.float(), wc.float()).to(xt.dtype)
