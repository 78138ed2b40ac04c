"""Plain PyTorch version of the grouped batched-matmul kernel."""
from __future__ import annotations

import torch


def ref_grouped_bmm(xg: torch.Tensor, wc: torch.Tensor) -> torch.Tensor:
    """(G, B, capM) @ (G, capM, capN) -> (G, B, capN), f32 accumulation."""
    return torch.einsum("gbm,gmn->gbn", xg.float(), wc.float()).to(xg.dtype)
