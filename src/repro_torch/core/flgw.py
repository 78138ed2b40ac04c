"""Fully Learnable Weight Grouping (FLGW), forward half.

Port of ``repro.core.flgw``. A layer ``W (M, N)`` carries grouping
matrices ``IG (M, G)`` and ``OG (G, N)``; ``Mask[i, j] == 1`` iff
``argmax(IG[i]) == argmax(OG[:, j])`` (OSEL observation 1), so two index
vectors determine the mask.

Execution paths: ``masked`` computes ``x @ (W * Mask)`` at full FLOPs and
is the numerical oracle; ``grouped`` permutes rows and columns by group
and runs G dense compact tiles (``repro_torch.core.grouped``).

Forward only: the straight-through estimator that trains IG/OG is not
ported yet, so both FLGW paths refuse to build a graph.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class FLGWConfig:
    """Static configuration of one FLGW-pruned linear layer."""

    groups: int = 1                 # G; G == 1 => dense (no pruning)
    path: str = "masked"            # "dense" | "masked" | "grouped"
    capacity_slack: float = 1.25    # grouped path: per-group capacity slack

    @property
    def enabled(self) -> bool:
        return self.groups > 1 and self.path != "dense"

    @property
    def avg_sparsity(self) -> float:
        return 0.0 if self.groups <= 1 else 1.0 - 1.0 / self.groups


def forward_only(*tensors: torch.Tensor) -> None:
    """Raise if autograd would record a graph through an FLGW layer: its
    backward (the compact VJP and the IG/OG straight-through estimator)
    is not ported. Run under ``torch.inference_mode()`` or
    ``torch.no_grad()``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "FLGW layers are forward-only in repro_torch: their backward "
            "is not ported yet; call under torch.inference_mode()")


def grouping_indices(ig: torch.Tensor, og: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(ig_idx, og_idx)``: argmax of each IG row / OG column (int64).
    Ties go to the first index, as in ``jnp.argmax``."""
    return ig.argmax(1), og.argmax(0)


def mask_from_indices(ig_idx: torch.Tensor, og_idx: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
    """Mask[i, j] = (ig_idx[i] == og_idx[j]) -- O(MN) compares."""
    return (ig_idx[:, None] == og_idx[None, :]).to(dtype)


def flgw_linear(x: torch.Tensor, w: torch.Tensor, ig: torch.Tensor,
                og: torch.Tensor, cfg: FLGWConfig, *, transpose: bool = False,
                plan=None) -> torch.Tensor:
    """``y = x @ (W * Mask)`` (or ``x @ (W * Mask)^T`` when transposed).

    ``plan`` is the layer's cached ``GroupPlan`` for the grouped path;
    ``None`` re-derives it per call.
    """
    if not cfg.enabled:
        return x @ (w.T if transpose else w)
    if cfg.path == "masked":
        forward_only(x, w, ig, og)
        wm = w * mask_from_indices(*grouping_indices(ig, og), w.dtype)
        return x @ (wm.T if transpose else wm)
    if cfg.path == "grouped":
        from repro_torch.core.grouped import grouped_apply  # avoids a cycle
        return grouped_apply(x, w, ig, og, cfg, transpose=transpose,
                             plan=plan)
    raise ValueError(f"unknown FLGW path {cfg.path!r}")


def mask_sparsity(ig_idx: torch.Tensor, og_idx: torch.Tensor,
                  groups: int) -> torch.Tensor:
    """Actual sparsity of the mask from the two group histograms:
    ``nnz = sum_g rows_g * cols_g``."""
    total = ig_idx.shape[0] * og_idx.shape[0]
    rows = torch.bincount(ig_idx, minlength=groups)[:groups]
    cols = torch.bincount(og_idx, minlength=groups)[:groups]
    return 1.0 - (rows * cols).sum() / total
