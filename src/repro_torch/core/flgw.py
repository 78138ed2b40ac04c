"""Fully Learnable Weight Grouping (FLGW).

Port of ``repro.core.flgw``. A layer ``W (M, N)`` carries grouping
matrices ``IG (M, G)`` and ``OG (G, N)``; ``Mask[i, j] == 1`` iff
``argmax(IG[i]) == argmax(OG[:, j])`` (OSEL observation 1), so two index
vectors determine the mask.

Execution paths: ``masked`` computes ``x @ (W * Mask)`` at full FLOPs and
is the numerical oracle; ``grouped`` permutes rows and columns by group
and runs G dense compact tiles (``repro_torch.core.grouped``). Both train
IG and OG through a straight-through estimator: the hard one-hot
selection forward, its softmax surrogate backward (:func:`mask_ste` here,
the sparse-restricted form in ``grouped``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class FLGWConfig:
    """Static configuration of one FLGW-pruned linear layer."""

    groups: int = 1                 # G; G == 1 => dense (no pruning)
    path: str = "masked"            # "dense" | "masked" | "grouped"
    ste_temperature: float = 1.0    # softmax temperature of the STE surrogate
    capacity_slack: float = 1.25    # grouped path: per-group capacity slack

    @property
    def enabled(self) -> bool:
        return self.groups > 1 and self.path != "dense"

    @property
    def avg_sparsity(self) -> float:
        return 0.0 if self.groups <= 1 else 1.0 - 1.0 / self.groups


def init_grouping(generator: torch.Generator, m: int, n: int, groups: int,
                  *, lead: tuple = ()) -> dict[str, torch.Tensor]:
    """Random init of the grouping matrices (paper: 'initialized
    randomly'): IG (*lead, m, G) then OG (*lead, G, n), float32 N(0, 1)
    draws from ``generator`` on its device. ``lead`` stacks independent
    layers. Where JAX splits a key, the two draws come one after the
    other from the one generator."""
    dev = generator.device
    return {"ig": torch.randn((*lead, m, groups), generator=generator,
                              device=dev),
            "og": torch.randn((*lead, groups, n), generator=generator,
                              device=dev)}


def grouping_indices(ig: torch.Tensor, og: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(ig_idx, og_idx)``: argmax of each IG row / OG column (int64).
    Ties go to the first index, as in ``jnp.argmax``."""
    return ig.argmax(-1), og.argmax(-2)


def mask_from_indices(ig_idx: torch.Tensor, og_idx: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
    """Mask[i, j] = (ig_idx[i] == og_idx[j]) -- O(MN) compares."""
    return (ig_idx[:, None] == og_idx[None, :]).to(dtype)


def selection_matrices(ig: torch.Tensor, og: torch.Tensor,
                       temperature: float = 1.0
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Straight-through IS (..., M, G) and OS (..., G, N): the hard
    one-hot argmax selection forward, the gradient of the temperature
    softmax backward (``soft + (hard - soft).detach()``). Leading dims
    (stacked experts) batch, as JAX's vmap does."""
    g = ig.shape[-1]
    is_soft = torch.softmax(ig / temperature, dim=-1)
    is_hard = F.one_hot(ig.argmax(-1), g).to(ig.dtype)
    is_mat = is_soft + (is_hard - is_soft).detach()
    os_soft = torch.softmax(og / temperature, dim=-2)
    os_hard = F.one_hot(og.argmax(-2), g).transpose(-1, -2).to(og.dtype)
    os_mat = os_soft + (os_hard - os_soft).detach()
    return is_mat, os_mat


def mask_ste(ig: torch.Tensor, og: torch.Tensor,
             temperature: float = 1.0) -> torch.Tensor:
    """Differentiable mask: forward equals :func:`mask_from_indices`,
    backward through the softmax surrogates."""
    is_mat, os_mat = selection_matrices(ig, og, temperature)
    return is_mat @ os_mat


def flgw_linear(x: torch.Tensor, w: torch.Tensor, ig: torch.Tensor,
                og: torch.Tensor, cfg: FLGWConfig, *, transpose: bool = False,
                plan=None) -> torch.Tensor:
    """``y = x @ (W * Mask)`` (or ``x @ (W * Mask)^T`` when transposed),
    differentiable in x, W, IG and OG. Stacked experts (W (E, M, N),
    IG (E, M, G), OG (E, G, N), x (E, ..., M)) give (E, ..., N).

    ``plan`` is the layer's cached ``GroupPlan`` for the grouped path;
    ``None`` re-derives it per call.
    """
    if not cfg.enabled:
        return x @ (w.mT if transpose else w)
    if cfg.path == "masked":
        wm = w * mask_ste(ig, og, cfg.ste_temperature).to(w.dtype)
        return x @ (wm.mT if transpose else wm)
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
