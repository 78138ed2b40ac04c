"""Sparsity / group-number schedules over training.

Port of ``repro.core.schedule`` (a copy: the port imports nothing of
``repro``). The paper fixes G per run and regenerates the mask every
iteration; ``refresh_every`` amortises the compact re-planning over k
steps while the grouping matrices still train every step, and
``warmup_steps`` runs dense first.
"""
from __future__ import annotations

import dataclasses

REFRESH_MODES = ("period", "on_change", "hybrid")


@dataclasses.dataclass(frozen=True)
class SparsitySchedule:
    groups: int = 1
    refresh_every: int = 1        # re-derive the mask/plan every k steps
    warmup_steps: int = 0         # run dense for the first k steps
    # Plan-refresh policy (consumed by repro_torch.core.encoder.maybe_refresh):
    #   "period"    -- every refresh_every steps (fixed amortization)
    #   "on_change" -- only when the grouping layout moved (signature)
    #   "hybrid"    -- on change, with refresh_every as a staleness bound
    refresh: str = "period"

    def __post_init__(self):
        if self.refresh not in REFRESH_MODES:
            raise ValueError(
                f"refresh must be one of {REFRESH_MODES}, "
                f"got {self.refresh!r}")

    def groups_at(self, step: int) -> int:
        return 1 if step < self.warmup_steps else self.groups

    def sparse_at(self, step):
        """Is the mask on at ``step``?"""
        return step >= self.warmup_steps

    def refresh_at(self, step: int) -> bool:
        """Fixed-period refresh predicate (``"period"`` mode)."""
        return step % max(1, self.refresh_every) == 0

    @property
    def avg_sparsity(self) -> float:
        return 0.0 if self.groups <= 1 else 1.0 - 1.0 / self.groups
