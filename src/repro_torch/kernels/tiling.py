"""Tile-size arithmetic shared by the kernel wrappers.

A copy of the integer helpers of ``repro.kernels.tiling`` (the port
imports nothing of ``repro``); the tests hold the two copies equal.
"""
from __future__ import annotations

# Default plan_encode placement tile (items per tile side).
DEFAULT_PLAN_BLOCK = 512


def round_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``x``."""
    return (x + m - 1) // m * m


def plan_block(m: int, block: int | None = None) -> int:
    """plan_encode placement tile rule (items per rank/place block)."""
    return block if block else min(DEFAULT_PLAN_BLOCK, round_up(m, 128))


def compute_cap(m: int, g: int, slack: float = 1.0) -> int:
    """Static per-group capacity: ``ceil(m/g)``, stretched by ``slack``."""
    cap = max(1, -(-m // g))
    return min(m, int(-(-cap * slack // 1))) if slack > 1.0 else cap
