"""Traffic Junction, 4-way variant, batched over B environments.

Port of ``repro.marl.envs.traffic_junction_4way``: two two-lane roads
cross in the middle of a ``size x size`` grid (``size`` even), giving
four entry arms; each car takes one of three turns at the junction
(right, straight, left), 12 routes in all, several of which curve through
the shared 2x2 intersection. Right-hand traffic fixes the lanes
(``m = size // 2``): eastbound row ``m``, westbound row ``m - 1``,
southbound column ``m - 1``, northbound column ``m``.

Route geometry is static: arm 0 (from the west) is written out and arms
1-3 follow by 90-degree rotations into a cached ``(12, Lmax, 2)`` cell
table plus per-route lengths (numpy, a copy of the JAX module's). Cars
are ``(route, progress)`` indices into that table. Arrivals follow the
hard variant's Geometric(``p_arrive``) stream; dynamics, rewards and the
success criterion mirror :mod:`~repro_torch.marl.envs.traffic_junction`,
whose ``EnvState`` is reused unchanged.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.marl.envs.traffic_junction import (
    EnvState, _collisions, _finish, _fresh, _one_hot, arrival_stream,
    occupancy_window, success)

__all__ = ["EnvConfig", "EnvState", "reset", "step", "observe", "success",
           "obs_dim", "n_actions", "positions", "active"]

N_ACTIONS = 2   # 0 = brake, 1 = gas
N_ROUTES = 12   # 4 arms x {right, straight, left}


class EnvConfig(NamedTuple):
    n_agents: int = 6
    size: int = 8                     # even; roads are 2 lanes wide
    vision: int = 1
    max_steps: int = 40
    time_penalty: float = -0.01
    collision_penalty: float = -1.0
    p_arrive: float = 0.5             # per-step arrival probability


@lru_cache(maxsize=None)
def _route_table(size: int) -> tuple[np.ndarray, np.ndarray]:
    """Static route geometry: (12, Lmax, 2) int32 cells + (12,) lengths.

    Routes are ordered ``arm * 3 + turn`` with arms enumerated by
    successive clockwise rotations starting from the west (0 = west,
    1 = north, 2 = east, 3 = south) and turns (0 = right, 1 = straight,
    2 = left). Paths shorter than ``Lmax`` are padded with their exit
    cell, so clipping ``prog`` into the table always lands on-route.
    """
    if size % 2 or size < 4:
        raise ValueError(f"4-way junction needs an even size >= 4, "
                         f"got {size}")
    m = size // 2
    east = [(m, c) for c in range(size)]                   # straight
    # right turn: leave the eastbound lane at (m, m-1), merge onto the
    # southbound lane (col m-1) just past the intersection
    right = east[:m] + [(r, m - 1) for r in range(m + 1, size)]
    # left turn: cross to (m, m), then up the northbound lane (col m)
    left = east[:m + 1] + [(r, m) for r in range(m - 1, -1, -1)]

    def rot(path):   # 90 degrees clockwise: west -> north -> east -> south
        return [(c, size - 1 - r) for r, c in path]

    routes, arm = [], [right, east, left]
    for _ in range(4):
        routes.extend(arm)
        arm = [rot(p) for p in arm]
    lmax = max(len(p) for p in routes)
    table = np.stack([np.asarray(p + [p[-1]] * (lmax - len(p)), np.int32)
                      for p in routes])
    lens = np.asarray([len(p) for p in routes], np.int32)
    return table, lens


def _lmax(cfg: EnvConfig) -> int:
    return cfg.size + 1          # the left turn: m+1 cells in, m cells out


def obs_dim(cfg: EnvConfig) -> int:
    # route one-hot (12) + progress one-hot (Lmax+1) + on-road flag
    # + occupancy window of the other cars ((2v+1)^2)
    return N_ROUTES + _lmax(cfg) + 1 + 1 + (2 * cfg.vision + 1) ** 2


def n_actions(cfg: EnvConfig) -> int:
    return N_ACTIONS


def _route_len(route: torch.Tensor, cfg: EnvConfig) -> torch.Tensor:
    _, lens = _route_table(cfg.size)
    return torch.as_tensor(lens, device=route.device).long()[route]


def positions(state: EnvState, cfg: EnvConfig) -> torch.Tensor:
    """(B, A, 2) grid cells; exited cars clip to their exit cell."""
    table, _ = _route_table(cfg.size)
    tbl = torch.as_tensor(table, device=state.route.device).long()
    return tbl[state.route, state.prog.clamp(0, tbl.shape[1] - 1)]


def active(state: EnvState, cfg: EnvConfig) -> torch.Tensor:
    """(B, A) bool -- entered and not yet past the end of its route."""
    return (state.t[:, None] >= state.enter_t) & \
        (state.prog < _route_len(state.route, cfg))


def reset(generator: torch.Generator, cfg: EnvConfig,
          batch: int) -> EnvState:
    """B fresh episodes drawn from ``generator``, on its device: uniform
    routes and a Geometric(p_arrive) arrival stream."""
    a = cfg.n_agents
    route = torch.randint(0, N_ROUTES, (batch, a), generator=generator,
                          device=generator.device)
    enter_t = arrival_stream(generator, batch, a, cfg.p_arrive,
                             cfg.max_steps - _lmax(cfg) - 1)
    return _fresh(route, enter_t)


def observe(state: EnvState, cfg: EnvConfig) -> torch.Tensor:
    """(B, A, obs_dim) float32 observations."""
    act = active(state, cfg)
    pos = positions(state, cfg)
    lmax = _lmax(cfg)
    route_oh = _one_hot(state.route, N_ROUTES)
    prog_oh = _one_hot(state.prog.clamp(0, lmax), lmax + 1)
    occ = occupancy_window(pos, act, cfg.vision)
    return torch.cat([route_oh, prog_oh, act[..., None].float(), occ], -1)


def step(state: EnvState, actions: torch.Tensor,
         cfg: EnvConfig) -> tuple[EnvState, torch.Tensor, torch.Tensor]:
    """actions: (B, A) int in {0, 1}. Returns (new_state, rewards (B, A),
    done (B,))."""
    plen = _route_len(state.route, cfg)
    gas = (actions > 0) & active(state, cfg)
    prog = torch.minimum(state.prog + gas.long(), plen)
    pos = positions(state._replace(prog=prog), cfg)
    now, coll = _collisions(state, prog, plen, pos, cfg)
    return _finish(state, prog, plen, now, coll, cfg)
