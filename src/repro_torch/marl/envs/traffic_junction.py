"""Traffic Junction, batched over B environments.

Port of ``repro.marl.envs.traffic_junction``: two one-way roads cross at
the centre of a ``size x size`` grid (route 0 drives the middle row left
to right, route 1 the middle column top to bottom). Each of the ``A``
cars has a route and an entry step; actions are 0 = brake, 1 = gas. Two
cars on one cell collide, and each car pays a time penalty growing with
its time on the road. An episode succeeds iff no collision happened and
every car cleared the grid. Cars that have exited (or not yet entered)
are masked, never removed.

The hard variant (:class:`HardConfig`, :func:`reset_hard`) has a bigger
grid, more cars and a Geometric(``p_arrive``) arrival stream
(:func:`arrival_stream`, shared with the 4-way junction).

Where the JAX module is written for one env and vmapped, every function
here carries the batch dimension B first.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class EnvConfig(NamedTuple):
    n_agents: int = 4
    size: int = 7
    vision: int = 1
    max_steps: int = 24
    time_penalty: float = -0.01       # times tau (steps since entry) a step
    collision_penalty: float = -1.0


class EnvState(NamedTuple):
    route: torch.Tensor      # (B, A) int64 in {0, 1}
    enter_t: torch.Tensor    # (B, A) int64 -- step at which each car enters
    prog: torch.Tensor       # (B, A) int64 in [0, size]; == size: exited
    collided: torch.Tensor   # (B,) bool -- any collision so far
    cleared: torch.Tensor    # (B,) bool -- have all cars exited the grid
    t: torch.Tensor          # (B,) int64


N_ACTIONS = 2  # 0 = brake, 1 = gas


def obs_dim(cfg: EnvConfig) -> int:
    # route one-hot (2) + progress one-hot (size+1) + on-road flag
    # + occupancy window of the other cars ((2v+1)^2)
    return 2 + cfg.size + 1 + 1 + (2 * cfg.vision + 1) ** 2


def n_actions(cfg: EnvConfig) -> int:
    return N_ACTIONS


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    # A compare against arange: F.one_hot range-checks on the host.
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def positions(state: EnvState, cfg: EnvConfig) -> torch.Tensor:
    """(B, A, 2) grid cells; exited cars are clipped to the last cell."""
    mid = cfg.size // 2
    p = state.prog.clamp(0, cfg.size - 1)
    on_row = torch.stack([torch.full_like(p, mid), p], -1)    # route 0
    on_col = torch.stack([p, torch.full_like(p, mid)], -1)    # route 1
    return torch.where(state.route[..., None] == 0, on_row, on_col)


def active(state: EnvState, cfg: EnvConfig) -> torch.Tensor:
    """(B, A) bool -- entered and not yet exited."""
    return (state.t[:, None] >= state.enter_t) & (state.prog < cfg.size)


def _fresh(route: torch.Tensor, enter_t: torch.Tensor) -> EnvState:
    b = route.shape[0]
    dev = route.device
    return EnvState(route=route, enter_t=enter_t,
                    prog=torch.zeros_like(route),
                    collided=torch.zeros((b,), dtype=torch.bool, device=dev),
                    cleared=torch.zeros((b,), dtype=torch.bool, device=dev),
                    t=torch.zeros((b,), dtype=torch.int64, device=dev))


def reset(generator: torch.Generator, cfg: EnvConfig,
          batch: int) -> EnvState:
    """B fresh episodes drawn from ``generator``, on its device: random
    routes and distinct entry steps (a permutation of 0..A-1), so
    collisions come from the policy, not the spawner."""
    dev = generator.device
    a = cfg.n_agents
    route = (torch.rand((batch, a), generator=generator, device=dev)
             < 0.5).long()
    enter_t = torch.rand((batch, a), generator=generator,
                         device=dev).argsort(-1)
    return _fresh(route, enter_t)


def occupancy_window(pos: torch.Tensor, act: torch.Tensor,
                     vision: int) -> torch.Tensor:
    """(B, A, (2v+1)^2) occupancy of the *other* active cars around each
    car, from positions (B, A, 2) and activity (B, A). Shared by every
    junction variant."""
    a = pos.shape[1]
    v = vision
    w = 2 * v + 1
    off = pos[:, None, :, :] - pos[:, :, None, :]             # (B, A, A, 2)
    inwin = (off.abs() <= v).all(-1)
    inwin = inwin & act[:, None, :] & act[:, :, None]
    inwin = inwin & ~torch.eye(a, dtype=torch.bool, device=pos.device)
    widx = (off[..., 0] + v) * w + (off[..., 1] + v)
    occ = (_one_hot(widx.clamp(0, w * w - 1), w * w)
           * inwin[..., None]).sum(2)
    return occ.clamp(0.0, 1.0)


def observe(state: EnvState, cfg: EnvConfig) -> torch.Tensor:
    """(B, A, obs_dim) float32 observations."""
    act = active(state, cfg)
    pos = positions(state, cfg)
    route_oh = _one_hot(state.route, 2)
    prog_oh = _one_hot(state.prog.clamp(0, cfg.size), cfg.size + 1)
    occ = occupancy_window(pos, act, cfg.vision)
    return torch.cat([route_oh, prog_oh, act[..., None].float(), occ], -1)


def _collisions(state: EnvState, prog: torch.Tensor, plen, pos, cfg):
    """Per-car (on the road after the step, collided) of a junction step.
    A car entering at t+1 spawns onto its entry cell now, so sitting on
    that cell is a collision already; off-road cars get unique sentinel
    cells so they never match."""
    now = (state.t[:, None] + 1 >= state.enter_t) & (prog < plen)
    cell = pos[..., 0] * cfg.size + pos[..., 1]
    sentinel = cfg.size * cfg.size + torch.arange(cfg.n_agents,
                                                  device=prog.device)
    cell = torch.where(now, cell, sentinel)
    share = (cell[:, :, None] == cell[:, None, :]).sum(-1) - 1
    return now, share > 0


def _finish(state: EnvState, prog, plen, now, coll, cfg):
    """(new state, rewards (B, A), done (B,)) of a junction step."""
    tau = (state.t[:, None] + 1 - state.enter_t).float()
    rewards = torch.where(
        now, cfg.time_penalty * tau + cfg.collision_penalty * coll.float(),
        0.0)
    t = state.t + 1
    cleared = (prog >= plen).all(-1)
    done = cleared | (t >= cfg.max_steps)
    return EnvState(route=state.route, enter_t=state.enter_t, prog=prog,
                    collided=state.collided | coll.any(-1),
                    cleared=cleared, t=t), rewards, done


def step(state: EnvState, actions: torch.Tensor,
         cfg: EnvConfig) -> tuple[EnvState, torch.Tensor, torch.Tensor]:
    """actions: (B, A) int in {0, 1}. Returns (new_state, rewards (B, A),
    done (B,))."""
    gas = (actions > 0) & active(state, cfg)
    prog = (state.prog + gas.long()).clamp(0, cfg.size)
    pos = positions(state._replace(prog=prog), cfg)
    now, coll = _collisions(state, prog, cfg.size, pos, cfg)
    return _finish(state, prog, cfg.size, now, coll, cfg)


def success(state: EnvState) -> torch.Tensor:
    """(B,) bool: no collision and every car cleared the grid (an
    all-brake policy that waits out the episode does not succeed)."""
    return ~state.collided & state.cleared


# ---------------------------------------------------------------------------
# Hard variant: bigger grid, more cars and a dense Geometric(p_arrive)
# arrival stream, so several cars contest the junction at once.
# ---------------------------------------------------------------------------

class HardConfig(NamedTuple):
    n_agents: int = 10
    size: int = 11
    vision: int = 1
    max_steps: int = 60
    time_penalty: float = -0.01
    collision_penalty: float = -1.0
    p_arrive: float = 0.7             # per-step arrival probability


def arrivals_from_uniforms(u: torch.Tensor, p_arrive: float,
                           cap: int) -> torch.Tensor:
    """(B, n) uniforms -> (B, n) strictly increasing int64 entry steps with
    Geometric(p) gaps, ``1 + floor(log(u) / log1p(-p))`` in float32.

    The first car enters at t=0. The tail is squeezed under the
    feasibility budget ``cap`` (car i enters no later than
    ``cap - (n-1-i)``) while entries stay strictly increasing (and, where
    even that is infeasible, car i enters no earlier than i): two cars
    must never share an entry step, or same-route pairs would spawn
    collided and no policy could succeed.
    """
    n = u.shape[-1]
    p = min(max(p_arrive, 1e-3), 1.0)
    if p >= 1.0:
        gaps = torch.ones(u.shape, dtype=torch.int64, device=u.device)
    else:
        denom = torch.log1p(torch.tensor(-p, dtype=torch.float32,
                                         device=u.device))
        gaps = 1 + torch.floor(torch.log(u) / denom).long()
    enter_t = gaps.cumsum(-1) - gaps[..., :1]
    cap = max(0, cap)
    idx = torch.arange(n, device=u.device)
    return torch.maximum(idx, torch.minimum(enter_t, cap - (n - 1 - idx)))


def arrival_stream(generator: torch.Generator, batch: int, n: int,
                   p_arrive: float, cap: int) -> torch.Tensor:
    """(B, n) entry steps of B arrival streams from uniforms in [1e-6, 1)
    drawn from ``generator``; see :func:`arrivals_from_uniforms`. Shared
    by the hard and 4-way variants."""
    u = torch.rand((batch, n), generator=generator, device=generator.device)
    return arrivals_from_uniforms(u * (1.0 - 1e-6) + 1e-6, p_arrive, cap)


def reset_hard(generator: torch.Generator, cfg: HardConfig,
               batch: int) -> EnvState:
    """Hard-variant reset: random straight routes and a Geometric(p_arrive)
    arrival stream."""
    dev = generator.device
    a = cfg.n_agents
    route = (torch.rand((batch, a), generator=generator, device=dev)
             < 0.5).long()
    enter_t = arrival_stream(generator, batch, a, cfg.p_arrive,
                             cfg.max_steps - cfg.size - 1)
    return _fresh(route, enter_t)
