"""Predator-Prey, batched over B environments.

Port of ``repro.marl.envs.predator_prey``: ``A`` cooperative predators
search a ``size x size`` grid for one stationary prey. Agents observe
their own position (one-hot) and, within ``vision`` Chebyshev distance,
the prey's relative offset. An agent on the prey has arrived and stays;
the episode succeeds when every predator has arrived.

Where the JAX module is written for one env and vmapped, every function
here carries the batch dimension B first.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class EnvConfig(NamedTuple):
    n_agents: int = 3
    size: int = 5
    vision: int = 1
    max_steps: int = 20
    step_penalty: float = -0.05
    prey_reward: float = 0.5


class EnvState(NamedTuple):
    pos: torch.Tensor        # (B, A, 2) int64 agent positions
    prey: torch.Tensor       # (B, 2) int64
    arrived: torch.Tensor    # (B, A) bool -- has each agent reached the prey
    t: torch.Tensor          # (B,) int64


# actions: 0=stay, 1=up, 2=down, 3=left, 4=right; (drow, dcol) of each,
# the JAX module's table (``step`` computes the same moves by compares)
_MOVES = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
N_ACTIONS = 5


def obs_dim(cfg: EnvConfig) -> int:
    # own position one-hot (2*size) + prey offset one-hot ((2v+1)^2) + seen flag
    return 2 * cfg.size + (2 * cfg.vision + 1) ** 2 + 1


def n_actions(cfg: EnvConfig) -> int:
    return N_ACTIONS


def reset(generator: torch.Generator, cfg: EnvConfig,
          batch: int) -> EnvState:
    """B fresh episodes drawn from ``generator``, on its device."""
    dev = generator.device
    prey = torch.randint(0, cfg.size, (batch, 2), generator=generator,
                         device=dev)
    pos = torch.randint(0, cfg.size, (batch, cfg.n_agents, 2),
                        generator=generator, device=dev)
    return EnvState(pos=pos, prey=prey,
                    arrived=torch.zeros((batch, cfg.n_agents), dtype=torch.bool,
                                        device=dev),
                    t=torch.zeros((batch,), dtype=torch.int64, device=dev))


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    # A compare against arange: F.one_hot range-checks on the host.
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def observe(state: EnvState, cfg: EnvConfig) -> torch.Tensor:
    """(B, A, obs_dim) float32 observations."""
    row = _one_hot(state.pos[..., 0], cfg.size)
    col = _one_hot(state.pos[..., 1], cfg.size)
    off = state.prey[:, None, :] - state.pos                  # (B, A, 2)
    seen = (off.abs() <= cfg.vision).all(-1)                  # (B, A)
    v = 2 * cfg.vision + 1
    oidx = (off[..., 0] + cfg.vision) * v + (off[..., 1] + cfg.vision)
    prey_oh = _one_hot(oidx.clamp(0, v * v - 1), v * v) * seen[..., None]
    return torch.cat([row, col, prey_oh, seen[..., None].float()], dim=-1)


def step(state: EnvState, actions: torch.Tensor,
         cfg: EnvConfig) -> tuple[EnvState, torch.Tensor, torch.Tensor]:
    """actions: (B, A) int. Returns (new_state, rewards (B, A), done (B,))."""
    drow = (actions == 2).long() - (actions == 1).long()
    dcol = (actions == 4).long() - (actions == 3).long()
    # Arrived agents stay on the prey (IC3Net freezes them).
    moves = torch.stack([drow, dcol], -1) * (~state.arrived)[..., None]
    pos = (state.pos + moves).clamp(0, cfg.size - 1)
    on_prey = (pos == state.prey[:, None, :]).all(-1)
    arrived = state.arrived | on_prey
    rewards = torch.where(arrived, cfg.prey_reward, cfg.step_penalty)
    t = state.t + 1
    done = arrived.all(-1) | (t >= cfg.max_steps)
    return EnvState(pos=pos, prey=state.prey, arrived=arrived, t=t), \
        rewards, done


def success(state: EnvState) -> torch.Tensor:
    """(B,) bool: every predator of the episode has arrived."""
    return state.arrived.all(-1)
