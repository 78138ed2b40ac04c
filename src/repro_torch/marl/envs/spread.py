"""Cooperative navigation ("spread"), batched over B environments.

Port of ``repro.marl.envs.spread``, a gridworld take on MPE
simple-spread: ``A`` agents must cover ``A`` landmarks on a ``size x
size`` grid. The shared reward is the negated mean (over landmarks)
distance to the nearest agent, plus a per-agent bonus for standing on a
landmark and a team bonus when every landmark is covered; the episode
succeeds when every landmark is occupied.

Where the JAX module is written for one env and vmapped, every function
here carries the batch dimension B first.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class EnvConfig(NamedTuple):
    n_agents: int = 3
    size: int = 5
    vision: int = 1                  # unused; kept for protocol symmetry
    max_steps: int = 20
    occupy_reward: float = 0.25
    cover_bonus: float = 0.5


class EnvState(NamedTuple):
    pos: torch.Tensor        # (B, A, 2) int64 agent positions
    landmarks: torch.Tensor  # (B, A, 2) int64 landmark positions
    t: torch.Tensor          # (B,) int64


# actions: 0=stay, 1=up, 2=down, 3=left, 4=right
_MOVES = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
N_ACTIONS = 5


def obs_dim(cfg: EnvConfig) -> int:
    # own position one-hot (2*size) + per-landmark offset (2*A, normalised)
    # + per-landmark covered flag (A)
    return 2 * cfg.size + 3 * cfg.n_agents


def n_actions(cfg: EnvConfig) -> int:
    return N_ACTIONS


def reset(generator: torch.Generator, cfg: EnvConfig,
          batch: int) -> EnvState:
    """B fresh episodes drawn from ``generator``, on its device."""
    dev = generator.device
    shape = (batch, cfg.n_agents, 2)
    pos = torch.randint(0, cfg.size, shape, generator=generator, device=dev)
    landmarks = torch.randint(0, cfg.size, shape, generator=generator,
                              device=dev)
    return EnvState(pos=pos, landmarks=landmarks,
                    t=torch.zeros((batch,), dtype=torch.int64, device=dev))


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _on_landmark(pos: torch.Tensor, landmarks: torch.Tensor) -> torch.Tensor:
    """(B, agent, landmark) bool: agent stands on the landmark."""
    return (pos[:, :, None, :] == landmarks[:, None, :, :]).all(-1)


def _coverage(state: EnvState) -> torch.Tensor:
    """(B, A) bool -- is each landmark occupied by some agent."""
    return _on_landmark(state.pos, state.landmarks).any(1)


def observe(state: EnvState, cfg: EnvConfig) -> torch.Tensor:
    """(B, A, obs_dim) float32 observations."""
    b, a = state.pos.shape[:2]
    row = _one_hot(state.pos[..., 0], cfg.size)
    col = _one_hot(state.pos[..., 1], cfg.size)
    off = state.landmarks[:, None, :, :] - state.pos[:, :, None, :]
    off = off.float() / max(cfg.size - 1, 1)                  # (B, A, L, 2)
    covered = _coverage(state).float()                        # (B, L)
    return torch.cat([row, col, off.reshape(b, a, -1),
                      covered[:, None, :].expand(b, a, a)], -1)


def step(state: EnvState, actions: torch.Tensor,
         cfg: EnvConfig) -> tuple[EnvState, torch.Tensor, torch.Tensor]:
    """actions: (B, A) int. Returns (new_state, rewards (B, A), done (B,))."""
    moves = torch.tensor(_MOVES, dtype=torch.int64, device=actions.device)
    pos = (state.pos + moves[actions]).clamp(0, cfg.size - 1)
    nstate = EnvState(pos=pos, landmarks=state.landmarks, t=state.t + 1)
    # shared shaping: mean over landmarks of the distance to the nearest agent
    dist = (pos[:, :, None, :] - state.landmarks[:, None, :, :]).abs().sum(-1)
    nearest = dist.amin(1).float()                            # (B, L)
    # -mean(nearest) / size, as XLA compiles it: both divisions by
    # constants become products with their float32 reciprocals, so the
    # rewards equal the compiled reference's bit for bit
    inv_l = torch.tensor(1.0 / nearest.shape[-1], dtype=torch.float32)
    inv_size = torch.tensor(1.0 / max(cfg.size, 1), dtype=torch.float32)
    shared = -(nearest.sum(-1) * inv_l.to(nearest.device)) \
        * inv_size.to(nearest.device)
    all_covered = _coverage(nstate).all(-1)
    occupy = _on_landmark(pos, state.landmarks).any(2)        # (B, agent)
    rewards = shared[:, None] + cfg.occupy_reward * occupy.float() \
        + cfg.cover_bonus * all_covered.float()[:, None]
    done = all_covered | (nstate.t >= cfg.max_steps)
    return nstate, rewards, done


def success(state: EnvState) -> torch.Tensor:
    return _coverage(state).all(-1)
