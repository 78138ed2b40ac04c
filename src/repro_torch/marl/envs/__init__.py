"""MARL environment registry (predator-prey so far).

Port of ``repro.marl.envs``: every environment is a module of functions
over NamedTuple states -- ``reset``/``step``/``observe``/``success`` plus
``obs_dim``/``n_actions`` -- bundled into an :class:`Env` record and
registered under a string key. States carry the batch dimension first.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.marl.envs import predator_prey


@dataclasses.dataclass(frozen=True)
class Env:
    """One registered environment: its config type plus its functions."""

    name: str
    config_cls: type
    reset: Callable[..., Any]          # (generator, cfg, batch) -> state
    step: Callable[..., Any]           # (state, actions, cfg) -> (state, rew, done)
    observe: Callable[..., Any]        # (state, cfg) -> (B, A, obs_dim) obs
    success: Callable[..., Any]        # (state,) -> (B,) bool
    obs_dim: Callable[..., int]        # (cfg,) -> int
    n_actions: Callable[..., int]      # (cfg,) -> int

    def default_config(self, **overrides):
        return self.config_cls(**overrides)


_REGISTRY: dict[str, Env] = {}


def register(env: Env) -> Env:
    if env.name in _REGISTRY:
        raise ValueError(f"environment {env.name!r} already registered")
    _REGISTRY[env.name] = env
    return env


def get(name: str) -> Env:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown environment {name!r}; registered: {names()}") from None


def names() -> list[str]:
    return sorted(_REGISTRY)


def make(name: str, **overrides) -> tuple[Env, Any]:
    """Look up an environment and build its config in one call."""
    env = get(name)
    return env, env.default_config(**overrides)


PREDATOR_PREY = register(Env(
    name="predator_prey", config_cls=predator_prey.EnvConfig,
    reset=predator_prey.reset, step=predator_prey.step,
    observe=predator_prey.observe, success=predator_prey.success,
    obs_dim=predator_prey.obs_dim, n_actions=predator_prey.n_actions))
