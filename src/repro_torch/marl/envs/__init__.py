"""MARL environment registry.

Port of ``repro.marl.envs``: every environment is a module of functions
over NamedTuple states -- ``reset``/``step``/``observe``/``success`` plus
``obs_dim``/``n_actions`` -- bundled into an :class:`Env` record and
registered under a string key. States carry the batch dimension first.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.marl.envs import (predator_prey, spread, traffic_junction,
                                   traffic_junction_4way)


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


def _register_module(name: str, mod) -> Env:
    return register(Env(
        name=name, config_cls=mod.EnvConfig, reset=mod.reset, step=mod.step,
        observe=mod.observe, success=mod.success, obs_dim=mod.obs_dim,
        n_actions=mod.n_actions))


PREDATOR_PREY = _register_module("predator_prey", predator_prey)
TRAFFIC_JUNCTION = _register_module("traffic_junction", traffic_junction)
SPREAD = _register_module("spread", spread)

# 4-way TJ: two two-way roads with right/straight/left turning routes --
# 12 curved routes through a shared 2x2 intersection (its own module).
TRAFFIC_JUNCTION_4WAY = _register_module("traffic_junction_4way",
                                         traffic_junction_4way)

# Hard TJ: same step/observe dynamics, but a bigger grid, more cars and a
# dense Geometric(p_arrive) arrival stream (its own config + reset).
TRAFFIC_JUNCTION_HARD = register(Env(
    name="traffic_junction_hard",
    config_cls=traffic_junction.HardConfig,
    reset=traffic_junction.reset_hard,
    step=traffic_junction.step,
    observe=traffic_junction.observe,
    success=traffic_junction.success,
    obs_dim=traffic_junction.obs_dim,
    n_actions=traffic_junction.n_actions))
