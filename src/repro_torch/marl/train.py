"""The acting half of the MARL engine: batched IC3Net rollouts.

Port of ``repro.marl.train``'s ``rollout`` and ``_policy_terms``. The JAX
engine vmaps a one-env episode over B keys and scans it over T steps;
here one episode loop carries the B envs as a batch dimension. The
learner (A2C loss, RMSprop, plan refresh, the train loop) belongs to the
training slice.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.marl.envs import Env
from repro_torch.marl.ic3net import IC3Net

# (t, logits (B, A, n_act), gate_logits (B, A, 2)) -> (action (B, A) int64,
# gate (B, A) float 0/1)
Sampler = Callable[[int, torch.Tensor, torch.Tensor],
                   tuple[torch.Tensor, torch.Tensor]]


class Rollout(NamedTuple):
    """Per-step tensors (B, T, A) of B episodes, plus (B,) success.
    ``obs`` (B, T, A, obs_dim) and ``action`` are kept with ``collect``."""
    reward: torch.Tensor
    logp: torch.Tensor
    value: torch.Tensor
    entropy: torch.Tensor
    gate_logp: torch.Tensor
    gate: torch.Tensor
    obs: Optional[torch.Tensor]
    action: Optional[torch.Tensor]
    success: torch.Tensor


def _policy_terms(logits, gate_logits, action, new_gate):
    """(logp of the action, entropy, gate logp) from one policy forward
    and the realised decisions."""
    logp = F.log_softmax(logits, dim=-1)
    logp_a = logp.gather(-1, action[..., None])[..., 0]
    entropy = -(F.softmax(logits, dim=-1) * logp).sum(-1)
    gate_logp = F.log_softmax(gate_logits, dim=-1)[..., 1] * new_gate
    return logp_a, entropy, gate_logp


def make_generator(seed: int, device=None) -> torch.Generator:
    """A seeded generator on ``device`` (the CUDA card when None)."""
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


def sampler(generator: torch.Generator) -> Sampler:
    """Sample actions (Gumbel-max over the logits) and gates (Bernoulli of
    the gate softmax) from ``generator``, on its device."""
    def sample(t, logits, gate_logits):
        dev = generator.device
        u = torch.rand(logits.shape, generator=generator, device=dev)
        action = (logits - torch.log(-torch.log(u))).argmax(-1)
        p_gate = F.softmax(gate_logits, dim=-1)[..., 1]
        v = torch.rand(p_gate.shape, generator=generator, device=dev)
        return action, (v < p_gate).float()
    return sample


def run_episode(model: IC3Net, env: Env, ecfg, state, sample: Sampler,
                plans=None, collect: bool = False) -> Rollout:
    """``ecfg.max_steps`` steps of B episodes from ``state``, the actions
    and gates taken from ``sample``. After an episode is done its rewards
    are zero and its env state stays frozen; the policy keeps stepping."""
    batch = state.pos.shape[0]
    hc, gate = model.initial_state(batch)
    done = torch.zeros((batch,), dtype=torch.bool, device=model.device)
    outs = []
    for t in range(ecfg.max_steps):
        obs = env.observe(state, ecfg)
        logits, value, gate_logits, hc = model.policy_step(obs, hc, gate,
                                                           plans)
        action, new_gate = sample(t, logits, gate_logits)
        logp_a, entropy, gate_logp = _policy_terms(logits, gate_logits,
                                                   action, new_gate)
        nstate, reward, ndone = env.step(state, action, ecfg)
        reward = torch.where(done[:, None], 0.0, reward)
        state = type(state)(*(
            torch.where(done.view(-1, *[1] * (a.dim() - 1)), a, b)
            for a, b in zip(state, nstate)))
        outs.append((reward, logp_a, value, entropy, gate_logp, new_gate)
                    + ((obs, action) if collect else (None, None)))
        done = done | ndone
        gate = new_gate
    stacked = [None if col[0] is None else torch.stack(col, dim=1)
               for col in zip(*outs)]
    return Rollout(*stacked, success=env.success(state))


def rollout(model: IC3Net, env: Env, ecfg, generator: torch.Generator,
            batch: int, plans=None, collect: bool = False) -> Rollout:
    """B full episodes on the model's device under inference mode: reset
    from ``generator``, actions and gates sampled from it. ``plans`` is
    the model's cached PlanState (``model.encode_plans()``); ``None``
    re-encodes inside every grouped projection."""
    if generator.device != model.device:
        raise ValueError(f"generator on {generator.device}, model on "
                         f"{model.device}")
    with torch.inference_mode():
        state = env.reset(generator, ecfg, batch)
        return run_episode(model, env, ecfg, state, sampler(generator),
                           plans, collect)
