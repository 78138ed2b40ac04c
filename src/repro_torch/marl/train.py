"""The MARL engine: batched IC3Net rollouts and the A2C learner.

Port of ``repro.marl.train``. The JAX engine vmaps a one-env episode over
B keys, scans it over T steps and runs whole windows of iterations in a
``lax.scan``; here one episode loop carries the B envs as a batch
dimension and one host loop drives the iterations (JAX's scan path and
its host loop are bit-identical, so the port needs only the latter).

The learner is A2C with RMSprop (paper section IV-A: lr 1e-3): the loss
differentiates through the rollout that produced it, the grouped path's
compact backward is ``core.grouped._GroupedCore``, the plans refresh at
the top of every iteration through ``core.encoder.maybe_refresh``, and a
``SparsitySchedule``'s warmup runs the same parameters dense.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core import encoder, flgw, grouped
from repro_torch.core.schedule import SparsitySchedule
from repro_torch.marl import envs as envs_mod
from repro_torch.marl.envs import Env
from repro_torch.marl.ic3net import IC3Net, IC3NetConfig
from repro_torch.optim.optimizers import rmsprop, rmsprop_init, tree_map

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
        logits, gate_logits = logits.detach(), gate_logits.detach()
        u = torch.rand(logits.shape, generator=generator, device=dev)
        action = (logits - torch.log(-torch.log(u))).argmax(-1)
        p_gate = F.softmax(gate_logits, dim=-1)[..., 1]
        v = torch.rand(p_gate.shape, generator=generator, device=dev)
        return action, (v < p_gate).float()
    return sample


def run_episode(model: IC3Net, env: Env, ecfg, state, sample: Sampler,
                plans=None, collect: bool = False,
                flgw_path: Optional[str] = None) -> Rollout:
    """``ecfg.max_steps`` steps of B episodes from ``state``, the actions
    and gates taken from ``sample``. After an episode is done its rewards
    are zero and its env state stays frozen; the policy keeps stepping.
    ``flgw_path`` overrides the model's FLGW path (``"dense"`` for the
    learner's warmup). Records an autograd graph unless called under
    ``torch.inference_mode()`` or ``torch.no_grad()``."""
    batch = state[0].shape[0]
    hc, gate = model.initial_state(batch)
    done = torch.zeros((batch,), dtype=torch.bool, device=model.device)
    outs = []
    for t in range(ecfg.max_steps):
        obs = env.observe(state, ecfg)
        logits, value, gate_logits, hc = model.policy_step(
            obs, hc, gate, plans, flgw_path)
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


# ---------------------------------------------------------------------------
# The learner
# ---------------------------------------------------------------------------

_NO_SHARDING = ("{} is not ported to repro_torch yet: the port has one "
                "device and one host loop (ROADMAP, Queue 1: sharding, "
                "launch/mesh.py and sharding/partition.py on "
                "torch.distributed)")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The learner's hyper-parameters, the JAX package's fields and
    defaults. ``mesh`` and ``parallel`` (the JAX package's sharded paths)
    raise until sharding is ported."""
    batch: int = 16               # parallel envs (paper: B in 1..32)
    lr: float = 1e-3              # paper: RMSprop 0.001
    gamma: float = 0.99
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    gate_coef: float = 0.01       # IC3Net gate regularizer
    mesh: Optional[tuple] = None
    parallel: bool = False

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(_NO_SHARDING.format(
                f"TrainConfig.mesh={self.mesh}"))
        if self.parallel:
            raise NotImplementedError(_NO_SHARDING.format(
                "TrainConfig.parallel"))


def discounted_returns(rew: torch.Tensor, gamma: float) -> torch.Tensor:
    """Returns-to-go of (B, T, ...) rewards, bootstrapped with 0 after
    the window: ``G_t = r_t + gamma * G_{t+1}``."""
    carry = torch.zeros_like(rew[:, 0])
    returns = []
    for t in range(rew.shape[1] - 1, -1, -1):
        carry = rew[:, t] + gamma * carry
        returns.append(carry)
    return torch.stack(returns[::-1], dim=1)


def a2c_terms(rew, logp, val, ent, gate_logp, gates, succ,
              tcfg: TrainConfig):
    """A2C loss + metrics from per-step trajectory tensors, all (B, T, A):
    discounted returns-to-go, the advantage policy gradient (advantage
    detached), value regression, entropy and gate regularisers.

    ``gate_logp`` is taken and not used, as in the JAX package's
    ``a2c_terms``: the gate head gets no gradient from the loss (ROADMAP
    Queue 3). Returns (loss, {"success", "return", "loss"}), 0-d tensors.
    """
    adv = discounted_returns(rew, tcfg.gamma) - val
    pg = -(logp * adv.detach()).mean()
    vloss = (adv ** 2).mean()
    eloss = -ent.mean()
    gloss = gates.mean()                                      # talk less
    loss = pg + tcfg.value_coef * vloss + tcfg.entropy_coef * eloss \
        + tcfg.gate_coef * gloss
    return loss, {"success": succ.float().mean(),
                  "return": rew.sum(1).mean(), "loss": loss}


def a2c_loss(model: IC3Net, env: Env, ecfg, tcfg: TrainConfig, state,
             sample: Sampler, plans=None, flgw_path: Optional[str] = None):
    """B episodes from the reset ``state`` with autograd on, then
    :func:`a2c_terms`. ``sample`` draws (or replays) the actions and
    gates."""
    r = run_episode(model, env, ecfg, state, sample, plans,
                    flgw_path=flgw_path)
    return a2c_terms(r.reward, r.logp, r.value, r.entropy, r.gate_logp,
                     r.gate, r.success, tcfg)


def _mean_mask_sparsity(model: IC3Net) -> torch.Tensor:
    """Mean realised mask sparsity over the FLGW layers (0 when dense)."""
    fl = model.cfg.flgw
    zero = torch.zeros((), device=model.device)
    if fl is None:
        return zero
    with torch.no_grad():
        vals = [flgw.mask_sparsity(*flgw.grouping_indices(p["ig"], p["og"]),
                                   fl.groups)
                for _, p in grouped.iter_flgw_layers(model.params)]
    return torch.stack(vals).mean() if vals else zero


def maybe_refresh_plans(model: IC3Net, plans: encoder.PlanState, it,
                        schedule: Optional[SparsitySchedule]
                        ) -> encoder.PlanState:
    """The plan refresh of one iteration: a delegate to
    ``encoder.maybe_refresh`` (period, on_change or hybrid; empty states
    pass through)."""
    return encoder.maybe_refresh(model.params, plans, it, model.cfg.flgw,
                                 schedule)


def param_grads(model: IC3Net, loss: torch.Tensor) -> dict:
    """d loss / d params as a tree shaped as ``model.params``; a
    parameter the loss does not reach gets zeros, as JAX's gradient
    does."""
    params = list(model.parameters())
    got = torch.autograd.grad(loss, params, allow_unused=True)
    by_id = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(params, got)}
    return tree_map(lambda p: by_id[id(p)], model.params)


def _loss_grads(model: IC3Net, env: Env, ecfg, tcfg: TrainConfig, state,
                sample: Sampler, it: int = 0,
                schedule: Optional[SparsitySchedule] = None, plans=None):
    """(metrics, grads) at iteration ``it``; ``grads`` is a tree shaped as
    ``model.params``.

    On a schedule's warmup iterations the same parameters run the dense
    path (a host branch, where JAX has ``lax.cond``) and ``mask_sparsity``
    reports 0, the sparsity of the compute that ran. A parameter the
    loss does not reach gets a gradient of zeros, as JAX's does: the gate
    head always, IG and OG on dense iterations.
    """
    ramped = (schedule is not None and schedule.warmup_steps > 0
              and model.cfg.flgw is not None)
    sparse = not ramped or schedule.sparse_at(it)
    loss, metrics = a2c_loss(model, env, ecfg, tcfg, state, sample, plans,
                             flgw_path=None if sparse else "dense")
    grads = param_grads(model, loss)
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["mask_sparsity"] = _mean_mask_sparsity(model) if sparse else \
        torch.zeros((), device=model.device)
    return metrics, grads


def train_step(model: IC3Net, opt_state, env: Env, ecfg, tcfg: TrainConfig,
               state, sample: Sampler, it: int = 0,
               schedule: Optional[SparsitySchedule] = None, plans=None):
    """One update: the loss over B episodes from ``state``, its gradients
    and an RMSprop step at ``tcfg.lr``, applied to the model's parameters
    and ``opt_state`` in place. Returns (opt_state, metrics), the metrics
    as 0-d tensors on the model's device."""
    metrics, grads = _loss_grads(model, env, ecfg, tcfg, state, sample, it,
                                 schedule, plans)
    rmsprop(model.params, grads, opt_state, lr=tcfg.lr)
    return opt_state, metrics


def _init(cfg: IC3NetConfig, ecfg, env: Env, seed: int, device):
    """(model, RMSprop state) with the env's dimensions filled in."""
    cfg = dataclasses.replace(cfg, obs_dim=env.obs_dim(ecfg),
                              n_agents=ecfg.n_agents,
                              n_actions=env.n_actions(ecfg))
    model = IC3Net(cfg, seed=seed, device=device)
    return model, rmsprop_init(model.params)


_METRICS = ("success", "return", "loss", "mask_sparsity")


def train(cfg: IC3NetConfig, ecfg=None, tcfg: Optional[TrainConfig] = None,
          iterations: int = 100, seed: int = 0, log_every: int = 0,
          env: str | Env = "predator_prey",
          schedule: Optional[SparsitySchedule] = None, device=None):
    """Train IC3Net on a registered environment; returns (model, history).

    Runs on the CUDA card unless ``device="cpu"``. The plans are encoded
    once, then refreshed at the top of every iteration
    (:func:`maybe_refresh_plans`); reset states and actions come from one
    generator on the device, seeded from ``seed``. ``history`` is one dict
    of floats per iteration: ``success``, ``return``, ``loss``, the
    realised ``mask_sparsity``, and the iteration's wall-time throughput
    (refresh included, ending in the one host sync that fetches the
    metrics): ``steps_per_s`` (iterations/s), ``env_steps_per_s`` and
    ``sparse_gflops`` (dense-equivalent forward + ~2x backward FLOPs
    scaled by the mask sparsity, the JAX package's estimate).
    """
    if isinstance(env, str):
        env = envs_mod.get(env)
    if ecfg is None:
        ecfg = env.config_cls()
    tcfg = tcfg or TrainConfig()
    dev = resolve_device(device)
    model, opt_state = _init(cfg, ecfg, env, seed, dev)
    with torch.no_grad():
        plans = model.encode_plans()
    gen = torch.Generator(device=dev).manual_seed(seed)
    sample = sampler(gen)
    flops_iter = 3 * tcfg.batch * ecfg.max_steps * model.flops_per_step()
    history: list[dict] = []
    for it in range(iterations):
        t0 = time.perf_counter()
        plans = maybe_refresh_plans(model, plans, it, schedule)
        state = env.reset(gen, ecfg, tcfg.batch)
        opt_state, metrics = train_step(model, opt_state, env, ecfg, tcfg,
                                        state, sample, it, schedule, plans)
        vals = torch.stack([metrics[k].float() for k in _METRICS]).tolist()
        rate = 1.0 / max(time.perf_counter() - t0, 1e-9)
        ms = dict(zip(_METRICS, vals))
        ms.update(steps_per_s=rate,
                  env_steps_per_s=rate * tcfg.batch * ecfg.max_steps,
                  sparse_gflops=rate * flops_iter
                  * (1.0 - ms["mask_sparsity"]) / 1e9)
        history.append(ms)
        if log_every and it % log_every == 0:
            print(f"iter {it:5d} success {ms['success']:.3f} "
                  f"return {ms['return']:.3f}")
    return model, history
