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

``TrainConfig.mesh=(env, agent)`` runs the learner with one process per
shard of an ``("env", "agent")`` mesh (``launch.mesh.make_marl_mesh``):
the env axis splits the global rollout batch, the agent axis each env's
agents, and the learner state is replicated. Each rank draws the random
numbers of the whole global batch and keeps its :class:`Shard` of them,
takes the local sums of the loss over the global counts, and the
gradients are summed over the split axes before RMSprop, so a mesh run is
the one-process run up to the order of f32 sums, and a ``(1, 1)`` mesh
is it bitwise.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core import encoder, flgw, grouped
from repro_torch.core.schedule import SparsitySchedule
from repro_torch.launch import mesh as mesh_lib
from repro_torch.marl import envs as envs_mod
from repro_torch.marl.envs import Env
from repro_torch.marl.ic3net import IC3Net, IC3NetConfig
from repro_torch.optim.optimizers import (rmsprop, rmsprop_init, tree_leaves,
                                          tree_map)
from repro_torch.sharding import collectives, partition

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


@dataclasses.dataclass(frozen=True)
class Shard:
    """One rank's part of a run on an ``("env", "agent")`` mesh.

    ``rows`` and ``cols`` are its env rows and agents of the global
    ``batch`` x ``agents`` (None: all of them, the axis is not split);
    ``agent_group`` is the agent axis's process group when ``cols`` splits
    it; ``reduce_group`` sums the loss terms and gradients over the axes
    the rollout shards on (``dist.group.WORLD`` for both; None: nothing to
    sum). ``success_rank``: this rank's success counts in the sum (each
    env's success is counted once, by its agent-group's first rank).
    """
    batch: int
    agents: int
    rows: Optional[slice]
    cols: Optional[slice]
    agent_group: Any
    reduce_group: Any
    success_rank: bool

    @property
    def local_agents(self) -> int:
        c = self.cols
        return self.agents if c is None else c.stop - c.start

    def take_rows(self, state):
        """This rank's env rows of a state (or any tuple of (B, ...)
        tensors)."""
        if self.rows is None:
            return state
        return type(state)(*(v[self.rows] for v in state))

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's [env rows, agents] of a (B, A, ...) tensor."""
        if self.rows is not None:
            x = x[self.rows]
        if self.cols is not None:
            x = x[:, self.cols]
        return x


def _split(total: int, width: int, index: int, kept: bool):
    if not kept or width == 1:
        return None
    n = total // width
    return slice(index * n, (index + 1) * n)


def shard_for(mesh, batch: int, agents: int) -> Shard:
    """This rank's :class:`Shard` of a ``batch`` x ``agents`` rollout on
    ``mesh``: the (B, T, A) tensors take ``("env", None, "agent")``
    through ``partition.constrained_pspec``, so an axis that does not
    divide its dimension is replicated."""
    spec = partition.constrained_pspec(("env", None, "agent"),
                                       (batch, 1, agents), mesh)
    env_kept = len(spec) > 0 and spec[0] == "env"
    agent_kept = len(spec) > 2 and spec[2] == "agent"
    sizes = partition.axis_sizes(mesh)
    e, a = mesh.get_coordinate()
    rows = _split(batch, sizes["env"], e, env_kept)
    cols = _split(agents, sizes["agent"], a, agent_kept)
    grouped = dist.is_initialized()
    if not grouped or not (env_kept or agent_kept):
        reduce_group = None
    elif env_kept and agent_kept:
        reduce_group = dist.group.WORLD
    else:
        reduce_group = mesh.get_group("env" if env_kept else "agent")
    return Shard(batch=batch, agents=agents, rows=rows, cols=cols,
                 agent_group=(mesh.get_group("agent")
                              if grouped and cols is not None else None),
                 reduce_group=reduce_group,
                 success_rank=not agent_kept or a == 0)


def make_generator(seed: int, device=None) -> torch.Generator:
    """A seeded generator on ``device`` (the CUDA card when None)."""
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


def sampler(generator: torch.Generator,
            shard: Optional[Shard] = None) -> Sampler:
    """Sample actions (Gumbel-max over the logits) and gates (Bernoulli of
    the gate softmax) from ``generator``, on its device. With a ``shard``
    it draws the numbers of the whole global batch and keeps the shard's,
    so that every rank's draws are the one-process run's."""
    def sample(t, logits, gate_logits):
        dev = generator.device
        logits, gate_logits = logits.detach(), gate_logits.detach()
        full = logits.shape if shard is None else \
            (shard.batch, shard.agents, logits.shape[-1])
        u = torch.rand(full, generator=generator, device=dev)
        if shard is not None:
            u = shard.take(u)
        action = (logits - torch.log(-torch.log(u))).argmax(-1)
        p_gate = F.softmax(gate_logits, dim=-1)[..., 1]
        v = torch.rand(full[:2], generator=generator, device=dev)
        if shard is not None:
            v = shard.take(v)
        return action, (v < p_gate).float()
    return sample


def run_episode(model: IC3Net, env: Env, ecfg, state, sample: Sampler,
                plans=None, collect: bool = False,
                flgw_path: Optional[str] = None,
                shard: Optional[Shard] = None) -> Rollout:
    """``ecfg.max_steps`` steps of B episodes from ``state``, the actions
    and gates taken from ``sample``. After an episode is done its rewards
    are zero and its env state stays frozen; the policy keeps stepping.
    ``flgw_path`` overrides the model's FLGW path (``"dense"`` for the
    learner's warmup). Records an autograd graph unless called under
    ``torch.inference_mode()`` or ``torch.no_grad()``.

    With a ``shard`` ``state`` holds the shard's env rows and every agent
    of them (the env state is replicated within an agent group): the
    policy steps the shard's agents, the sampled actions are gathered over
    the agent group before ``env.step``, and the per-step tensors keep the
    shard's agents."""
    batch = state[0].shape[0]
    cols = None if shard is None else shard.cols
    group = None if shard is None else shard.agent_group
    hc, gate = model.initial_state(
        batch, None if shard is None else shard.local_agents)
    done = torch.zeros((batch,), dtype=torch.bool, device=model.device)
    outs = []
    for t in range(ecfg.max_steps):
        obs = env.observe(state, ecfg)
        if cols is not None:
            obs = obs[:, cols]
        logits, value, gate_logits, hc = model.policy_step(
            obs, hc, gate, plans, flgw_path, agent_group=group)
        action, new_gate = sample(t, logits, gate_logits)
        logp_a, entropy, gate_logp = _policy_terms(logits, gate_logits,
                                                   action, new_gate)
        nstate, reward, ndone = env.step(
            state, collectives.all_gather(action, group, dim=1), ecfg)
        if cols is not None:
            reward = reward[:, cols]
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

@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The learner's hyper-parameters, the JAX package's fields and
    defaults."""
    batch: int = 16               # parallel envs (paper: B in 1..32)
    lr: float = 1e-3              # paper: RMSprop 0.001
    gamma: float = 0.99
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    gate_coef: float = 0.01       # IC3Net gate regularizer
    # (env, agent) shard counts of the process mesh; env <= 0 takes every
    # rank the agent axis leaves. None keeps the one-process loop.
    # ``batch`` is the GLOBAL env batch on every path.
    mesh: Optional[tuple] = None
    # DEPRECATED: the JAX package's old data-parallel switch. Routes to
    # mesh=(world_size, 1); set ``mesh`` instead.
    parallel: bool = False


def discounted_returns(rew: torch.Tensor, gamma: float) -> torch.Tensor:
    """Returns-to-go of (B, T, ...) rewards, bootstrapped with 0 after
    the window: ``G_t = r_t + gamma * G_{t+1}``."""
    carry = torch.zeros_like(rew[:, 0])
    returns = []
    for t in range(rew.shape[1] - 1, -1, -1):
        carry = rew[:, t] + gamma * carry
        returns.append(carry)
    return torch.stack(returns[::-1], dim=1)


def _mean(x: torch.Tensor, count: Optional[int]) -> torch.Tensor:
    """``x.mean()``, or on a shard the local sum over the global
    ``count`` (the shard's part of the global mean)."""
    return x.mean() if count is None or x.numel() == count \
        else x.sum() / count


def a2c_terms(rew, logp, val, ent, gate_logp, gates, succ,
              tcfg: TrainConfig, shard: Optional[Shard] = None):
    """A2C loss + metrics from per-step trajectory tensors, all (B, T, A):
    discounted returns-to-go, the advantage policy gradient (advantage
    detached), value regression, entropy and gate regularisers.

    ``gate_logp`` is taken and not used, as in the JAX package's
    ``a2c_terms``: the gate head gets no gradient from the loss (ROADMAP
    Queue 3). Returns (loss, {"success", "return", "loss"}), 0-d tensors.
    With a ``shard`` the tensors are its part and each mean is its share
    of the global one, summed over ``shard.reduce_group`` by the caller.
    """
    if shard is None:
        n_bta = n_ba = n_b = None
    else:
        n_b = shard.batch
        n_ba = n_b * shard.agents
        n_bta = n_ba * rew.shape[1]
    adv = discounted_returns(rew, tcfg.gamma) - val
    pg = -_mean(logp * adv.detach(), n_bta)
    vloss = _mean(adv ** 2, n_bta)
    eloss = -_mean(ent, n_bta)
    gloss = _mean(gates, n_bta)                               # talk less
    loss = pg + tcfg.value_coef * vloss + tcfg.entropy_coef * eloss \
        + tcfg.gate_coef * gloss
    success = _mean(succ.float(), n_b)
    if shard is not None and not shard.success_rank:
        success = torch.zeros_like(success)
    return loss, {"success": success, "return": _mean(rew.sum(1), n_ba),
                  "loss": loss}


def a2c_loss(model: IC3Net, env: Env, ecfg, tcfg: TrainConfig, state,
             sample: Sampler, plans=None, flgw_path: Optional[str] = None,
             shard: Optional[Shard] = None):
    """B episodes from the reset ``state`` with autograd on, then
    :func:`a2c_terms`. ``sample`` draws (or replays) the actions and
    gates; with a ``shard``, the shard's."""
    r = run_episode(model, env, ecfg, state, sample, plans,
                    flgw_path=flgw_path, shard=shard)
    return a2c_terms(r.reward, r.logp, r.value, r.entropy, r.gate_logp,
                     r.gate, r.success, tcfg, shard)


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


def _all_reduce_tree(tree, group):
    """Sum a tree of same-dtype tensors over ``group`` in one
    collective."""
    leaves = tree_leaves(tree)
    by_id = {id(a): b for a, b in
             zip(leaves, collectives.all_reduce_flat(leaves, group))}
    return tree_map(lambda g: by_id[id(g)], tree)


def _loss_grads(model: IC3Net, env: Env, ecfg, tcfg: TrainConfig, state,
                sample: Sampler, it: int = 0,
                schedule: Optional[SparsitySchedule] = None, plans=None,
                shard: Optional[Shard] = None):
    """(metrics, grads) at iteration ``it``; ``grads`` is a tree shaped as
    ``model.params``.

    On a schedule's warmup iterations the same parameters run the dense
    path (a host branch, where JAX has ``lax.cond``) and ``mask_sparsity``
    reports 0, the sparsity of the compute that ran. A parameter the
    loss does not reach gets a gradient of zeros, as JAX's does: the gate
    head always, IG and OG on dense iterations.

    With a ``shard`` (``state`` and ``sample`` the shard's) the gradients
    and the metrics are summed over ``shard.reduce_group``, one collective
    each: every rank returns the global ones.
    """
    ramped = (schedule is not None and schedule.warmup_steps > 0
              and model.cfg.flgw is not None)
    sparse = not ramped or schedule.sparse_at(it)
    loss, metrics = a2c_loss(model, env, ecfg, tcfg, state, sample, plans,
                             flgw_path=None if sparse else "dense",
                             shard=shard)
    grads = param_grads(model, loss)
    metrics = {k: v.detach() for k, v in metrics.items()}
    if shard is not None:
        grads = _all_reduce_tree(grads, shard.reduce_group)
        keys = ("success", "return", "loss")
        summed = collectives.all_reduce(
            torch.stack([metrics[k] for k in keys]), shard.reduce_group)
        metrics.update(zip(keys, summed.unbind()))
    metrics["mask_sparsity"] = _mean_mask_sparsity(model) if sparse else \
        torch.zeros((), device=model.device)
    return metrics, grads


def train_step(model: IC3Net, opt_state, env: Env, ecfg, tcfg: TrainConfig,
               state, sample: Sampler, it: int = 0,
               schedule: Optional[SparsitySchedule] = None, plans=None,
               shard: Optional[Shard] = None):
    """One update: the loss over B episodes from ``state``, its gradients
    and an RMSprop step at ``tcfg.lr``, applied to the model's parameters
    and ``opt_state`` in place. Returns (opt_state, metrics), the metrics
    as 0-d tensors on the model's device. With a ``shard`` the gradients
    are the mesh's sum, so every rank takes the same step."""
    metrics, grads = _loss_grads(model, env, ecfg, tcfg, state, sample, it,
                                 schedule, plans, shard)
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


def _resolve_mesh(tcfg: TrainConfig):
    """TrainConfig -> the ``("env", "agent")`` DeviceMesh, or None for the
    one-process loop."""
    shape = tcfg.mesh
    if tcfg.parallel:
        routing = (
            "parallel=True now routes to a 1-D env-only mesh "
            "(mesh=(world_size, 1)) where ``batch`` is the GLOBAL env batch"
            if shape is None else
            f"the explicit TrainConfig.mesh={shape} wins and parallel=True "
            "is ignored")
        warnings.warn(
            "TrainConfig.parallel is deprecated: the data-parallel path "
            f"was replaced by the torch.distributed mesh engine. {routing};"
            " set TrainConfig.mesh=(env, agent) explicitly.",
            DeprecationWarning, stacklevel=3)
        if shape is None:
            shape = (mesh_lib.process_count(), 1)
    if shape is None:
        return None
    env_shards, agent_shards = shape
    return mesh_lib.make_marl_mesh(env=env_shards, agent=agent_shards)


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

    With ``tcfg.mesh`` (or the deprecated ``parallel``) every process of
    the group calls ``train`` with the same arguments: each rolls out its
    :class:`Shard`, encodes and refreshes the plans from the replicated
    parameters, and steps with the gradients summed over the mesh. Every
    rank returns the same parameters and metrics; the throughput is its
    own clock's, over the global batch.
    """
    if isinstance(env, str):
        env = envs_mod.get(env)
    if ecfg is None:
        ecfg = env.config_cls()
    tcfg = tcfg or TrainConfig()
    dev = resolve_device(device)
    mesh = _resolve_mesh(tcfg)
    model, opt_state = _init(cfg, ecfg, env, seed, dev)
    shard = None if mesh is None else \
        shard_for(mesh, tcfg.batch, model.cfg.n_agents)
    with torch.no_grad():
        plans = model.encode_plans()
    gen = torch.Generator(device=dev).manual_seed(seed)
    sample = sampler(gen, shard)
    flops_iter = 3 * tcfg.batch * ecfg.max_steps * model.flops_per_step()
    history: list[dict] = []
    for it in range(iterations):
        t0 = time.perf_counter()
        plans = maybe_refresh_plans(model, plans, it, schedule)
        state = env.reset(gen, ecfg, tcfg.batch)
        if shard is not None:
            state = shard.take_rows(state)
        opt_state, metrics = train_step(model, opt_state, env, ecfg, tcfg,
                                        state, sample, it, schedule, plans,
                                        shard)
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
