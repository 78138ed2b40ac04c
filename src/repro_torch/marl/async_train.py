"""Async actor/learner MARL pipeline: IMPALA-style decoupled training.

Port of ``repro.marl.async_train``. The synchronous learner
(:mod:`repro_torch.marl.train`) differentiates through the rollout that
produced its loss, so the learner idles while the actor steps the
environments and the other way round. This module splits the two clocks:

* the **actor** runs :func:`train.rollout` (``collect=True``) against a
  *published* :class:`ParamBundle` and pushes whole rollout windows into a
  **device-resident ring** (:class:`TrajQueue`): preallocated ``(C, ...)``
  tensors on the model's device, written and read by index tensors, so
  the trajectory bytes never pass through the host (the host mirrors only
  the per-slot versions, :class:`QueueDriver`);
* the **learner** takes windows at its own cadence, re-unrolls the policy
  over each with its own parameters (:func:`replay_terms`) and applies the
  A2C update with an off-policy correction (``AsyncConfig.correction``):
  ``"vtrace"`` (IMPALA), ``"clip"`` (one-sided clipped importance weights)
  or ``"none"`` (the on-policy update: with queue depth 1 it is bitwise
  the synchronous :func:`train.train`);
* every ``publish_every`` updates the learner **publishes** a versioned
  bundle: its own copy of the parameters and the PlanState certified
  against that copy by ``encoder.refresh_if_stale``.

Where JAX gets immutability and ordering from its runtime, this port
makes them explicit:

* ``optim.rmsprop`` updates the learner's tensors in place, so
  :func:`publish` copies the parameters into a module the actor owns; a
  bundle's tensors are never written after publication.
* ``rollout`` runs under ``torch.inference_mode``; the ring's buffers are
  ordinary tensors written with ``index_copy_``, and a window handed to
  the learner is a copy of its slot, so a later push cannot move what
  autograd saved.
* The threaded actor runs on its own CUDA stream. The queue orders every
  push and pop on the device behind the previous one (one event chain);
  a bundle carries an event recorded after its copy and certification,
  which the actor's stream waits on, and its tensors are marked as used
  on the actor's stream (``record_stream``) so the allocator does not
  hand their memory out while the actor still reads it.

Staleness is bounded: every window is stamped with the version of the
bundle that generated it, and the learner drops windows older than
``max_staleness`` updates. At staleness 0 the V-trace targets reduce to
the synchronous Monte-Carlo returns.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
import time
from typing import Any, NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.analysis import contracts
from repro_torch.core import encoder
from repro_torch.marl import envs as envs_mod
from repro_torch.marl import train as train_mod
from repro_torch.marl.envs import Env
from repro_torch.marl.ic3net import IC3Net, IC3NetConfig
from repro_torch.optim.optimizers import rmsprop

CORRECTIONS = ("none", "clip", "vtrace")
PUSH_POLICIES = ("overwrite", "drop")

# Seed offsets of the generators beside the actor's own (``seed``): the
# learner's draws (``sample="random"``, a window generated when every
# queued one is over the bound) and the threaded actor's (JAX:
# ``fold_in(key, 0x5eed)``).
_LEARNER_SEED = 0x1ea2
_THREAD_SEED = 0x5eed


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Knobs of the decoupled pipeline (rides beside ``TrainConfig``)."""
    capacity: int = 4             # trajectory-queue depth (rollout windows)
    actors: int = 1               # rollout windows generated per update
    correction: str = "vtrace"    # off-policy correction: none|clip|vtrace
    rho_clip: float = 1.0         # V-trace rho-bar / IS clip ceiling
    c_clip: float = 1.0           # V-trace c-bar (trace cutting)
    max_staleness: int = 8        # max version lag of a consumed window
    publish_every: int = 1        # learner updates per params publication
    push_policy: str = "overwrite"  # ring full: overwrite oldest | drop new
    sample: str = "fifo"          # learner consumption: fifo | random

    def __post_init__(self):
        if self.correction not in CORRECTIONS:
            raise ValueError(f"correction must be one of {CORRECTIONS}, "
                             f"got {self.correction!r}")
        if self.push_policy not in PUSH_POLICIES:
            raise ValueError(f"push_policy must be one of {PUSH_POLICIES}, "
                             f"got {self.push_policy!r}")
        if self.sample not in ("fifo", "random"):
            raise ValueError(f"sample must be fifo|random, "
                             f"got {self.sample!r}")
        if self.capacity < 1 or self.actors < 1 or self.publish_every < 1:
            raise ValueError("capacity, actors and publish_every must be "
                             ">= 1")


class Trajectory(NamedTuple):
    """One actor rollout window: everything the learner needs to replay.

    ``obs``/``act``/``gates`` let the learner re-unroll the policy with its
    own parameters; ``logp`` is the *behavior* log-prob the importance
    ratios use; ``rew`` already carries the rollout's freeze-after-done
    zeroing.
    """
    obs: torch.Tensor     # (B, T, A, obs_dim) float32
    act: torch.Tensor     # (B, T, A) int64 sampled actions
    gates: torch.Tensor   # (B, T, A) float32 sampled comm gates
    rew: torch.Tensor     # (B, T, A) float32 rewards (post done-freeze)
    logp: torch.Tensor    # (B, T, A) float32 behavior log pi(act)
    succ: torch.Tensor    # (B,) bool episode success


def trajectory_spec(cfg: IC3NetConfig, batch: int, steps: int) -> Trajectory:
    """A window's shapes and dtypes as meta tensors (what
    ``jax.eval_shape`` of the actor gives the JAX queue); ``cfg`` with
    the env's dimensions filled in."""
    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")
    bta = (batch, steps, cfg.n_agents)
    return Trajectory(obs=meta(*bta, cfg.obs_dim),
                      act=meta(*bta, dtype=torch.int64), gates=meta(*bta),
                      rew=meta(*bta), logp=meta(*bta),
                      succ=meta(batch, dtype=torch.bool))


# ---------------------------------------------------------------------------
# Device-resident trajectory queue
# ---------------------------------------------------------------------------

class TrajQueue(NamedTuple):
    """Fixed-capacity ring of rollout windows, living on the device.

    ``data`` holds every field of an item with a leading capacity axis;
    ``version`` stamps the publication each slot was generated under.
    ``head`` is the next write slot, ``count`` the number of valid
    entries; the oldest valid entry sits at ``(head - count) mod C``. The
    functions below update these tensors in place and index by tensors,
    so no push, pop or sample reads a value back to the host.
    """
    data: Any                # NamedTuple of (C, ...) tensors
    version: torch.Tensor    # (C,) int32
    head: torch.Tensor       # () int32: next write index, always < C
    count: torch.Tensor      # () int32: number of valid entries
    pushed: torch.Tensor     # () int32: accepted pushes (lifetime)
    dropped: torch.Tensor    # () int32: rejected pushes (push_policy="drop")

    @property
    def capacity(self) -> int:
        return self.version.shape[0]


def queue_init(capacity: int, example, device=None) -> TrajQueue:
    """Empty queue whose slots are shaped like ``example`` (a NamedTuple of
    tensors, meta tensors included), on ``device`` (``example``'s when
    None)."""
    dev = device if device is not None else example[0].device
    data = type(example)(*(
        torch.zeros((capacity,) + tuple(x.shape), dtype=x.dtype, device=dev)
        for x in example))

    def z():
        return torch.zeros((), dtype=torch.int32, device=dev)
    return TrajQueue(data=data,
                     version=torch.zeros((capacity,), dtype=torch.int32,
                                         device=dev),
                     head=z(), count=z(), pushed=z(), dropped=z())


def queue_push(q: TrajQueue, item, version: int,
               policy: str = "overwrite") -> TrajQueue:
    """Push one window, in place; returns ``q``. Ring full:
    ``"overwrite"`` replaces the oldest entry (head == oldest when full),
    ``"drop"`` rejects the new one."""
    cap = q.capacity
    idx = q.head.view(1).long()
    if policy == "drop":
        accept = q.count < cap
        for buf, x in zip(q.data, item):
            keep = buf.index_select(0, idx)[0]
            buf.index_copy_(0, idx, torch.where(accept, x, keep)[None])
        old = q.version.index_select(0, idx)
        q.version.index_copy_(
            0, idx, torch.where(accept, torch.full_like(old, version), old))
        step = accept.int()
        q.head.add_(step).remainder_(cap)
        q.count.add_(step)
        q.pushed.add_(step)
        q.dropped.add_(1 - step)
        return q
    if policy != "overwrite":
        raise ValueError(f"policy must be one of {PUSH_POLICIES}, "
                         f"got {policy!r}")
    for buf, x in zip(q.data, item):
        buf.index_copy_(0, idx, x[None])
    q.version.index_fill_(0, idx, version)
    q.head.add_(1).remainder_(cap)
    q.count.add_(1).clamp_(max=cap)
    q.pushed.add_(1)
    return q


def _read_slot(q: TrajQueue, idx: torch.Tensor):
    """(a copy of slot ``idx``'s item, its version as a 0-d tensor)."""
    item = type(q.data)(*(buf.index_select(0, idx)[0] for buf in q.data))
    return item, q.version.index_select(0, idx)[0]


def queue_pop(q: TrajQueue):
    """FIFO: ``(item, version, q)`` for the oldest valid entry; ``item``
    is a copy of its slot, so a later push cannot change it.

    Popping an empty queue is a host-side contract violation (the host
    mirrors ``count``); the item is then unspecified, but ``count`` stays
    clamped at 0.
    """
    idx = (q.head - q.count).remainder(q.capacity).view(1).long()
    item, version = _read_slot(q, idx)
    q.count.sub_(1).clamp_(min=0)
    return item, version, q


def queue_sample(q: TrajQueue, generator: torch.Generator):
    """Uniform sample over the valid entries, without consuming:
    ``(item copy, version)``. Deterministic under a generator's state."""
    n = q.count.clamp(min=1)
    u = torch.rand((), generator=generator, device=q.version.device)
    j = torch.minimum((u * n).long(), n - 1)
    idx = (q.head - q.count + j).remainder(q.capacity).view(1).long()
    return _read_slot(q, idx)


class QueueDriver:
    """Host-side handle on the device queue: push, pop and sample plus a
    mirror of the valid slots' versions (oldest first), so staleness
    decisions never wait for the device.

    Thread-safe: the threaded pipeline's actor and learner share one
    driver under ``cond``. On a CUDA device every queue operation's work
    is ordered behind the previous operation's, whichever thread and
    stream issued it (one event chain), so a pop sees the bytes of every
    push before it and a push never overwrites a slot a pending pop still
    reads.
    """

    def __init__(self, capacity: int, example, push_policy: str,
                 device=None):
        self.q = queue_init(capacity, example, device)
        self.push_policy = push_policy
        self.versions: list[int] = []          # oldest first
        self.offered = 0                       # windows pushed or dropped
        self.cond = threading.Condition()
        self._last: Optional[torch.cuda.Event] = None

    def __len__(self) -> int:
        return len(self.versions)

    @contextlib.contextmanager
    def _in_device_order(self):
        dev = self.q.version.device
        if dev.type != "cuda":
            yield
            return
        stream = torch.cuda.current_stream(dev)
        if self._last is not None:
            stream.wait_event(self._last)
        yield
        self._last = torch.cuda.Event()
        self._last.record(stream)

    def push(self, traj: Trajectory, version: int) -> bool:
        """Push a window stamped ``version``; False when dropped."""
        with self.cond, self._in_device_order():
            self.offered += 1
            queue_push(self.q, traj, version, policy=self.push_policy)
            if (self.push_policy == "drop"
                    and len(self.versions) >= self.q.capacity):
                return False
            self.versions.append(version)
            if len(self.versions) > self.q.capacity:   # overwrote oldest
                self.versions.pop(0)
            self.cond.notify_all()
            return True

    def pop(self):
        """(the oldest window, its version as an int)."""
        with self.cond, self._in_device_order():
            if not self.versions:
                raise IndexError("pop from an empty trajectory queue")
            traj, _, _ = queue_pop(self.q)
            return traj, self.versions.pop(0)

    def sample(self, generator: torch.Generator):
        """(a uniformly drawn window, its version as a 0-d tensor)."""
        with self.cond, self._in_device_order():
            if not self.versions:
                raise IndexError("sample from an empty trajectory queue")
            return queue_sample(self.q, generator)

    def peek_version(self) -> int:
        """Version stamp of the oldest entry (host mirror, no device op)."""
        with self.cond:
            if not self.versions:
                raise IndexError("peek on an empty trajectory queue")
            return self.versions[0]

    def wait(self, give_up, poll_s: float = 0.01) -> None:
        """Block until the queue holds a window or ``give_up()`` is true
        (polled every ``poll_s``)."""
        with self.cond:
            while not self.versions and not give_up():
                self.cond.wait(poll_s)


# ---------------------------------------------------------------------------
# Versioned params publication
# ---------------------------------------------------------------------------

class ParamBundle(NamedTuple):
    """What the learner publishes and the actor consumes.

    ``params`` is an :class:`IC3Net` the bundle owns (a copy of the
    learner's at publication, never written after), ``plans`` the
    PlanState certified against it, ``version`` the learner update count
    it was published at. ``ready`` (CUDA only) is an event recorded on the
    publishing stream after the copy and the certification; a reader on
    another stream waits on it (:func:`actor_rollout` does).
    """
    params: IC3Net
    plans: encoder.PlanState
    version: int
    ready: Optional[torch.cuda.Event] = None


def _certified(model: IC3Net, plans):
    if isinstance(plans, encoder.PlanState) and plans.plans:
        return encoder.refresh_if_stale(model.params, plans,
                                        model.encode_plans)
    return plans


def publish(model: IC3Net, plans, version: int) -> ParamBundle:
    """Stamp a new bundle: copy ``model``'s parameters into a module the
    bundle owns, then certify ``plans`` against the copy.

    The learner's plans may be stale relative to its just-updated
    parameters; ``encoder.refresh_if_stale`` re-encodes iff the grouping
    layout moved. Its signature check reads one value back to the host,
    so a publication costs one device sync on the learner's thread.
    """
    with torch.no_grad():
        snap = copy.deepcopy(model).requires_grad_(False)
        plans = _certified(snap, plans)
    ready = None
    if snap.device.type == "cuda":
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(snap.device))
    return ParamBundle(snap, plans, int(version), ready)


def adopt(bundle: ParamBundle) -> ParamBundle:
    """Actor-side swap gate: re-certify the incoming bundle's plans
    against its parameters (a signature pass when consistent, one
    re-encode when not)."""
    with torch.no_grad():
        return bundle._replace(plans=_certified(bundle.params, bundle.plans))


def bundle_consistent(bundle: ParamBundle) -> torch.Tensor:
    """0-d bool: do the bundle's plans certify against its parameters?
    (Trivially true off the grouped path.)"""
    plans = bundle.plans
    if not (isinstance(plans, encoder.PlanState) and plans.plans):
        return torch.ones((), dtype=torch.bool)
    with torch.no_grad():
        return encoder.plan_signature(bundle.params.params) == plans.sig


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _tensors(v)


def _read_on_current_stream(bundle: ParamBundle) -> None:
    """Order the current stream after the bundle's publication and keep
    the allocator from reusing its memory before this stream's reads."""
    if bundle.ready is None:
        return
    stream = torch.cuda.current_stream(bundle.params.device)
    stream.wait_event(bundle.ready)
    for t in (*bundle.params.parameters(), *_tensors(bundle.plans)):
        t.record_stream(stream)


# ---------------------------------------------------------------------------
# Actor and learner computations
# ---------------------------------------------------------------------------

def actor_rollout(bundle: ParamBundle, generator: torch.Generator, ecfg,
                  tcfg: train_mod.TrainConfig, env: Env) -> Trajectory:
    """One batched rollout window against a published bundle, on the
    current stream.

    The generator is consumed as the synchronous :func:`train.train`
    consumes it (the reset, then T steps of sampling), so with queue depth
    1 and ``correction="none"`` the pipeline trains on the very episodes
    the synchronous loop would have.
    """
    contracts.record("actor_rollout", bundle.params.params, bundle.plans,
                     static=(tcfg.batch, ecfg.max_steps))
    _read_on_current_stream(bundle)
    r = train_mod.rollout(bundle.params, env, ecfg, generator, tcfg.batch,
                          bundle.plans, collect=True)
    # the learner re-derives value, entropy and gate_logp from its params
    return Trajectory(obs=r.obs, act=r.action, gates=r.gate, rew=r.reward,
                      logp=r.logp, succ=r.success)


def replay_terms(model: IC3Net, traj: Trajectory, plans=None):
    """Re-unroll the policy over a stored window with the *learner's*
    parameters: (logp, val, ent, gate_logp), each (B, T, A), with autograd
    on.

    The per-step math is the rollout's (``IC3Net.policy_step`` and
    ``train._policy_terms``) with the stored gate decisions replayed,
    ``gate_in[t] = gates[t-1]`` (ones at t = 0, as ``initial_state``), so
    at equal parameters the outputs are bitwise the rollout's and the
    gradients see the graph the synchronous loss differentiates.
    """
    gate_in = torch.cat([torch.ones_like(traj.gates[:, :1]),
                         traj.gates[:, :-1]], dim=1)
    hc, _ = model.initial_state(traj.act.shape[0])
    outs = []
    for t in range(traj.act.shape[1]):
        logits, value, gate_logits, hc = model.policy_step(
            traj.obs[:, t], hc, gate_in[:, t], plans)
        logp_a, entropy, gate_logp = train_mod._policy_terms(
            logits, gate_logits, traj.act[:, t], traj.gates[:, t])
        outs.append((logp_a, value, entropy, gate_logp))
    logp, val, ent, gate_logp = (torch.stack(col, dim=1)
                                 for col in zip(*outs))
    return logp, val, ent, gate_logp


def vtrace(target_logp, behavior_logp, rew, val, *, gamma: float,
           rho_clip: float = 1.0, c_clip: float = 1.0):
    """V-trace targets (Espeholt et al. '18) over (B, T, A) tensors.

    Bootstraps with V_T = 0: the windows are fixed-length episodes whose
    rewards are zeroed after ``done``. At staleness 0 (ratios exactly 1,
    clips >= 1) the recursion telescopes to the Monte-Carlo returns:
    ``vs_t = r_t + gamma * vs_{t+1}`` and ``pg_adv = returns - val``.

    Returns ``(vs, pg_adv, rho)``; gradients are *not* stopped here (the
    caller stops them; the loss needs ``val`` live elsewhere).
    """
    ratio = torch.exp(target_logp - behavior_logp)
    rho = torch.clamp(ratio, max=rho_clip)
    c = torch.clamp(ratio, max=c_clip)
    v_next = torch.cat([val[:, 1:], torch.zeros_like(val[:, :1])], dim=1)
    delta = rho * (rew + gamma * v_next - val)
    acc = torch.zeros_like(val[:, 0])
    err = []
    for t in range(val.shape[1] - 1, -1, -1):
        acc = delta[:, t] + gamma * c[:, t] * acc
        err.append(acc)
    vs = torch.stack(err[::-1], dim=1) + val          # vs_t - V_t, + V_t
    vs_next = torch.cat([vs[:, 1:], torch.zeros_like(vs[:, :1])], dim=1)
    pg_adv = rho * (rew + gamma * vs_next - val)
    return vs, pg_adv, rho


def learner_loss(model: IC3Net, traj: Trajectory,
                 tcfg: train_mod.TrainConfig, acfg: AsyncConfig, plans=None):
    """Loss of one window under ``acfg.correction``: (loss, metrics).

    ``"none"`` routes the replayed terms through the synchronous
    :func:`train.a2c_terms`. ``"vtrace"`` swaps the Monte-Carlo returns
    for V-trace targets; ``"clip"`` keeps them but scales the policy
    gradient by one-sided clipped importance weights. ``.detach()``
    stands where JAX has ``stop_gradient``.
    """
    logp, val, ent, gate_logp = replay_terms(model, traj, plans)
    if acfg.correction == "none":
        return train_mod.a2c_terms(traj.rew, logp, val, ent, gate_logp,
                                   traj.gates, traj.succ, tcfg)
    if acfg.correction == "vtrace":
        vs, pg_adv, rho = vtrace(logp, traj.logp, traj.rew, val,
                                 gamma=tcfg.gamma, rho_clip=acfg.rho_clip,
                                 c_clip=acfg.c_clip)
        pg = -(logp * pg_adv.detach()).mean()
        vloss = ((vs.detach() - val) ** 2).mean()
    else:                                     # "clip"
        adv = train_mod.discounted_returns(traj.rew, tcfg.gamma) - val
        rho = torch.clamp(torch.exp(logp - traj.logp), max=acfg.rho_clip)
        pg = -(logp * (rho * adv).detach()).mean()
        vloss = (adv ** 2).mean()
    eloss = -ent.mean()
    gloss = traj.gates.mean()
    loss = pg + tcfg.value_coef * vloss + tcfg.entropy_coef * eloss \
        + tcfg.gate_coef * gloss
    return loss, {"success": traj.succ.float().mean(),
                  "return": traj.rew.sum(1).mean(), "loss": loss,
                  "mean_is": rho.detach().mean()}


def learner_update(model: IC3Net, opt_state, traj: Trajectory,
                   tcfg: train_mod.TrainConfig, acfg: AsyncConfig,
                   plans=None):
    """One learner step on one window: the loss, its gradients and an
    RMSprop step at ``tcfg.lr``, applied to the model's parameters and
    ``opt_state`` in place. Returns (opt_state, metrics), the metrics as
    0-d tensors on the model's device."""
    contracts.record("learner_update", model.params, opt_state, traj, plans,
                     static=(tcfg.batch,))
    loss, metrics = learner_loss(model, traj, tcfg, acfg, plans)
    grads = train_mod.param_grads(model, loss)
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["mask_sparsity"] = train_mod._mean_mask_sparsity(model)
    rmsprop(model.params, grads, opt_state, lr=tcfg.lr)
    return opt_state, metrics


# ---------------------------------------------------------------------------
# The pipeline driver
# ---------------------------------------------------------------------------

def _check_publication(bundle: ParamBundle) -> None:
    if not bool(bundle_consistent(bundle)):
        raise RuntimeError("published params/PlanState signature mismatch "
                           f"at version {bundle.version}")


def async_train(cfg: IC3NetConfig, ecfg=None,
                tcfg: Optional[train_mod.TrainConfig] = None,
                acfg: Optional[AsyncConfig] = None, updates: int = 100,
                seed: int = 0, log_every: int = 0,
                env: str | Env = "predator_prey", schedule=None,
                threads: bool = False, check_publication: bool = False,
                debug_contracts: bool = False, device=None):
    """Run the decoupled pipeline for ``updates`` learner steps.

    Runs on the CUDA card unless ``device="cpu"``. Returns ``(model,
    history)`` like :func:`train.train`; each history entry carries
    ``success``, ``return``, ``loss``, ``mask_sparsity`` (and ``mean_is``
    under a correction), ``staleness`` (version lag of the consumed
    window), ``queue_depth`` and the decoupled throughput pair:
    ``env_steps_per_s`` counts *generated* env steps (the actor clock),
    ``updates_per_s`` the learner clock (``steps_per_s`` repeats it).

    The default driver interleaves deterministically (``acfg.actors``
    windows, then one learner step), its actor drawing from one generator
    seeded from ``seed`` in the synchronous loop's order: with depth 1 and
    ``correction="none"`` it is bitwise :func:`train.train`. ``threads=
    True`` runs the actor on its own thread, with its own generator and,
    on the card, its own CUDA stream; the interleaving is then
    nondeterministic. If the actor thread raises, the learner re-raises
    its exception.

    ``schedule.warmup_steps`` (the dense G-ramp) is a synchronous-loop
    feature and is rejected. ``debug_contracts=True`` runs the whole
    pipeline under :func:`repro_torch.analysis.contracts.no_retrace`: the
    actor rollout and the learner update may each run at one signature;
    a second (a shape instability) raises ``RetraceError``, on either
    thread.
    """
    if debug_contracts:
        with contracts.no_retrace(label="async_train"):
            return async_train(
                cfg, ecfg, tcfg, acfg, updates=updates, seed=seed,
                log_every=log_every, env=env, schedule=schedule,
                threads=threads, check_publication=check_publication,
                device=device)
    if isinstance(env, str):
        env = envs_mod.get(env)
    if ecfg is None:
        ecfg = env.config_cls()
    tcfg = tcfg or train_mod.TrainConfig()
    acfg = acfg or AsyncConfig()
    if schedule is not None and schedule.warmup_steps > 0:
        raise NotImplementedError(
            "async_train does not run the dense-warmup G-ramp; warm up "
            "with train.train(...) first, then continue async")
    dev = resolve_device(device)
    model, opt_state = train_mod._init(cfg, ecfg, env, seed, dev)
    with torch.no_grad():
        plans = model.encode_plans()
    actor_gen = torch.Generator(device=dev).manual_seed(seed)
    learner_gen = torch.Generator(device=dev).manual_seed(seed + _LEARNER_SEED)

    version = 0
    bundle = publish(model, plans, version)
    if check_publication:
        _check_publication(bundle)
    queue = QueueDriver(acfg.capacity, trajectory_spec(
        model.cfg, tcfg.batch, ecfg.max_steps), acfg.push_policy, dev)

    history: list[dict] = []
    pending: list = []    # (device metrics, staleness, depth) per update

    def flush_history():
        """Every pending update's metrics in one host fetch: the learner
        loop itself never waits for a metric value."""
        if not pending:
            return
        vals = [v for m, s, _ in pending for v in (*m.values(), s)
                if isinstance(v, torch.Tensor)]
        host = iter(torch.stack([v.float() for v in vals]).tolist())
        for m, stale, depth in pending:
            ms = {k: next(host) for k in m}
            ms["staleness"] = float(next(host) if isinstance(
                stale, torch.Tensor) else stale)
            ms["queue_depth"] = float(depth)
            history.append(ms)
        pending.clear()

    fallback_windows = 0
    stop = threading.Event()
    failure: list[BaseException] = []
    actor_thread = None
    if threads:
        thread_gen = torch.Generator(device=dev).manual_seed(
            seed + _THREAD_SEED)
        actor_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

        def actor_loop():
            try:
                with torch.cuda.stream(actor_stream):
                    while not stop.is_set():
                        if acfg.push_policy == "drop" \
                                and len(queue) >= acfg.capacity:
                            time.sleep(0)     # yield; the learner drains
                            continue
                        b = bundle            # publication swaps it
                        traj = actor_rollout(b, thread_gen, ecfg, tcfg, env)
                        queue.push(traj, b.version)
            except Exception as e:            # re-raised by the learner
                failure.append(e)

        actor_thread = threading.Thread(target=actor_loop,
                                        name="async_train-actor",
                                        daemon=True)

    def actor_failed() -> bool:
        return bool(failure) or not actor_thread.is_alive()

    t0 = time.perf_counter()
    if actor_thread:
        actor_thread.start()
    try:
        for it in range(updates):
            if not threads:
                for _ in range(acfg.actors):
                    queue.push(actor_rollout(bundle, actor_gen, ecfg, tcfg,
                                             env), bundle.version)
            else:
                queue.wait(actor_failed)      # wait for the actor clock
                if failure:
                    raise failure[0]
                if not len(queue):
                    raise RuntimeError("the actor thread stopped")
            # staleness bound first: evict windows over it (the host
            # mirror decides; versions are nondecreasing in FIFO order, so
            # draining the front leaves only fresh entries)
            while len(queue) \
                    and version - queue.peek_version() > acfg.max_staleness:
                queue.pop()
            traj = ver = None
            if len(queue):
                if acfg.sample == "random":
                    traj, ver = queue.sample(learner_gen)
                else:
                    traj, ver = queue.pop()
            if traj is None:
                # everything in flight was over the bound: generate an
                # on-policy window so the learner never starves
                # (a copy: the rollout's tensors are inference tensors)
                bundle = publish(model, plans, version)
                traj = Trajectory(*(x.clone() for x in actor_rollout(
                    bundle, learner_gen, ecfg, tcfg, env)))
                ver = version
                fallback_windows += 1
            plans = train_mod.maybe_refresh_plans(model, plans, it, schedule)
            opt_state, metrics = learner_update(model, opt_state, traj, tcfg,
                                                acfg, plans)
            version += 1
            if version % acfg.publish_every == 0:
                bundle = publish(model, plans, version)
                if check_publication:
                    _check_publication(bundle)
            pending.append((metrics, version - 1 - ver, len(queue)))
            if log_every and it % log_every == 0:
                flush_history()    # log boundary: one batched fetch
                print(f"update {it:5d} success "
                      f"{history[-1]['success']:.3f} return "
                      f"{history[-1]['return']:.3f} staleness "
                      f"{history[-1]['staleness']:.0f}")
    finally:
        stop.set()
        if actor_thread:
            actor_thread.join(timeout=60)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        flush_history()
    if actor_thread and actor_thread.is_alive():
        raise RuntimeError("the actor thread did not stop within 60 s")
    if failure:
        raise failure[0]
    dt = max(time.perf_counter() - t0, 1e-9)
    windows = queue.offered + fallback_windows
    env_rate = windows * tcfg.batch * ecfg.max_steps / dt
    upd_rate = updates / dt
    for ms in history:
        ms["env_steps_per_s"] = env_rate
        ms["updates_per_s"] = upd_rate
        ms["steps_per_s"] = upd_rate          # sync-history compatibility
    return model, history
