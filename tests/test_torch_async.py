"""The port's async actor/learner pipeline (``repro_torch.marl.async_train``)
against the JAX package's and against the port's synchronous learner.

Against JAX: the queue's metadata under the same push/pop sequences,
V-trace on seeded inputs, and the learner's replay, loss, gradients and
update on a window JAX's actor recorded (carried over by
``interop.trajectory_from_numpy``). Within the port: queue depth 1 with
``correction="none"`` is bitwise the synchronous ``train``; V-trace and
clip at staleness 0 land within 1e-5 of it; the staleness bound holds;
publication hands the actor its own certified copy; the actor never
encodes; the threaded driver respects its bounds and re-raises an actor
failure.
"""
import dataclasses
import functools
import socket
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite's workers share the host's cores

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.marl import async_train as jat  # noqa: E402
from repro.marl import envs as jenvs  # noqa: E402
from repro.marl import ic3net as jic3net  # noqa: E402
from repro.marl import train as jtrain  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.analysis import contracts  # noqa: E402
from repro_torch.core import encoder, grouped  # noqa: E402
from repro_torch.core.schedule import REFRESH_MODES, SparsitySchedule  # noqa
from repro_torch.launch import marl_async  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.marl import async_train as at  # noqa: E402
from repro_torch.marl import envs  # noqa: E402
from repro_torch.marl import ic3net, train  # noqa: E402

PP = envs.get("predator_prey")
ENV = dict(n_agents=2, size=3, vision=2, max_steps=6)
HIDDEN = 16
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4          # ||g_port - g_jax|| / ||g_jax|| per leaf
TERMS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-5, atol=1e-5)
CPU = "cpu"


def _ecfg(**kw):
    return PP.config_cls(**dict(ENV, **kw))


def _cfg(groups=1, hidden=HIDDEN):
    return ic3net.IC3NetConfig(hidden=hidden, flgw_groups=groups,
                               flgw_path="grouped" if groups > 1
                               else "masked")


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _assert_plans_equal(a, b):
    """Two PlanStates bitwise: the signature and every plan's fields."""
    assert int(a.sig) == int(b.sig)

    def walk(x, y):
        if isinstance(x, dict):
            assert x.keys() == y.keys()
            for k in x:
                walk(x[k], y[k])
        else:
            for u, v in zip(x, y):
                assert (u is None and v is None) or torch.equal(u, v)
    walk(a.plans, b.plans)


def _assert_models_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def _assert_models_close(a, b, **tol):
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        np.testing.assert_allclose(x.numpy(), y.numpy(), err_msg=k, **tol)


# -- trajectory queue (against JAX's) ----------------------------------------

def _items(i):
    """The same small window as a port and a JAX item (B=1, T=2, A=1)."""
    f = np.full((1, 2, 1), i, np.float32)
    arrays = dict(obs=np.full((1, 2, 1, 3), i, np.float32),
                  act=np.full((1, 2, 1), i, np.int32), gates=f, rew=f,
                  logp=f, succ=np.full((1,), i % 2 == 1))
    return (interop.trajectory_from_numpy(at.Trajectory(**arrays)),
            jat.Trajectory(**{k: jnp.asarray(v) for k, v in arrays.items()}))


def _spec():
    return _items(0)


def _meta(tq, jq):
    """The port's and JAX's (count, pushed, dropped, head) as ints."""
    return ([int(getattr(tq, f)) for f in ("count", "pushed", "dropped",
                                            "head")],
            [int(getattr(jq, f)) for f in ("count", "pushed", "dropped",
                                            "head")])


def _run_sequence(capacity, ops, policy="overwrite"):
    """Push ('push', i) and pop ('pop',) through both queues; the popped
    versions and item contents, and the metadata after every op."""
    tex, jex = _spec()
    tq = at.queue_init(capacity, tex)
    jq = jat.queue_init(capacity, jax.eval_shape(lambda: jex))
    popped = []
    for op in ops:
        if op[0] == "push":
            t_item, j_item = _items(op[1])
            tq = at.queue_push(tq, t_item, op[1], policy=policy)
            jq = jat.queue_push(jq, j_item, op[1], policy=policy)
        else:
            t_item, t_ver, tq = at.queue_pop(tq)
            j_item, j_ver, jq = jat.queue_pop(jq)
            assert int(t_ver) == int(j_ver)
            for name in at.Trajectory._fields:
                np.testing.assert_array_equal(
                    getattr(t_item, name).numpy(),
                    np.asarray(getattr(j_item, name)), err_msg=name)
            popped.append(int(t_ver))
        got, want = _meta(tq, jq)
        assert got == want, op
        np.testing.assert_array_equal(tq.version.numpy(),
                                      np.asarray(jq.version))
    return popped, tq


def test_queue_fifo_and_wraparound_matches_jax():
    popped, q = _run_sequence(3, [("push", i) for i in range(5)]
                              + [("pop",)] * 3)
    assert popped == [2, 3, 4]         # oldest two overwritten, FIFO out
    assert int(q.count) == 0 and int(q.pushed) == 5


def test_queue_drop_policy_rejects_when_full_matches_jax():
    popped, q = _run_sequence(2, [("push", i) for i in range(4)]
                              + [("pop",)] * 2, policy="drop")
    assert popped == [0, 1]            # the first two survived
    assert int(q.pushed) == 2 and int(q.dropped) == 2


def test_queue_pop_past_empty_clamps_matches_jax():
    popped, q = _run_sequence(2, [("push", 7), ("pop",), ("pop",),
                                  ("push", 8), ("pop",)])
    assert popped[0] == 7 and popped[-1] == 8 and int(q.count) == 0


def test_queue_sample_is_deterministic_and_uniform_over_valid():
    q = at.queue_init(4, _spec()[0])
    for i in range(6):                     # wraps: valid = {2, 3, 4, 5}
        q = at.queue_push(q, _items(i)[0], i)
    a, va = at.queue_sample(q, torch.Generator().manual_seed(0))
    b, vb = at.queue_sample(q, torch.Generator().manual_seed(0))
    assert int(va) == int(vb)              # same generator state, same draw
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert int(a.obs.flatten()[0]) == int(va)
    seen = {int(at.queue_sample(q, torch.Generator().manual_seed(s))[1])
            for s in range(64)}
    assert seen == {2, 3, 4, 5}            # never a dead slot, every live one
    assert int(q.count) == 4               # sampling does not consume


def test_queue_driver_mirrors_device_metadata():
    drv = at.QueueDriver(2, _spec()[0], push_policy="overwrite")
    for i in range(3):
        assert drv.push(_items(i)[0], i)
    assert len(drv) == 2 == int(drv.q.count) and drv.offered == 3
    assert drv.peek_version() == 1         # 0 was overwritten
    traj, ver = drv.pop()
    assert ver == 1 and len(drv) == 1 == int(drv.q.count)
    assert int(traj.act.flatten()[0]) == 1
    drop = at.QueueDriver(1, _spec()[0], push_policy="drop")
    assert drop.push(_items(0)[0], 0) and not drop.push(_items(1)[0], 1)
    assert drop.versions == [0] and int(drop.q.dropped) == 1
    with pytest.raises(IndexError):
        at.QueueDriver(1, _spec()[0], "overwrite").pop()


def test_queue_driver_loses_no_update_under_thread_contention():
    """More pushing threads than cores and a popping one, with a short
    switch interval: every pushed window is popped exactly once with its
    own contents, and the host mirror and the device count agree."""
    import os
    import sys
    pushers, each = (os.cpu_count() or 1) + 2, 8
    total = pushers * each
    drv = at.QueueDriver(total, _spec()[0], push_policy="drop")
    popped, errors = [], []

    def push(k):
        try:
            for i in range(each):
                assert drv.push(_items(k * each + i)[0], k * each + i)
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(e)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=push, args=(k,))
                   for k in range(pushers)]
        for t in threads:
            t.start()
        while len(popped) < total and not errors:
            drv.wait(lambda: bool(errors))
            if len(drv):
                traj, ver = drv.pop()
                popped.append((ver, int(traj.act.flatten()[0])))
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert sorted(v for v, _ in popped) == list(range(total))
    assert all(v == content for v, content in popped)
    assert len(drv) == 0 == int(drv.q.count)
    assert int(drv.q.pushed) == total == drv.offered


def test_popped_window_is_a_copy_of_its_slot():
    """A window made under inference mode (as the actor's rollout is)
    pops as an ordinary tensor autograd may save, and a later push into
    the same slot leaves it as it was."""
    q = at.queue_init(1, _spec()[0])
    with torch.inference_mode():
        made = at.Trajectory(*(x.clone() for x in _items(3)[0]))
    q = at.queue_push(q, made, 3)
    item, _, q = at.queue_pop(q)
    w = torch.ones_like(item.obs, requires_grad=True)
    (item.obs * w).sum().backward()
    q = at.queue_push(q, _items(9)[0], 9)
    assert not item.obs.is_inference()
    assert int(item.obs.flatten()[0]) == 3 and float(w.grad.sum()) == 18


# -- the synchronous learner's refresh is the encoder's ------------------------

def test_maybe_refresh_plans_is_pure_delegate():
    """The synchronous and async learners drive one refresh: the port's
    ``train.maybe_refresh_plans`` is bitwise ``encoder.maybe_refresh`` for
    every refresh mode, on moved and unmoved layouts."""
    model, _ = train._init(_cfg(4, hidden=8), _ecfg(), PP, 0, CPU)
    with torch.no_grad():
        plans = model.encode_plans()
    moved, _ = train._init(_cfg(4, hidden=8), _ecfg(), PP, 0, CPU)
    with torch.no_grad():
        for _, p in grouped.iter_flgw_layers(moved.params):
            p["ig"].neg_()
            p["og"].neg_()
    schedules = [None] + [SparsitySchedule(groups=4, refresh_every=3,
                                           refresh=m) for m in REFRESH_MODES]
    for sched in schedules:
        for it in (0, 1, 3):
            for m in (model, moved):
                got = train.maybe_refresh_plans(m, plans, it, sched)
                want = encoder.maybe_refresh(m.params, plans, it,
                                             m.cfg.flgw, sched)
                _assert_plans_equal(got, want)


# -- correction = none: bitwise the synchronous learner ------------------------

@pytest.mark.parametrize("groups", [1, 4])
def test_depth1_no_correction_bitwise_matches_sync_train(groups):
    """Queue depth 1, one window per update, correction off: the pipeline
    IS the synchronous ``train``, bitwise, dense and grouped."""
    tcfg = train.TrainConfig(batch=4)
    acfg = at.AsyncConfig(capacity=1, actors=1, correction="none")
    m_async, h_async = at.async_train(_cfg(groups), _ecfg(), tcfg, acfg,
                                      updates=3, seed=0,
                                      check_publication=True, device=CPU)
    m_sync, h_sync = train.train(_cfg(groups), _ecfg(), tcfg, iterations=3,
                                 seed=0, device=CPU)
    _assert_models_equal(m_async, m_sync)
    for key in ("loss", "success", "return", "mask_sparsity"):
        assert [h[key] for h in h_async] == [h[key] for h in h_sync], key
    assert all(h["staleness"] == 0 for h in h_async)


def test_replay_terms_reproduce_rollout_terms_at_equal_params():
    """The learner's re-unroll over a stored window is the rollout's
    graph: at equal params (logp, val, ent, gate_logp) are bitwise the
    actor's."""
    model, _ = train._init(_cfg(4), _ecfg(), PP, 0, CPU)
    with torch.no_grad():
        plans = model.encode_plans()
    r = train.rollout(model, PP, _ecfg(), train.make_generator(1, CPU), 4,
                      plans, collect=True)
    # copies, as the queue hands them over: rollout's are inference tensors
    traj = at.Trajectory(*(x.clone() for x in (
        r.obs, r.action, r.gate, r.reward, r.logp, r.success)))
    got = at.replay_terms(model, traj, plans)
    for g, want in zip(got, (r.logp, r.value, r.entropy, r.gate_logp)):
        assert torch.equal(g.detach(), want)


# -- V-trace -------------------------------------------------------------------

@pytest.mark.parametrize("off_policy", [False, True])
@pytest.mark.parametrize("clip", [1.0, 0.5])
def test_vtrace_matches_jax(off_policy, clip):
    rng = np.random.default_rng(3)
    rew, val, logp = (rng.standard_normal((3, 7, 2)).astype(np.float32)
                      for _ in range(3))
    behav = (logp + 0.3 * rng.standard_normal((3, 7, 2)).astype(np.float32)
             if off_policy else logp)
    kw = dict(gamma=0.9, rho_clip=clip, c_clip=clip)
    got = at.vtrace(*(torch.from_numpy(v) for v in (logp, behav, rew, val)),
                    **kw)
    want = jat.vtrace(*(jnp.asarray(v) for v in (logp, behav, rew, val)),
                      **kw)
    for name, g, w in zip(("vs", "pg_adv", "rho"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


def test_vtrace_on_policy_reduces_to_mc_returns():
    rng = np.random.default_rng(0)
    rew, val, logp = (torch.from_numpy(
        rng.standard_normal((3, 7, 2)).astype(np.float32)) for _ in range(3))
    vs, pg_adv, rho = at.vtrace(logp, logp, rew, val, gamma=0.9)
    assert torch.equal(rho, torch.ones_like(rho))
    returns = train.discounted_returns(rew, 0.9)
    torch.testing.assert_close(vs, returns, rtol=0, atol=1e-5)
    torch.testing.assert_close(pg_adv, returns - val, rtol=0, atol=1e-5)


@pytest.mark.parametrize("correction,groups", [("vtrace", 4), ("clip", 1)])
def test_correction_at_staleness0_matches_sync_update(correction, groups):
    """V-trace and clip at depth 1, publishing every update (staleness 0
    throughout, every importance weight exactly 1) land within 1e-5 of
    the synchronous params: not bitwise, since the V-trace target
    associates its reductions differently."""
    tcfg = train.TrainConfig(batch=4)
    acfg = at.AsyncConfig(capacity=1, actors=1, correction=correction)
    m_async, h_async = at.async_train(_cfg(groups), _ecfg(), tcfg, acfg,
                                      updates=2, seed=0, device=CPU)
    m_sync, h_sync = train.train(_cfg(groups), _ecfg(), tcfg, iterations=2,
                                 seed=0, device=CPU)
    assert all(h["staleness"] == 0 for h in h_async)
    assert all(h["mean_is"] == 1.0 for h in h_async)
    np.testing.assert_allclose([h["loss"] for h in h_async],
                               [h["loss"] for h in h_sync], rtol=1e-5)
    _assert_models_close(m_async, m_sync, rtol=1e-5, atol=1e-5)


def test_vtrace_training_reaches_sync_reward_under_staleness():
    """With real staleness (publish every 2 updates, depth 2) V-trace
    training lands in the synchronous run's success band at equal
    budget, and learns at all."""
    cfg, tcfg = _cfg(hidden=32), train.TrainConfig(batch=16)
    acfg = at.AsyncConfig(capacity=2, actors=1, correction="vtrace",
                          publish_every=2, max_staleness=4)
    _, h_s = train.train(cfg, _ecfg(), tcfg, iterations=40, seed=1,
                         device=CPU)
    _, h_a = at.async_train(cfg, _ecfg(), tcfg, acfg, updates=40, seed=1,
                            device=CPU)
    assert max(h["staleness"] for h in h_a) >= 1   # genuinely off-policy
    sync_last = np.mean([h["success"] for h in h_s[-10:]])
    async_last = np.mean([h["success"] for h in h_a[-10:]])
    assert async_last >= sync_last - 0.1
    assert async_last >= np.mean([h["success"] for h in h_a[:5]]) - 0.05


# -- staleness bound -----------------------------------------------------------

def test_learner_never_consumes_over_the_staleness_bound():
    acfg = at.AsyncConfig(capacity=8, actors=3, correction="vtrace",
                          max_staleness=1, publish_every=2)
    _, hist = at.async_train(_cfg(), _ecfg(), train.TrainConfig(batch=2),
                             acfg, updates=8, seed=0, device=CPU)
    assert len(hist) == 8
    assert max(h["staleness"] for h in hist) <= 1
    assert max(h["staleness"] for h in hist) == 1


def test_max_staleness_zero_forces_on_policy():
    acfg = at.AsyncConfig(capacity=4, actors=2, correction="vtrace",
                          max_staleness=0, publish_every=3)
    _, hist = at.async_train(_cfg(), _ecfg(), train.TrainConfig(batch=2),
                             acfg, updates=6, seed=0, device=CPU)
    assert all(h["staleness"] == 0 for h in hist)
    assert all(h["mean_is"] == 1.0 for h in hist)


def test_random_sampling_respects_the_bound_and_keeps_the_actor_stream():
    """``sample="random"`` draws from the learner's generator, so the
    actor's generator goes through the FIFO run's states: every window
    starts from the same reset."""
    seen = {}
    real = at.actor_rollout

    def recording(bundle, gen, *a):
        traj = real(bundle, gen, *a)
        seen.setdefault(sample, []).append(traj.obs[:, 0].clone())
        return traj
    for sample in ("fifo", "random"):
        acfg = at.AsyncConfig(capacity=4, actors=1, max_staleness=2,
                              publish_every=2, sample=sample)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(at, "actor_rollout", recording)
            _, hist = at.async_train(_cfg(), _ecfg(),
                                     train.TrainConfig(batch=2), acfg,
                                     updates=6, seed=0, device=CPU)
        assert max(h["staleness"] for h in hist) <= 2
    assert len(seen["fifo"]) == len(seen["random"]) == 6
    assert all(torch.equal(a, b) for a, b in zip(seen["fifo"],
                                                  seen["random"]))


# -- plan-consistent publication -----------------------------------------------

def _grouped_model():
    model, opt = train._init(_cfg(4), _ecfg(), PP, 0, CPU)
    with torch.no_grad():
        plans = model.encode_plans()
    return model, opt, plans


def _move_layouts(model):
    with torch.no_grad():
        for _, p in grouped.iter_flgw_layers(model.params):
            p["ig"].neg_()
            p["og"].neg_()




def test_publish_certifies_plans_against_params():
    """Publishing moved params with the old PlanState hands the actor
    plans bitwise a fresh encode of the new params."""
    model, _, plans = _grouped_model()
    _move_layouts(model)
    bundle = at.publish(model, plans, 1)
    assert bool(at.bundle_consistent(bundle)) and bundle.version == 1
    with torch.no_grad():
        _assert_plans_equal(bundle.plans, model.encode_plans())


def test_publish_hands_the_actor_its_own_copy():
    """A learner update after publication leaves the bundle's tensors as
    they were published: the bundle owns a copy, not the learner's."""
    model, opt, plans = _grouped_model()
    bundle = at.publish(model, plans, 0)
    published = _state(bundle.params)
    assert all(torch.equal(published[k], v)
               for k, v in model.state_dict().items())
    assert not any(a.data_ptr() == b.data_ptr() for a, b in zip(
        bundle.params.parameters(), model.parameters()))
    traj = at.actor_rollout(bundle, train.make_generator(0, CPU), _ecfg(),
                            train.TrainConfig(batch=2), PP)
    traj = at.Trajectory(*(x.clone() for x in traj))   # as the queue does
    at.learner_update(model, opt, traj, train.TrainConfig(batch=2),
                      at.AsyncConfig(), plans)
    assert any(not torch.equal(published[k], v)
               for k, v in model.state_dict().items())
    for k, v in bundle.params.state_dict().items():
        assert torch.equal(published[k], v), k


def test_adopt_heals_a_mismatched_bundle():
    model, _, plans = _grouped_model()
    good = at.publish(model, plans, 0)
    same = at.adopt(good)
    _assert_plans_equal(same.plans, good.plans)
    _move_layouts(model)
    bad = at.publish(model, plans, 1)._replace(plans=plans)
    assert not bool(at.bundle_consistent(bad))
    healed = at.adopt(bad)
    assert bool(at.bundle_consistent(healed))
    with torch.no_grad():
        _assert_plans_equal(healed.plans, model.encode_plans())


def test_actor_rollout_calls_make_plan_zero_times(monkeypatch):
    """The actor only consumes published plans: a rollout against a
    certified bundle never builds one."""
    model, _, plans = _grouped_model()
    bundle = at.publish(model, plans, 0)
    calls = []
    real = grouped.make_plan

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(grouped, "make_plan", counting)
    at.actor_rollout(bundle, train.make_generator(0, CPU), _ecfg(),
                     train.TrainConfig(batch=2), PP)
    assert calls == []
    at.publish(model, encoder.encode_plans(model.params, model.cfg.flgw), 1)
    assert len(calls) == 5                 # the counter does see an encode


def test_async_train_check_publication_holds_across_versions(monkeypatch):
    """Every bundle of a short grouped run certifies; a corrupted one
    raises in `async_train`."""
    acfg = at.AsyncConfig(capacity=2, actors=1, publish_every=2)
    _, hist = at.async_train(_cfg(4), _ecfg(), train.TrainConfig(batch=2),
                             acfg, updates=4, seed=0,
                             check_publication=True, device=CPU)
    assert len(hist) == 4
    monkeypatch.setattr(at, "bundle_consistent",
                        lambda b: torch.tensor(b.version < 2))
    with pytest.raises(RuntimeError, match="mismatch at version 2"):
        at.async_train(_cfg(4), _ecfg(), train.TrainConfig(batch=2), acfg,
                       updates=4, seed=0, check_publication=True,
                       device=CPU)


def test_async_rejects_warmup_and_debug_contracts():
    """The warmup G-ramp is rejected. ``debug_contracts`` no longer is
    (the name is kept from when it raised): the run goes under
    ``contracts.no_retrace``, gives the unguarded run's history, and a
    window of another batch size mid-run raises ``RetraceError``."""
    sched = SparsitySchedule(groups=4, refresh_every=1, warmup_steps=5)
    with pytest.raises(NotImplementedError, match="warm up"):
        at.async_train(_cfg(4), _ecfg(), train.TrainConfig(batch=2),
                       schedule=sched, updates=1, device=CPU)
    with contracts.no_retrace() as mon:
        guarded = at.async_train(_cfg(4), _ecfg(), train.TrainConfig(batch=2),
                                 updates=2, debug_contracts=True,
                                 device=CPU)[1]
    assert mon.counts() == {"actor_rollout": 1, "learner_update": 1}
    plain = at.async_train(_cfg(4), _ecfg(), train.TrainConfig(batch=2),
                           updates=2, device=CPU)[1]
    assert [h["loss"] for h in guarded] == [h["loss"] for h in plain]
    real = at.actor_rollout
    calls = []

    def unstable(*a):
        calls.append(1)       # a step whose signature moves every call
        contracts.record("actor_rollout", static=(len(calls),))
        return real(*a)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(at, "actor_rollout", unstable)
        with pytest.raises(contracts.RetraceError, match="actor_rollout"):
            at.async_train(_cfg(4), _ecfg(), train.TrainConfig(batch=2),
                           updates=3, debug_contracts=True, device=CPU)


# -- the threaded driver -------------------------------------------------------

def _actor_threads():
    return [t for t in threading.enumerate()
            if t.name == "async_train-actor"]


@pytest.mark.parametrize("policy", ["overwrite", "drop"])
def test_threaded_pipeline_runs_and_respects_bounds(policy):
    acfg = at.AsyncConfig(capacity=4, actors=1, correction="vtrace",
                          max_staleness=2, publish_every=1,
                          push_policy=policy)
    _, hist = at.async_train(_cfg(4), _ecfg(), train.TrainConfig(batch=2),
                             acfg, updates=5, seed=0, threads=True,
                             check_publication=True, device=CPU)
    assert len(hist) == 5
    assert max(h["staleness"] for h in hist) <= 2
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert _actor_threads() == []          # the actor thread joined


def test_actor_thread_exception_is_reraised(monkeypatch):
    """An actor failure reaches the learner, which re-raises it rather
    than waiting for a window that never comes."""
    def broken(*a, **kw):
        raise ValueError("actor blew up")
    monkeypatch.setattr(at, "actor_rollout", broken)
    with pytest.raises(ValueError, match="actor blew up"):
        at.async_train(_cfg(), _ecfg(), train.TrainConfig(batch=2),
                       updates=3, seed=0, threads=True, device=CPU)
    assert _actor_threads() == []


def test_async_config_validates_and_matches_jax():
    assert dataclasses.asdict(at.AsyncConfig()) == dataclasses.asdict(
        jat.AsyncConfig())
    assert at.CORRECTIONS == jat.CORRECTIONS
    with pytest.raises(ValueError, match="correction"):
        at.AsyncConfig(correction="nope")
    with pytest.raises(ValueError, match="push_policy"):
        at.AsyncConfig(push_policy="nope")
    with pytest.raises(ValueError, match="sample"):
        at.AsyncConfig(sample="nope")
    with pytest.raises(ValueError, match=">= 1"):
        at.AsyncConfig(capacity=0)


def test_launcher_runs_on_the_cpu_and_refuses_distributed(capsys,
                                                          monkeypatch):
    _, hist = marl_async.main(["--device", "cpu", "--updates", "3",
                               "--agents", "2", "--size", "3", "--hidden",
                               "16", "--batch", "2", "--groups", "4",
                               "--path", "grouped", "--cadence", "2",
                               "--check-publication"])
    assert len(hist) == 3 and "env-steps/s" in capsys.readouterr().out
    # --distributed without a coordinator runs as one process (the
    # coordinator flags alone change nothing, as in the reference)
    for var in ("JAX_COORDINATOR", "COORDINATOR_ADDRESS", "MASTER_ADDR",
                "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    tiny = ["--device", "cpu", "--updates", "1", "--agents", "2", "--size",
            "3", "--hidden", "16", "--batch", "2"]
    for flags in (["--distributed"], ["--coordinator", "h:1"],
                  ["--processes", "2"], ["--process-id", "0"],
                  ["--strict-distributed"]):
        _, hist = marl_async.main([*tiny, *flags])
        out = capsys.readouterr().out
        assert len(hist) == 1
        assert ("distributed: False process 0/1" in out) == \
            (flags == ["--distributed"])
    assert not torch.distributed.is_initialized()
    # --strict-distributed with a coordinator nobody serves raises
    monkeypatch.setattr(mesh_lib, "RENDEZVOUS_TIMEOUT_S", 1.0)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with pytest.raises(Exception):
        marl_async.main([*tiny, "--distributed", "--coordinator",
                         f"127.0.0.1:{port}", "--processes", "2",
                         "--process-id", "1", "--strict-distributed"])
    assert not torch.distributed.is_initialized()


# -- the learner against JAX's on a window JAX's actor recorded ----------------

B = 3


@functools.lru_cache(maxsize=None)
def _jax_window(groups):
    """JAX's init, plans, one actor window (numpy trees), a second params
    version one learner update later (so the window is off-policy for
    it) and its RMSprop state."""
    env, ecfg = jenvs.make("predator_prey", **ENV)
    jcfg, key, params, opt = jtrain._init(
        jic3net.IC3NetConfig(hidden=HIDDEN, flgw_groups=groups,
                             flgw_path="grouped" if groups > 1
                             else "masked"), ecfg, env, 0)
    tcfg = jtrain.TrainConfig(batch=B)
    plans = jtrain._encode_plans(params, jcfg)
    traj = jat._jit_actor(params, key, jcfg, ecfg, tcfg, env, plans)
    params1, opt1, _ = jat._jit_update(
        params, opt, traj, jcfg, tcfg, jat.AsyncConfig(correction="none"),
        plans)
    plans1 = jtrain._encode_plans(params1, jcfg)
    return jcfg, params, plans, traj, params1, opt1, plans1


def _port(jcfg, params, opt=None):
    model, topt = interop.ic3net_from_numpy(
        ic3net.IC3NetConfig(**dataclasses.asdict(jcfg)),
        jax.tree.map(np.asarray, params),
        None if opt is None else jax.tree.map(np.asarray, opt), device=CPU)
    with torch.no_grad():
        plans = model.encode_plans()
    return model, topt, plans


def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _fault_mask(leaf, shape, grouped_path):
    """True at the entries the reference's make_plan fault moves on the
    grouped path (ROADMAP Queue 3): ig[M-1, :], og[:, N-1]."""
    mask = np.zeros(shape, bool)
    if grouped_path and leaf == "ig":
        mask[-1, :] = True
    if grouped_path and leaf == "og":
        mask[:, -1] = True
    return mask


@pytest.mark.parametrize("groups", [1, 4])
def test_replay_terms_match_jax_on_a_jax_window(groups):
    jcfg, params, jplans, jtraj, *_ = _jax_window(groups)
    model, _, plans = _port(jcfg, params)
    if groups > 1:
        assert int(plans.sig) == int(np.asarray(jplans.sig))
    traj = interop.trajectory_from_numpy(jax.tree.map(np.asarray, jtraj))
    assert traj.act.dtype == torch.int64 and traj.succ.dtype == torch.bool
    want = jax.jit(jat.replay_terms, static_argnums=1)(params, jcfg, jtraj,
                                                       jplans)
    got = at.replay_terms(model, traj, plans)
    for name, g, w in zip(("logp", "val", "ent", "gate_logp"), got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   err_msg=name, **TERMS_TOL)
    # the replay at the actor's own params gives back its behavior logp
    np.testing.assert_allclose(got[0].detach().numpy(),
                               np.asarray(jtraj.logp), **TERMS_TOL)


@functools.partial(jax.jit, static_argnames=("cfg", "tcfg", "acfg"))
def _jax_loss_grads(params, traj, plans, cfg, tcfg, acfg):
    return jax.value_and_grad(jat.learner_loss, has_aux=True)(
        params, traj, cfg, tcfg, acfg, plans)


@pytest.mark.parametrize("correction", ["none", "clip", "vtrace"])
def test_learner_loss_matches_jax(correction):
    """The loss of a window one update off-policy, G=4 grouped: within
    1e-5, every gradient within 1e-4 relative norm (the reference's
    fault entries excluded), the gate head's exactly 0 on both sides."""
    jcfg, _, _, jtraj, params1, _, jplans1 = _jax_window(4)
    model, _, plans = _port(jcfg, params1)
    traj = interop.trajectory_from_numpy(jax.tree.map(np.asarray, jtraj))
    jt, tt = jtrain.TrainConfig(batch=B), train.TrainConfig(batch=B)
    acfg = at.AsyncConfig(correction=correction, rho_clip=1.0, c_clip=1.0)
    (jl, jm), jg = _jax_loss_grads(params1, jtraj, jplans1, cfg=jcfg,
                                   tcfg=jt, acfg=jat.AsyncConfig(
                                       **dataclasses.asdict(acfg)))
    loss, tm = at.learner_loss(model, traj, tt, acfg, plans)
    tg = train.param_grads(model, loss)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    assert tm.keys() == jm.keys()
    for k in tm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    if correction != "none":
        assert float(tm["mean_is"]) < 1.0   # the window is off-policy
    jflat = dict(_leaves(jax.tree.map(np.asarray, jg)))
    tflat = dict(_leaves(interop.tree_to_numpy(tg)))
    assert tflat.keys() == jflat.keys()
    for path, want in jflat.items():
        got = tflat[path]
        if path[0] == "gate":
            assert not want.any() and not got.any(), path
            continue
        keep = ~_fault_mask(path[-1], want.shape, True)
        rel = np.linalg.norm(got[keep] - want[keep]) / np.linalg.norm(
            want[keep])
        assert rel <= GRAD_REL, f"{path}: relative difference {rel}"


def test_learner_update_matches_jax():
    """One V-trace update from the second params version and its RMSprop
    state: every parameter within 1e-5 (the fault entries excluded), the
    metrics within 1e-5."""
    jcfg, _, _, jtraj, params1, opt1, jplans1 = _jax_window(4)
    model, opt, plans = _port(jcfg, params1, opt1)
    traj = interop.trajectory_from_numpy(jax.tree.map(np.asarray, jtraj))
    acfg = at.AsyncConfig(correction="vtrace")
    jp, _, jm = jat._jit_update(params1, opt1, jtraj, jcfg,
                                jtrain.TrainConfig(batch=B),
                                jat.AsyncConfig(**dataclasses.asdict(acfg)),
                                jplans1)
    _, tm = at.learner_update(model, opt, traj, train.TrainConfig(batch=B),
                              acfg, plans)
    for k in tm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    tflat = dict(_leaves(interop.tree_to_numpy(model.params)))
    for path, want in _leaves(jax.tree.map(np.asarray, jp)):
        keep = ~_fault_mask(path[-1], want.shape, True)
        np.testing.assert_allclose(tflat[path][keep], want[keep],
                                   err_msg="/".join(path), **PARAM_TOL)
