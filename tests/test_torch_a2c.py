"""The port's IC3Net A2C learner against the JAX package's: the loss
terms, one train step on the masked, grouped and dense (G=1) paths and
the dense warmup, each from JAX-initialised params and JAX's own sampled
episodes, replayed by the port; the train loop's plan refreshes and its
history."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite's workers share the host's cores

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.core.schedule import SparsitySchedule as JSchedule  # noqa: E402
from repro.marl import envs as jenvs  # noqa: E402
from repro.marl import ic3net as jic3net  # noqa: E402
from repro.marl import train as jtrain  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import encoder  # noqa: E402
from repro_torch.core.schedule import SparsitySchedule  # noqa: E402
from repro_torch.marl import envs as tenvs  # noqa: E402
from repro_torch.marl import ic3net as tic3net  # noqa: E402
from repro_torch.marl import train as ttrain  # noqa: E402
from repro_torch.marl.envs import predator_prey as tpp  # noqa: E402

ENV = dict(n_agents=3, size=4, vision=1, max_steps=6)
B = 4
HIDDEN = 16
METRIC_RTOL = 1e-5
GRAD_REL = 1e-4          # ||g_port - g_jax|| / ||g_jax|| per leaf
# RMSprop's first step is ~10 lr sign(g): a gradient at rounding level
# whose sign the two sides disagree on moves its parameter by ~2e-2, so
# params are compared where |g| exceeds this share of the leaf's max
STEP_GRAD_FLOOR = 1e-6
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)

_JIT_STATICS = ("cfg", "ecfg", "tcfg", "env", "schedule")


@functools.partial(jax.jit, static_argnames=_JIT_STATICS)
def _jax_loss_grads(params, key, it, plans, cfg, ecfg, tcfg, env, schedule):
    return jtrain._loss_grads(params, key, it, cfg, ecfg, tcfg, env,
                              schedule, plans)


@functools.partial(jax.jit, static_argnames=("cfg", "ecfg", "env"))
def _jax_episodes(params, keys, plans, cfg, ecfg, env):
    """JAX's episodes of ``a2c_loss``'s batch keys (collect=True) and the
    reset states they started from."""
    outs = jax.vmap(lambda k: jtrain.rollout(params, k, cfg, ecfg, env,
                                             plans, collect=True))(keys)
    start = jax.vmap(lambda k: env.reset(jax.random.split(k)[0], ecfg))(keys)
    return outs, start


def _setup(groups, path, seed=0):
    """JAX's ``_init`` and the port's model and RMSprop state from it."""
    env, ecfg = jenvs.make("predator_prey", **ENV)
    jcfg, _, params, opt = jtrain._init(
        jic3net.IC3NetConfig(hidden=HIDDEN, flgw_groups=groups,
                             flgw_path=path), ecfg, env, seed)
    model, topt = interop.ic3net_from_numpy(
        tic3net.IC3NetConfig(**dataclasses.asdict(jcfg)),
        jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, opt),
        device="cpu")
    return env, ecfg, jcfg, params, opt, model, topt


def _replay_inputs(params, key, jcfg, ecfg, env, jplans, dense):
    """The port's reset state and a sampler replaying JAX's actions and
    gates of the batch ``a2c_loss`` draws from ``key``."""
    cfg = dataclasses.replace(jcfg, flgw_path="dense") if dense else jcfg
    keys = jax.random.split(key, B)
    outs, start = _jax_episodes(params, keys, jplans, cfg, ecfg, env)
    state = tpp.EnvState(*(torch.from_numpy(np.array(v)) for v in start))
    state = state._replace(pos=state.pos.long(), prey=state.prey.long(),
                           t=state.t.long())
    actions = torch.from_numpy(np.array(outs[7])).long()
    gates = torch.from_numpy(np.array(outs[5]))

    def replay(t, logits, gate_logits):
        return actions[:, t], gates[:, t]
    return state, replay, outs


def _fault_mask(path, leaf, shape, grouped):
    """True at the entries whose gradient the reference's make_plan fault
    moves on the grouped path (ROADMAP Queue 3): ig[M-1, :], og[:, N-1]."""
    mask = np.zeros(shape, bool)
    if grouped and leaf == "ig":
        mask[-1, :] = True
    if grouped and leaf == "og":
        mask[:, -1] = True
    return mask


def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _compare_grads(tgrads, jgrads, grouped):
    """Every gradient leaf within GRAD_REL relative norm (the fault's
    entries excluded); leaves JAX gives exact zeros must be exact zeros."""
    jflat = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    tflat = dict(_leaves(interop.tree_to_numpy(tgrads)))
    assert tflat.keys() == jflat.keys()
    for path, want in jflat.items():
        got = tflat[path]
        assert got.shape == want.shape, path
        keep = ~_fault_mask(path[:-1], path[-1], want.shape, grouped)
        if not want[keep].any():
            assert not got[keep].any(), f"{path}: JAX gives exact zeros"
            continue
        rel = np.linalg.norm(got[keep] - want[keep]) / np.linalg.norm(
            want[keep])
        assert rel <= GRAD_REL, f"{path}: relative difference {rel}"


def _assert_zero_grads(tgrads, jgrads, names):
    jflat = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    tflat = dict(_leaves(interop.tree_to_numpy(tgrads)))
    for path in jflat:
        if path[-1] in names or path[0] in names:
            assert not jflat[path].any(), f"JAX {path} not exactly 0"
            assert not tflat[path].any(), f"port {path} not exactly 0"


def _compare_metrics(tm, jm):
    for k in ("success", "return", "loss", "mask_sparsity"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=METRIC_RTOL, atol=1e-7, err_msg=k)


def test_a2c_terms_matches_jax():
    rng = np.random.default_rng(0)
    b, t, a = 5, 9, 4
    f = lambda: rng.standard_normal((b, t, a)).astype(np.float32)  # noqa
    rew, logp, val, ent, glp = f(), f(), f(), np.abs(f()), f()
    gates = (rng.random((b, t, a)) < 0.5).astype(np.float32)
    succ = rng.random(b) < 0.5
    jt = jtrain.TrainConfig(gamma=0.95, gate_coef=0.03)
    tt = ttrain.TrainConfig(gamma=0.95, gate_coef=0.03)
    jl, jm = jtrain.a2c_terms(*(jnp.asarray(v) for v in
                                (rew, logp, val, ent, glp, gates, succ)), jt)
    tl, tm = ttrain.a2c_terms(*(torch.from_numpy(v) for v in
                                (rew, logp, val, ent, glp, gates, succ)), tt)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for k in ("success", "return", "loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6,
                                   err_msg=k)
    # the loss reaches logp, val and ent, never gate_logp
    leaves = [torch.from_numpy(v).requires_grad_()
              for v in (logp, val, ent, glp)]
    loss, _ = ttrain.a2c_terms(torch.from_numpy(rew), *leaves,
                               torch.from_numpy(gates),
                               torch.from_numpy(succ), tt)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert all(g is not None for g in grads[:3]) and grads[3] is None


@pytest.mark.parametrize("groups,path", [(2, "masked"), (2, "grouped"),
                                         (1, "masked")])
def test_train_step_matches_jax(groups, path):
    """One train step from the same params and episodes: metrics within
    1e-5, every gradient within 1e-4 relative norm (the grouped path's
    fault entries excluded), the gate head's gradient exactly 0 in both,
    and the parameters after the RMSprop step where |g| is not at
    rounding level."""
    env, ecfg, jcfg, params, opt, model, topt = _setup(groups, path)
    grouped = path == "grouped"
    jt, tt = jtrain.TrainConfig(batch=B), ttrain.TrainConfig(batch=B)
    jplans = jic3net.encode_plans(params, jcfg)
    key = jax.random.PRNGKey(11)
    state, replay, outs = _replay_inputs(params, key, jcfg, ecfg, env,
                                         jplans, dense=False)
    jm, jg = _jax_loss_grads(params, key, jnp.int32(0), jplans, cfg=jcfg,
                             ecfg=ecfg, tcfg=jt, env=env, schedule=None)
    # the replayed episodes are the ones JAX's loss was taken over
    jl, _ = jax.jit(jtrain.a2c_terms, static_argnums=7)(*outs[:7], jt)
    np.testing.assert_allclose(float(jl), float(jm["loss"]), rtol=1e-6)

    tenv, tecfg = tenvs.make("predator_prey", **ENV)
    with torch.no_grad():
        tplans = model.encode_plans()
    assert int(tplans.sig) == int(np.asarray(jplans.sig))
    tm, tg = ttrain._loss_grads(model, tenv, tecfg, tt, state, replay, 0,
                                None, tplans)
    _compare_metrics(tm, jm)
    _compare_grads(tg, jg, grouped)
    _assert_zero_grads(tg, jg, ("gate",))
    if groups > 1:
        assert float(tm["mask_sparsity"]) > 0

    # the RMSprop step of JAX's train_step, on the gradients above,
    # against the port's train_step
    jp, _ = jax.jit(functools.partial(jopt.rmsprop, lr=jt.lr))(params, jg,
                                                                opt)
    topt, tm2 = ttrain.train_step(model, topt, tenv, tecfg, tt, state,
                                  replay, 0, None, tplans)
    _compare_metrics(tm2, jm)
    jflat = dict(_leaves(jax.tree.map(np.asarray, jp)))
    gflat = dict(_leaves(jax.tree.map(np.asarray, jg)))
    tflat = dict(_leaves(interop.tree_to_numpy(model.params)))
    excluded = faulty = 0
    for p, want in jflat.items():
        g = np.abs(gflat[p])
        fault = _fault_mask(p[:-1], p[-1], want.shape, grouped)
        tiny = (g > 0) & (g <= STEP_GRAD_FLOOR * g.max())
        keep = ~fault & ~tiny
        excluded += int((tiny & ~fault).sum())
        faulty += int(fault.sum())
        np.testing.assert_allclose(tflat[p][keep], want[keep], **PARAM_TOL,
                                   err_msg="/".join(p))
    print(f"{path} G={groups}: {excluded} parameter entries excluded with a "
          f"gradient at rounding level, {faulty} as the fault's")


def test_dense_warmup_iteration_matches_jax():
    """A warmup iteration runs the same parameters dense: IG and OG get
    exactly zero gradients in both packages, mask_sparsity is 0, and the
    rest matches JAX's dense branch."""
    env, ecfg, jcfg, params, opt, model, topt = _setup(2, "grouped", seed=1)
    jt, tt = jtrain.TrainConfig(batch=B), ttrain.TrainConfig(batch=B)
    jsched = JSchedule(groups=2, warmup_steps=2)
    tsched = SparsitySchedule(groups=2, warmup_steps=2)
    jplans = jic3net.encode_plans(params, jcfg)
    key = jax.random.PRNGKey(12)
    state, replay, _ = _replay_inputs(params, key, jcfg, ecfg, env, jplans,
                                      dense=True)
    jm, jg = _jax_loss_grads(params, key, jnp.int32(1), jplans, cfg=jcfg,
                             ecfg=ecfg, tcfg=jt, env=env, schedule=jsched)
    tenv, tecfg = tenvs.make("predator_prey", **ENV)
    with torch.no_grad():
        tplans = model.encode_plans()
    tm, tg = ttrain._loss_grads(model, tenv, tecfg, tt, state, replay, 1,
                                tsched, tplans)
    assert float(tm["mask_sparsity"]) == 0.0 == float(jm["mask_sparsity"])
    _compare_metrics(tm, jm)
    _assert_zero_grads(tg, jg, ("ig", "og", "gate"))
    _compare_grads(tg, jg, grouped=False)


def _tiny_train(monkeypatch, schedule, iterations=3, path="grouped"):
    calls = []
    real = encoder.encode_plans

    def counting(params, cfg):
        calls.append(1)
        return real(params, cfg)
    monkeypatch.setattr(encoder, "encode_plans", counting)
    env, ecfg = tenvs.make("predator_prey", n_agents=2, size=3, max_steps=4)
    cfg = tic3net.IC3NetConfig(hidden=16, flgw_groups=2, flgw_path=path)
    model, hist = ttrain.train(cfg, ecfg, ttrain.TrainConfig(batch=2),
                               iterations=iterations, env=env,
                               schedule=schedule, device="cpu")
    return model, hist, len(calls)


@pytest.mark.parametrize("schedule,encodes", [
    (None, 4), (SparsitySchedule(groups=2, refresh_every=2), 3),
    (SparsitySchedule(groups=2, warmup_steps=2), 4)])
def test_train_refreshes_plans_every_period(monkeypatch, schedule, encodes):
    """One encode before the loop, then one at the top of every iteration
    the schedule's period is due (the warmup keeps refreshing)."""
    _, hist, n = _tiny_train(monkeypatch, schedule)
    assert n == encodes and len(hist) == 3
    if schedule is not None and schedule.warmup_steps:
        assert [h["mask_sparsity"] == 0.0 for h in hist] == [True, True,
                                                              False]


def test_train_history_keys_and_no_encode_off_the_grouped_path(monkeypatch):
    model, hist, n = _tiny_train(monkeypatch, None, path="masked")
    assert n == 0 and model.device == torch.device("cpu")
    assert [sorted(h) for h in hist] == [sorted(
        ["success", "return", "loss", "mask_sparsity", "steps_per_s",
         "env_steps_per_s", "sparse_gflops"])] * 3
    for h in hist:
        assert all(isinstance(v, float) and np.isfinite(v)
                   for v in h.values())
        assert h["env_steps_per_s"] == pytest.approx(
            h["steps_per_s"] * 2 * 4)
    assert model.cfg.obs_dim == tenvs.get("predator_prey").obs_dim(
        tpp.EnvConfig(n_agents=2, size=3, max_steps=4))


def test_train_config_matches_jax_and_refuses_sharding():
    """The fields and defaults are JAX's, and the sharded paths' fields
    are accepted as JAX's are (the mesh runs are in
    ``test_torch_marl_mesh.py``)."""
    want = dataclasses.asdict(jtrain.TrainConfig())
    assert dataclasses.asdict(ttrain.TrainConfig()) == want
    for kw in (dict(mesh=(1, 1)), dict(parallel=True),
               dict(batch=8, mesh=(2, 2), parallel=True)):
        assert dataclasses.asdict(ttrain.TrainConfig(**kw)) == \
            dataclasses.asdict(jtrain.TrainConfig(**kw))
