"""The port's batched environments against the JAX envs vmapped over B."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite's workers share the host's cores

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.marl import envs as jenvs  # noqa: E402
from repro.marl.envs import predator_prey as jpp  # noqa: E402
from repro.marl.envs import traffic_junction as jtj  # noqa: E402
from repro_torch.marl import envs  # noqa: E402
from repro_torch.marl.envs import predator_prey as tpp  # noqa: E402
from repro_torch.marl.envs import traffic_junction as ttj  # noqa: E402


def _states(rng, b, cfg):
    """A batch of states on a small grid: many agents share the prey's
    cell, some have arrived, t runs up to the step limit."""
    a = cfg.n_agents
    pos = rng.integers(0, cfg.size, (b, a, 2))
    prey = rng.integers(0, cfg.size, (b, 2))
    arrived = rng.random((b, a)) < 0.3
    t = rng.integers(0, cfg.max_steps, (b,))
    js = jpp.EnvState(jnp.asarray(pos, jnp.int32), jnp.asarray(prey, jnp.int32),
                      jnp.asarray(arrived), jnp.asarray(t, jnp.int32))
    ts = tpp.EnvState(*(torch.from_numpy(np.asarray(v))
                        for v in (pos, prey, arrived, t)))
    return js, ts


@pytest.mark.parametrize("size,vision", [(3, 1), (5, 2)])
def test_observe_step_success_are_exact(size, vision):
    rng = np.random.default_rng(size)
    cfg = dict(n_agents=3, size=size, vision=vision, max_steps=4)
    jcfg, tcfg = jpp.EnvConfig(**cfg), tpp.EnvConfig(**cfg)
    js, ts = _states(rng, 64, tcfg)
    actions = rng.integers(0, tpp.N_ACTIONS, (64, 3))

    np.testing.assert_array_equal(
        tpp.observe(ts, tcfg).numpy(),
        np.asarray(jax.vmap(jpp.observe, in_axes=(0, None))(js, jcfg)))
    jn, jr, jd = jax.vmap(jpp.step, in_axes=(0, 0, None))(
        js, jnp.asarray(actions, jnp.int32), jcfg)
    tn, tr, td = tpp.step(ts, torch.from_numpy(actions), tcfg)
    for got, want in [*zip(tn, jn), (tr, jr), (td, jd)]:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tr.dtype == torch.float32
    np.testing.assert_array_equal(tpp.success(tn).numpy(),
                                  np.asarray(jax.vmap(jpp.success)(jn)))
    assert tpp.obs_dim(tcfg) == jpp.obs_dim(jcfg)


def test_reset_invariants():
    cfg = tpp.EnvConfig(n_agents=4, size=6)
    s = tpp.reset(torch.Generator().manual_seed(0), cfg, 32)
    assert s.pos.shape == (32, 4, 2) and s.prey.shape == (32, 2)
    assert s.arrived.shape == (32, 4) and s.t.shape == (32,)
    for v in (s.pos, s.prey):
        assert v.dtype == torch.int64
        assert int(v.min()) >= 0 and int(v.max()) < cfg.size
    assert not s.arrived.any() and int(s.t.abs().sum()) == 0
    # a seed fixes the draw; envs and seeds differ
    again = tpp.reset(torch.Generator().manual_seed(0), cfg, 32)
    other = tpp.reset(torch.Generator().manual_seed(1), cfg, 32)
    assert torch.equal(s.pos, again.pos) and torch.equal(s.prey, again.prey)
    assert not torch.equal(s.pos, other.pos)
    assert len({tuple(p.flatten().tolist()) for p in s.pos}) > 1


def test_registry():
    assert envs.names() == jenvs.names()
    assert envs.names() == ["predator_prey", "spread", "traffic_junction",
                            "traffic_junction_4way", "traffic_junction_hard"]
    env, cfg = envs.make("predator_prey", n_agents=8, size=10)
    assert env is envs.PREDATOR_PREY and cfg.n_agents == 8
    assert env.obs_dim(cfg) == 30 and env.n_actions(cfg) == 5
    for name in envs.names():
        t, j = envs.get(name), jenvs.get(name)
        assert t.config_cls()._asdict() == j.config_cls()._asdict(), name
        tc, jc = t.config_cls(), j.config_cls()
        assert (t.obs_dim(tc), t.n_actions(tc)) == (j.obs_dim(jc),
                                                     j.n_actions(jc)), name
    with pytest.raises(KeyError, match="registered"):
        envs.get("nope")
    with pytest.raises(ValueError, match="already registered"):
        envs.register(env)


# (name, config overrides): small grids so cars meet and landmarks get
# covered within a few steps; the hard and 4-way streams at high p_arrive
# so several cars are on the road at once.
_OTHER_ENVS = [
    ("traffic_junction", dict(n_agents=4, size=5, max_steps=10)),
    ("traffic_junction_hard", dict(n_agents=5, size=5, max_steps=16,
                                   p_arrive=0.9)),
    ("traffic_junction_4way", dict(n_agents=5, size=4, max_steps=14,
                                   p_arrive=0.9)),
    ("spread", dict(n_agents=3, size=3, max_steps=8)),
]


def _to_torch_state(tenv_state_cls, jstate):
    """A JAX state batch (vmapped) -> the port's, integers as int64."""
    vals = []
    for v in jstate:
        a = np.asarray(v)
        vals.append(torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i"
                                     else np.array(a)))
    return tenv_state_cls(*vals)


@pytest.mark.parametrize("name,overrides", _OTHER_ENVS,
                         ids=[n for n, _ in _OTHER_ENVS])
def test_other_envs_observe_step_success_are_exact(name, overrides):
    """From JAX's reset states, a few steps of random actions: every
    observation, state field, reward, done flag and success exact against
    the jitted JAX functions."""
    b = 48
    jenv, jcfg = jenvs.make(name, **overrides)
    tenv, tcfg = envs.make(name, **overrides)
    assert tenv.obs_dim(tcfg) == jenv.obs_dim(jcfg)
    keys = jax.random.split(jax.random.PRNGKey(7), b)
    js = jax.vmap(jenv.reset, in_axes=(0, None))(keys, jcfg)
    state_cls = type(tenv.reset(torch.Generator().manual_seed(0), tcfg, 1))
    ts = _to_torch_state(state_cls, js)
    rng = np.random.default_rng(len(name))
    # compiled, as the training engine runs them (XLA turns spread's
    # divisions by constants into products with reciprocals)
    observe = jax.jit(jax.vmap(jenv.observe, in_axes=(0, None)),
                      static_argnums=1)
    step = jax.jit(jax.vmap(jenv.step, in_axes=(0, 0, None)),
                   static_argnums=2)
    for _ in range(tcfg.max_steps):
        np.testing.assert_array_equal(tenv.observe(ts, tcfg).numpy(),
                                      np.asarray(observe(js, jcfg)))
        actions = rng.integers(0, tenv.n_actions(tcfg), (b, tcfg.n_agents))
        js, jr, jd = step(js, jnp.asarray(actions, jnp.int32), jcfg)
        ts, tr, td = tenv.step(ts, torch.from_numpy(actions), tcfg)
        for got, want in [*zip(ts, js), (tr, jr), (td, jd)]:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert tr.dtype == torch.float32
        np.testing.assert_array_equal(
            tenv.success(ts).numpy(), np.asarray(jax.vmap(jenv.success)(js)))
    # the episodes did something: rewards moved and some ended
    assert bool(td.any())


@pytest.mark.parametrize("name,overrides", _OTHER_ENVS,
                         ids=[n for n, _ in _OTHER_ENVS])
def test_other_envs_reset_invariants(name, overrides):
    env, cfg = envs.make(name, **overrides)
    s = env.reset(torch.Generator().manual_seed(0), cfg, 64)
    again = env.reset(torch.Generator().manual_seed(0), cfg, 64)
    other = env.reset(torch.Generator().manual_seed(1), cfg, 64)
    assert all(torch.equal(a, c) for a, c in zip(s, again))
    assert not all(torch.equal(a, c) for a, c in zip(s, other))
    assert int(s.t.abs().sum()) == 0 and s.t.shape == (64,)
    a = cfg.n_agents
    if name == "spread":
        for v in (s.pos, s.landmarks):
            assert v.shape == (64, a, 2) and v.dtype == torch.int64
            assert int(v.min()) >= 0 and int(v.max()) < cfg.size
        return
    assert s.route.shape == s.enter_t.shape == s.prog.shape == (64, a)
    assert not s.collided.any() and not s.cleared.any()
    assert int(s.prog.abs().sum()) == 0
    n_routes = 12 if name.endswith("4way") else 2
    assert int(s.route.min()) >= 0 and int(s.route.max()) < n_routes
    assert len(s.route.unique()) == n_routes
    # entry steps strictly increase along the arrival order, start at 0
    et = s.enter_t.sort(-1).values
    assert bool((et[:, 1:] > et[:, :-1]).all())
    assert bool((et[:, 0] == 0).all())
    if name == "traffic_junction":
        assert bool((et == torch.arange(a)).all())
    else:
        assert bool((s.enter_t[:, 1:] > s.enter_t[:, :-1]).all())


@pytest.mark.parametrize("p,cap", [(0.7, 38), (0.3, 12), (0.5, 2),
                                   (1.0, 20), (1e-4, 30)])
def test_arrival_stream_matches_jax_on_fed_uniforms(p, cap):
    """``arrivals_from_uniforms`` against JAX's ``arrival_stream`` fed the
    same uniforms. ``floor(log(u) / log1p(-p))`` can differ by one
    between XLA's and torch's ``log`` where the quotient sits on an
    integer, so the uniforms are JAX's own draws with any quotient within
    1e-4 of an integer dropped."""
    n, b = 10, 256
    keys = jax.random.split(jax.random.PRNGKey(int(p * 1000) + cap), b)
    u = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (n,), minval=1e-6, maxval=1.0))(keys))
    keep = np.ones(b, bool)
    if p < 1.0:
        q = np.log(u.astype(np.float64)) / np.log1p(-max(p, 1e-3))
        keep = (np.abs(q - np.round(q)) > 1e-4).all(1)
    assert keep.sum() > b // 2
    want = np.asarray(jax.vmap(
        lambda k: jtj.arrival_stream(k, n, p, cap))(keys))[keep]
    got = ttj.arrivals_from_uniforms(torch.from_numpy(u[keep]), p, cap)
    np.testing.assert_array_equal(got.numpy(), want)
    # and the port's own stream keeps the same invariants
    s = ttj.arrival_stream(torch.Generator().manual_seed(0), 64, n, p, cap)
    assert bool((s[:, 1:] > s[:, :-1]).all()) and bool((s[:, 0] == 0).all())
