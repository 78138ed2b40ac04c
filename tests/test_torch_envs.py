"""The port's batched predator-prey against the JAX env vmapped over B."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.marl.envs import predator_prey as jpp  # noqa: E402
from repro_torch.marl import envs  # noqa: E402
from repro_torch.marl.envs import predator_prey as tpp  # noqa: E402


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
    assert envs.names() == ["predator_prey"]
    env, cfg = envs.make("predator_prey", n_agents=8, size=10)
    assert env is envs.PREDATOR_PREY and cfg.n_agents == 8
    assert env.obs_dim(cfg) == 30 and env.n_actions(cfg) == 5
    with pytest.raises(KeyError, match="registered"):
        envs.get("nope")
    with pytest.raises(ValueError, match="already registered"):
        envs.register(env)
