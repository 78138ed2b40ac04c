"""The port's IC3Net step and its rollout (the slice end to end) against
the JAX package, on JAX-initialised params brought over by interop."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite's workers share the host's cores

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import ic3net as jconfigs  # noqa: E402
from repro.marl import envs as jenvs  # noqa: E402
from repro.marl import ic3net as jic3net  # noqa: E402
from repro.marl import train as jtrain  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import ic3net as tconfigs  # noqa: E402
from repro_torch.marl import envs as tenvs  # noqa: E402
from repro_torch.marl import ic3net as tic3net  # noqa: E402
from repro_torch.marl import train as ttrain  # noqa: E402
from repro_torch.marl.envs import predator_prey as tpp  # noqa: E402

ENV = dict(n_agents=3, size=4, vision=1, max_steps=8)
B = 2


def _pair(groups, path, seed=0):
    """(JAX cfg, JAX params, port cfg, port model) from one JAX init."""
    env, ecfg = jenvs.make("predator_prey", **ENV)
    fields = dict(hidden=32, n_agents=3, flgw_groups=groups, flgw_path=path,
                  obs_dim=env.obs_dim(ecfg))
    jcfg = jic3net.IC3NetConfig(**fields)
    params, _ = jic3net.init(jax.random.PRNGKey(seed), jcfg)
    tcfg = tic3net.IC3NetConfig(**fields)
    model = tic3net.IC3Net(tcfg, device="cpu")
    model.load_state_dict(interop.params_from_numpy(
        jax.tree.map(np.asarray, params)))
    return jcfg, params, tcfg, model


@pytest.mark.parametrize("groups,path", [(4, "grouped"), (2, "masked"),
                                         (1, "masked")])
def test_policy_step_matches_jax(groups, path):
    jcfg, params, tcfg, model = _pair(groups, path)
    rng = np.random.default_rng(groups)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    obs, h, c = f(B, 3, jcfg.obs_dim), f(B, 3, 32), f(B, 3, 32)
    gate = (rng.random((B, 3)) < 0.5).astype(np.float32)
    jplans = jic3net.encode_plans(params, jcfg)
    want = jax.vmap(lambda o, hh, cc, gp: jic3net.policy_step(
        params, jcfg, o, (hh, cc), gp, jplans))(
            *(jnp.asarray(v) for v in (obs, h, c, gate)))
    with torch.inference_mode():
        plans = model.encode_plans()
        assert int(plans.sig) == int(np.asarray(jplans.sig))
        logits, value, gate_logits, (nh, nc) = model.policy_step(
            torch.from_numpy(obs), (torch.from_numpy(h), torch.from_numpy(c)),
            torch.from_numpy(gate), plans)
    jl, jv, jg, (jh, jc) = want
    for got, ref in [(logits, jl), (value, jv), (gate_logits, jg), (nh, jh),
                     (nc, jc)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)
    assert model.flops_per_step() == jic3net.flops_per_step(jcfg)


def test_rollout_replays_jax_episodes():
    """The slice end to end: JAX rollouts (collect=True) vmapped over B
    keys, replayed by the port from the same reset states with JAX's
    sampled actions and gates."""
    jcfg, params, tcfg, model = _pair(4, "grouped", seed=1)
    env, ecfg = jenvs.make("predator_prey", **ENV)
    jplans = jic3net.encode_plans(params, jcfg)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    rew, logp, val, ent, glp, gates, obs, act, succ = jax.jit(jax.vmap(
        lambda k: jtrain.rollout(params, k, jcfg, ecfg, env, plans=jplans,
                                 collect=True)))(keys)
    start = jax.vmap(lambda k: env.reset(jax.random.split(k)[0], ecfg))(keys)

    tenv, tecfg = tenvs.make("predator_prey", **ENV)
    state = tpp.EnvState(*(torch.from_numpy(np.array(v)) for v in start))
    state = state._replace(pos=state.pos.long(), prey=state.prey.long(),
                           t=state.t.long())
    actions = torch.from_numpy(np.array(act)).long()
    gate_seq = torch.from_numpy(np.array(gates))

    def replay(t, logits, gate_logits):
        return actions[:, t], gate_seq[:, t]

    with torch.inference_mode():
        r = ttrain.run_episode(model, tenv, tecfg, state, replay,
                               model.encode_plans(), collect=True)
    assert r.reward.shape == (B, ENV["max_steps"], 3)
    for got, want in [(r.reward, rew), (r.obs, obs), (r.success, succ),
                      (r.gate, gates), (r.action, act)]:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in [(r.logp, logp), (r.value, val), (r.entropy, ent),
                      (r.gate_logp, glp)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def test_rollout_samples_on_its_generator_and_freezes_done_episodes():
    env, ecfg = tenvs.make("predator_prey", n_agents=3, size=2,
                           max_steps=8)
    cfg = dataclasses.replace(tconfigs.smoke(), flgw_path="grouped",
                              obs_dim=env.obs_dim(ecfg))
    model = tic3net.IC3Net(cfg, seed=0, device="cpu")
    plans = model.encode_plans()
    r = ttrain.rollout(model, env, ecfg, ttrain.make_generator(0, "cpu"), 16,
                       plans, collect=True)
    again = ttrain.rollout(model, env, ecfg, ttrain.make_generator(0, "cpu"),
                           16, plans)
    assert torch.equal(r.reward, again.reward) and again.obs is None
    assert r.action.dtype == torch.int64
    assert int(r.action.min()) >= 0 and int(r.action.max()) < 5
    assert set(r.gate.unique().tolist()) <= {0.0, 1.0}
    for v in (r.logp, r.value, r.entropy, r.gate_logp):
        assert v.shape == (16, 8, 3) and bool(torch.isfinite(v).all())
    # on a 2x2 grid most episodes end early: after the step that ends an
    # episode, its rewards are zero and its observations no longer move
    done_at = (r.reward[:, :, 0] == 0).float().argmax(1)
    ended = r.success.nonzero()[:, 0]
    assert len(ended) > 0
    for b in ended.tolist():
        t = int(done_at[b])
        assert t > 0 and bool((r.reward[b, t:] == 0).all())
        assert bool((r.obs[b, t:] == r.obs[b, t]).all())


def test_configs_are_the_references():
    for name in ("config", "smoke"):
        want = dataclasses.asdict(getattr(jconfigs, name)())
        assert dataclasses.asdict(getattr(tconfigs, name)()) == want
