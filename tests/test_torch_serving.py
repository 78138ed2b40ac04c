"""The port's serving tier on the gemma2 smoke model in bfloat16 against
the JAX package, which runs its kernels' reference versions here
(``repro.kernels.use_reference_impl()``: XLA's CPU backend cannot run
the interpret-mode bf16 x bf16 -> f32 product of its fused kernel)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite's workers share the host's cores

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import kernels as jkernels  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.core import encoder as jencoder  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serving import ServeSession as JSession  # noqa: E402
from repro.serving import plan_cache as jplan_cache  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import encoder  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serving import PLAN_POLICIES, ServeSession, plan_cache  # noqa: E402

FLGW = dict(flgw_groups=4, flgw_path="grouped", flgw_targets=("mlp", "attn"))
# bf16 activations are rounded at other places in the two frameworks
# (gelu, the PV product, the fused product's f32->bf16 cast). At this
# seed the logits (|logit| up to ~1.2) differ by up to ~6e-3 after four
# layers; the bound leaves three times that.
TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module")
def model():
    jcfg = jregistry.get_smoke_config("gemma2_2b", **FLGW)
    cfg = registry.get_smoke_config("gemma2_2b", **FLGW)
    assert jcfg.dtype == jnp.bfloat16 and cfg.dtype == torch.bfloat16
    jparams, _ = jtransformer.lm_init(jax.random.PRNGKey(0), jcfg)
    params = interop.lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")
    assert params["blocks"]["slot0"]["ffn"]["up"]["w"].dtype == torch.bfloat16
    return jcfg, jparams, cfg, params


@pytest.fixture(autouse=True)
def _fresh_plan_caches():
    plan_cache.clear()
    jplan_cache.clear()
    yield
    plan_cache.clear()
    jplan_cache.clear()


def _flip(tree):
    """Online-tuning stand-in: negating ig/og moves every layout."""
    if isinstance(tree, dict):
        return {k: (-v if k in ("ig", "og") else _flip(v))
                for k, v in tree.items()}
    return tree


def _tokens(b, s, vocab, seed):
    t = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)
    return t, np.ascontiguousarray(
        np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)))


@pytest.mark.parametrize("per_slot", [False, True])
def test_bf16_decode_matches_jax(model, per_slot):
    jcfg, jparams, cfg, params = model
    b, steps = 2, 18
    tok, pos = _tokens(b, steps, cfg.vocab, seed=5)
    with jkernels.use_reference_impl():
        jcache = jtransformer.init_cache(jcfg, b, steps, params=jparams,
                                         per_slot=per_slot)
        apply = jax.jit(lambda p, t, ps, c: jtransformer.lm_apply(
            p, jcfg, t, ps, cache=c, remat=False))
        cache = transformer.init_cache(cfg, b, steps, params=params,
                                       per_slot=per_slot)
        assert cache["plans"].plans["blocks"]["slot0"]["ffn"]["up"].wc.dtype \
            == torch.bfloat16
        for t in range(steps):
            want, _, jcache = apply(jparams, jnp.asarray(tok[:, t:t + 1]),
                                    jnp.asarray(pos[:, t:t + 1]), jcache)
            with torch.inference_mode():
                got, _, cache = transformer.lm_apply(
                    params, cfg, torch.from_numpy(tok[:, t:t + 1]),
                    torch.from_numpy(pos[:, t:t + 1]), cache=cache)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bf16_prefill_matches_jax_with_and_without_flash(model):
    jcfg, jparams, cfg, params = model
    tok, pos = _tokens(2, 24, cfg.vocab, seed=6)
    batch = {"tokens": torch.from_numpy(tok), "positions": torch.from_numpy(pos)}
    with jkernels.use_reference_impl():
        want = JSession(jcfg, jparams).prefill(
            {"tokens": jnp.asarray(tok), "positions": jnp.asarray(pos)})
    for flash in (False, True):
        sess = ServeSession(cfg.with_updates(use_flash=flash), params)
        np.testing.assert_allclose(sess.prefill(batch).numpy(),
                                   np.asarray(want), **TOL)


@pytest.mark.parametrize("policy", ["certify", "trust"])
def test_session_policies_match_jax(model, policy):
    """The same request-boundary sequence through both sessions: the
    tokens agree, and the plan caches count the same encodes and hits."""
    jcfg, jparams, cfg, params = model
    tok = np.zeros((1, 1), np.int32)
    with jkernels.use_reference_impl():
        jsess = JSession(jcfg, jparams, plan_policy=policy)
        sess = ServeSession(cfg, params, plan_policy=policy)
        outs = []
        for s in (jsess, sess):
            conv = jnp.asarray if s is jsess else torch.from_numpy
            cache = s.new_cache(1, 8)
            cache = s.refresh(cache)
            nxt, cache = s.decode(cache, conv(tok), conv(tok))
            s.update_params(_flip(s.params))
            cache = s.refresh(cache)
            nxt2, _ = s.decode(cache, conv(np.asarray(nxt)), conv(tok + 1))
            outs.append((int(np.asarray(nxt)[0, 0]),
                         int(np.asarray(nxt2)[0, 0]), int(cache["plans"].sig)))
    assert outs[1] == outs[0]
    want = jplan_cache.stats()
    assert plan_cache.stats() == want
    assert want["encodes"] == 2
    if policy == "certify":      # the refreshed cache carries new-params wc
        fresh = encoder.attach_compact(
            transformer.encode_plans(sess.params, cfg), sess.params)
        a = cache["plans"].plans["blocks"]["slot1"]["mixer"]["o"]
        b = fresh.plans["blocks"]["slot1"]["mixer"]["o"]
        assert torch.equal(a.wc, b.wc) and torch.equal(a.row_ids, b.row_ids)


def test_policy_surface(model):
    _, _, cfg, params = model
    assert set(PLAN_POLICIES) == {"certify", "trust", "off"}
    with pytest.raises(ValueError, match="plan_policy"):
        ServeSession(cfg, params, plan_policy="always")
    off = ServeSession(cfg, params, plan_policy="off")
    assert off.plans == () and off.new_cache(1, 4)["plans"] == ()
    assert plan_cache.stats()["encodes"] == 0
    trust = ServeSession(cfg, params, plan_policy="trust")
    again = ServeSession(cfg, params, plan_policy="certify")
    assert again.plans is trust.plans          # one encode, shared
    assert plan_cache.stats()["encodes"] == 1
    assert not encoder.grouped.has_compact(trust.plans.plans)
    assert encoder.grouped.has_compact(trust.new_cache(1, 4)["plans"].plans)


def test_plan_cache_keeps_devices_apart(model):
    """The same layout on two devices resolves to two entries: a CPU
    session never receives plans that live on the card."""
    _, _, cfg, params = model
    meta = {k: torch.empty(v.shape, device="meta")
            for k, v in params["blocks"]["slot0"]["ffn"]["up"].items()}
    cpu = {k: v for k, v in params["blocks"]["slot0"]["ffn"]["up"].items()}
    states = [encoder.empty_state() for _ in range(2)]
    for tree, state in zip(({"up": cpu}, {"up": meta}), states):
        assert plan_cache.shared_plans(tree, encode=lambda s=state: s,
                                       sig=7) is state
    assert plan_cache.stats()["encodes"] == 2
    assert plan_cache.shared_plans({"up": cpu}, encode=None, sig=7) \
        is states[0]
