"""The port's gemma2 LM stack in float32 (smoke config, FLGW G=4 on the
grouped path for mlp and attn) against the JAX package: prefill logits
with and without flash, decode on attached plans (lockstep and per-slot
caches), plans and signature on stacked params, and Engine token ids."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite's workers share the host's cores

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import registry as jregistry  # noqa: E402
from repro.core import encoder as jencoder  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServeSession as JSession  # noqa: E402
from repro.serving import plan_cache as jplan_cache  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import encoder, grouped  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serving import (Engine, ServeSession, max_seq_for,  # noqa: E402
                                 plan_cache, synthetic_requests)

FLGW = dict(flgw_groups=4, flgw_path="grouped", flgw_targets=("mlp", "attn"))
# f32 throughout; sums taken in other orders (the fused product, the
# chunked softmax, flash's online softmax) move logits by ~1e-6.
TOL = dict(rtol=1e-4, atol=1e-4)
SEQ = 24                      # exceeds the smoke config's local window (16)


@pytest.fixture(scope="module")
def model():
    jcfg = jregistry.get_smoke_config("gemma2_2b", dtype=jnp.float32, **FLGW)
    cfg = registry.get_smoke_config("gemma2_2b", dtype=torch.float32, **FLGW)
    jparams, _ = jtransformer.lm_init(jax.random.PRNGKey(0), jcfg)
    params = interop.lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def jplans(model):
    """JAX's PlanState of the model, encoded once for the whole file."""
    jcfg, jparams, _, _ = model
    return jtransformer.encode_plans(jparams, jcfg)


@pytest.fixture(scope="module")
def sessions(model):
    """One session per package, shared by both admission modes so JAX
    compiles its steps once."""
    jcfg, jparams, cfg, params = model
    return JSession(jcfg, jparams), ServeSession(cfg, params)


@pytest.fixture(autouse=True)
def _fresh_plan_caches():
    plan_cache.clear()
    jplan_cache.clear()
    yield


def _tokens(b, s, vocab, seed=1):
    t = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)
    pos = np.ascontiguousarray(np.broadcast_to(np.arange(s, dtype=np.int32),
                                               (b, s)))
    return t, pos


def test_config_and_params_mirror_the_reference(model):
    jcfg, jparams, cfg, params = model
    full = registry.get_config("gemma2_2b")
    jfull = jregistry.get_config("gemma2_2b")
    assert (full.n_layers, full.d_model, full.head_dim, full.vocab) == (
        jfull.n_layers, jfull.d_model, jfull.head_dim, jfull.vocab)
    assert full.pattern == tuple(type(full.pattern[0])(**vars(s))
                                 for s in jfull.pattern)
    from repro.models.config import param_count as jcount
    from repro_torch.models.config import param_count
    assert param_count(full) == jcount(jfull)
    ours = transformer.lm_init(torch.Generator().manual_seed(0), cfg)
    shapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
    assert jax.tree.map(lambda a: tuple(a.shape), ours) == shapes
    with pytest.raises(KeyError, match="unknown"):
        registry.get_config("llama3_8b")
    # every LM architecture of the JAX package is ported
    assert set(registry.ARCH_IDS) == set(jregistry.ARCH_IDS) - {"ic3net"}


def test_plans_and_signature_on_stacked_params_are_bitwise(model, jplans):
    jcfg, jparams, cfg, params = model
    want = jplans
    got = transformer.encode_plans(params, cfg)
    assert int(got.sig) == int(np.asarray(want.sig))
    ref = interop.plans_from_numpy(want.plans)
    mixer = got.plans["blocks"]["slot1"]["mixer"]["q"]
    assert mixer.row_ids.shape[0] == cfg.n_blocks   # stacked like the params
    for path, _ in grouped.iter_flgw_layers(params):
        a, b = ref, got.plans
        for name in path:
            a, b = a[name], b[name]
        for x, y in zip(a[:4], b[:4]):
            assert torch.equal(x, y), path
    attached = encoder.attach_compact(got, params)
    jattached = jencoder.attach_compact(want, jparams)
    np.testing.assert_array_equal(
        attached.plans["blocks"]["slot0"]["ffn"]["down"].wc.numpy(),
        np.asarray(jattached.plans["blocks"]["slot0"]["ffn"]["down"].wc))


@pytest.mark.parametrize("flash,q_chunk", [(False, 512), (False, 8),
                                           (True, 512)])
def test_prefill_logits_match_jax(model, jplans, flash, q_chunk):
    jcfg, jparams, cfg, params = model
    jcfg, cfg = (c.with_updates(use_flash=flash) for c in (jcfg, cfg))
    tok, pos = _tokens(2, SEQ, cfg.vocab)
    want, _, _ = jtransformer.lm_apply(jparams, jcfg, jnp.asarray(tok),
                                       jnp.asarray(pos), remat=False,
                                       q_chunk=q_chunk, plans=jplans)
    with torch.inference_mode():
        got, _, _ = transformer.lm_apply(
            params, cfg, torch.from_numpy(tok), torch.from_numpy(pos),
            q_chunk=q_chunk, plans=transformer.encode_plans(params, cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_on_attached_plans_matches_jax(model, jplans, per_slot):
    jcfg, jparams, cfg, params = model
    b, steps = 2, 18                      # the local ring (16) wraps
    tok, pos = _tokens(b, steps, cfg.vocab, seed=2)
    jcache = jtransformer.init_cache(jcfg, b, steps, per_slot=per_slot)
    jcache["plans"] = jencoder.attach_compact(jplans, jparams)
    apply = jax.jit(lambda p, t, ps, c: jtransformer.lm_apply(
        p, jcfg, t, ps, cache=c, remat=False))
    cache = transformer.init_cache(cfg, b, steps, params=params,
                                   per_slot=per_slot)
    assert grouped.has_compact(cache["plans"].plans)
    assert cache["pos"].shape == ((b,) if per_slot else ())
    for t in range(steps):
        want, _, jcache = apply(jparams, jnp.asarray(tok[:, t:t + 1]),
                                jnp.asarray(pos[:, t:t + 1]), jcache)
        with torch.inference_mode():
            got, _, cache = transformer.lm_apply(
                params, cfg, torch.from_numpy(tok[:, t:t + 1]),
                torch.from_numpy(pos[:, t:t + 1]), cache=cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert int(cache["blocks"]["slot0"]["k"].shape[2]) == 16   # bounded ring


def test_reset_slots_isolates_a_row(model):
    _, _, cfg, params = model
    tok, _ = _tokens(2, 6, cfg.vocab, seed=3)
    tok[1] = tok[0]

    def run(cache, rows_pos):
        outs = []
        for t in range(tok.shape[1]):
            pos = torch.as_tensor([[p + t] for p in rows_pos])
            with torch.inference_mode():
                lg, _, cache = transformer.lm_apply(
                    params, cfg, torch.from_numpy(tok[:, t:t + 1]), pos,
                    cache=cache)
            outs.append(lg[:, 0])
        return torch.stack(outs, 1), cache

    cache = transformer.init_cache(cfg, 2, 16, params=params, per_slot=True)
    first, cache = run(cache, [0, 0])
    torch.testing.assert_close(first[0], first[1], rtol=0, atol=0)
    cache = transformer.reset_slots(cache, np.array([False, True]))
    assert cache["pos"].tolist() == [6, 0]
    again, _ = run(cache, [6, 0])
    # the recycled row replays the fresh stream exactly; the other row
    # kept its history and moved on
    torch.testing.assert_close(again[1], first[1], rtol=0, atol=0)
    assert not torch.allclose(again[0], first[0])
    with pytest.raises(ValueError, match="per-slot"):
        transformer.reset_slots(transformer.init_cache(cfg, 1, 4, device="cpu"),
                                [True])


@pytest.mark.parametrize("admission", ["lockstep", "continuous"])
def test_engine_token_ids_match_jax(model, sessions, admission):
    cfg = model[2]
    jsession, session = sessions
    reqs = synthetic_requests(4, 5, vocab=cfg.vocab, p_arrive=0.6,
                              prompt_len=(3, 6), gen_len=(2, 5))
    jreqs = [JRequest(rid=r.rid, prompt=r.prompt,
                      max_new_tokens=r.max_new_tokens, arrival=r.arrival)
             for r in reqs]
    want = JEngine(jsession, 3, 12, admission=admission).run(jreqs)
    got = Engine(session, 3, 12, admission=admission).run(reqs)
    assert max_seq_for(reqs) <= 12
    assert got.steps == want.steps
    assert [r.tokens for r in got.records] == [r.tokens for r in want.records]
    assert [(r.admitted, r.completed, r.slot) for r in got.records] == [
        (r.admitted, r.completed, r.slot) for r in want.records]
    assert got.generated_tokens == sum(r.max_new_tokens for r in reqs)
