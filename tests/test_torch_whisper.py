"""The port's whisper-large-v3 (the audio encoder-decoder) against the JAX
package at its smoke config: 2 encoder and 2 decoder layers, d 64, 24
frames.

The config field by field and its parameter counts; the ``lm_init``
tree; cross-attention (``attention(kv_x=...)``) in one query chunk and in
several; ``lm_apply`` with frames on the dense, masked and grouped paths
(plans and signature bitwise JAX's); the frames-bearing first decode
step and the cache-only steps after it; prefill against token-by-token
decode; ``reset_slots``; the loss and gradients of a training step with
frames; and the reference's two faults around frames (ROADMAP Queue 3),
pinned: without frames JAX's cross layer sees future tokens (the port
raises), and a serving ``Engine`` decodes against a zero encoder output
(the port mirrors it).

The same numpy weights (drawn from a seed) go to both packages through
``interop``. JAX runs its kernels through their plain reference
(``use_reference_impl``). f32 tolerances: 1e-5 for a layer, 1e-4 for a
model (sums taken in other orders move values by ~1e-7).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite's workers share the host's cores

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import kernels as jkernels  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.core.flgw import FLGWConfig as JFLGW  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import config as jconfig  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServeSession as JSession  # noqa: E402
from repro.serving import plan_cache as jplan_cache  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import encoder, grouped  # noqa: E402
from repro_torch.core.flgw import FLGWConfig  # noqa: E402
from repro_torch.models import attention, transformer  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.serving import (Engine, ServeSession, plan_cache,  # noqa: E402
                                 synthetic_requests)
from repro_torch.serving import __main__ as serve_cli  # noqa: E402
from repro_torch.train import step as step_lib  # noqa: E402

ARCH = "whisper_large_v3"
TARGETS = ("mlp", "attn")
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
BATCH, SEQ = 2, 16
# below the 24 frames and the 16 tokens: the encoder and the decoder both
# take the query-chunked core
Q_CHUNK = 8


@pytest.fixture(scope="module", autouse=True)
def _jax_reference_kernels():
    with jkernels.use_reference_impl():
        yield


@pytest.fixture(autouse=True)
def _fresh_plan_caches():
    plan_cache.clear()
    jplan_cache.clear()
    yield


def _cfgs(path="grouped"):
    """The f32 smoke configs of both packages, FLGW G=4 on ``path`` for
    mlp and attn (None: no FLGW)."""
    fl = {} if path is None else dict(flgw_groups=4, flgw_path=path,
                                      flgw_targets=TARGETS)
    return (registry.get_smoke_config(ARCH, dtype=torch.float32, **fl),
            jregistry.get_smoke_config(ARCH, dtype=jnp.float32, **fl))


@functools.lru_cache(maxsize=None)
def _build(path="grouped", seed=0):
    """(cfg, jcfg, numpy tree): one weight draw from the port's init, in
    f32, for both packages."""
    cfg, jcfg = _cfgs(path)
    tree = interop.tree_to_numpy(
        transformer.lm_init(torch.Generator().manual_seed(seed), cfg))
    return cfg, jcfg, tree


def _params(tree):
    return interop.lm_params_from_numpy(tree), jax.tree.map(jnp.asarray,
                                                            tree)


@functools.lru_cache(maxsize=None)
def _jplans(path="grouped"):
    cfg, jcfg, tree = _build(path)
    return jax.jit(lambda p: jtransformer.encode_plans(p, jcfg))(
        _params(tree)[1])


def _tokens(cfg, s=SEQ, seed=1, b=BATCH):
    t = np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)
                                             ).astype(np.int32)
    pos = np.ascontiguousarray(np.broadcast_to(np.arange(s, dtype=np.int32),
                                               (b, s)))
    return t, pos


def _frames(cfg, seed=2, b=BATCH):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.num_frames, cfg.d_model)).astype(np.float32)


def _fields(cfg) -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name == "dtype":
            v = str(v).split(".")[-1].split("'")[0]
        elif f.name == "pattern":
            v = tuple(dataclasses.asdict(s) for s in v)
        out[f.name] = v
    return out


# ---------------------------------------------------------------------------
# Config, counts, tree
# ---------------------------------------------------------------------------

def test_config_and_param_counts_equal_jax():
    assert ARCH in registry.ARCH_IDS
    assert set(registry.ARCH_IDS) == set(jregistry.ARCH_IDS) - {"ic3net"}
    for get, jget in ((registry.get_config, jregistry.get_config),
                      (registry.get_smoke_config,
                       jregistry.get_smoke_config)):
        cfg, jcfg = get(ARCH), jget(ARCH)
        assert _fields(cfg) == _fields(jcfg)
        assert tconfig.param_count(cfg) == jconfig.param_count(jcfg)
        assert tconfig.active_param_count(cfg) == \
            jconfig.active_param_count(jcfg)
    assert tconfig.param_count(registry.get_config(ARCH)) == 1_534_722_560


@pytest.mark.parametrize("path", [None, "grouped"])
def test_lm_init_tree_equals_jax(path):
    cfg, jcfg, tree = _build(path)
    jtree = jax.eval_shape(lambda k: jtransformer.lm_init(k, jcfg)[0],
                           jax.random.PRNGKey(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), jtree)
    assert jax.tree.map(lambda a: tuple(a.shape), tree) == shapes
    assert list(tree) == ["embed", "blocks", "final_norm", "encoder",
                          "enc_norm"]
    assert set(tree["blocks"]["slot0"]) == {"norm1", "mixer", "norm_x",
                                           "cross", "norm2", "ffn"}
    assert set(tree["encoder"]["slot0"]) == {"norm1", "mixer", "norm2",
                                            "ffn"}
    assert tree["encoder"]["slot0"]["ffn"].keys() == {"up", "down"}
    # interop carries the encoder stack and the cross slot both ways
    params = interop.lm_params_from_numpy(tree)
    back = interop.tree_to_numpy(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert params["encoder"]["slot0"]["mixer"]["q"]["w"].shape[0] == \
        cfg.encoder_layers
    assert params["blocks"]["slot0"]["cross"]["k"]["w"].shape == (
        cfg.n_blocks, cfg.d_model, cfg.n_kv_heads * cfg.head_dim)
    assert params["blocks"]["slot0"]["norm_x"]["scale"].shape == (
        cfg.n_blocks, cfg.d_model)


def test_plans_and_signature_are_bitwise_jax():
    cfg, _, tree = _build()
    params = interop.lm_params_from_numpy(tree)
    jplans = _jplans()
    plans = transformer.encode_plans(params, cfg)
    assert int(plans.sig) == int(np.asarray(jplans.sig))
    assert set(plans.plans) == {"blocks", "encoder"}
    assert set(plans.plans["encoder"]["slot0"]) == {"mixer", "ffn"}
    assert set(plans.plans["blocks"]["slot0"]) == {"mixer", "cross", "ffn"}
    ref = interop.plans_from_numpy(jplans.plans)
    n = 0
    for path, _ in grouped.iter_flgw_layers(params):
        a, b = ref, plans.plans
        for name in path:
            a, b = a[name], b[name]
        # ids and validity; the groups differ at item M-1 by the
        # reference's make_plan fault (ROADMAP Queue 3)
        for x, y in zip(a[:4], b[:4]):
            assert torch.equal(x, y), path
        n += 1
    assert n == 16          # encoder 4 + 2, decoder 4 + 4 + 2


# ---------------------------------------------------------------------------
# Cross-attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q_chunk", [16, 4, 5])   # one chunk; 3; 4 (divisor)
@pytest.mark.parametrize("path", [None, "grouped"])
def test_cross_attention_matches_jax(path, q_chunk):
    cfg, jcfg = _cfgs(None)
    fl = None if path is None else FLGWConfig(groups=4, path=path)
    jfl = None if path is None else JFLGW(groups=4, path=path)
    tree = interop.tree_to_numpy(attention.attn_init(
        torch.Generator().manual_seed(3), cfg, flgw=fl))
    p, jp = _params(tree)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((BATCH, 12, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((BATCH, 7, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 15), (BATCH, 12))
    want, jc = jattention.attention(
        jp, jnp.asarray(x), jnp.asarray(pos, jnp.int32), jcfg, causal=False,
        kv_x=jnp.asarray(mem), q_chunk=q_chunk, flgw=jfl)
    with torch.no_grad():
        got, c = attention.attention(
            p, torch.from_numpy(x), torch.from_numpy(pos.copy()), cfg,
            causal=False, kv_x=torch.from_numpy(mem), q_chunk=q_chunk,
            flgw=fl)
    assert c is None and jc is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    # no causal mask and no RoPE on the queries: a query at any position
    # reads every key, whatever its own position
    with torch.no_grad():
        moved, _ = attention.attention(
            p, torch.from_numpy(x), torch.zeros((BATCH, 12), dtype=torch.long),
            cfg, causal=False, kv_x=torch.from_numpy(mem), q_chunk=q_chunk,
            flgw=fl)
    np.testing.assert_array_equal(moved.numpy(), got.numpy())
    with pytest.raises(ValueError, match="no KV cache"):
        attention.attention(p, torch.from_numpy(x), torch.from_numpy(
            pos.copy()), cfg, kv_x=torch.from_numpy(mem), flgw=fl,
            cache={"k": None, "v": None, "pos": torch.zeros(())})


# ---------------------------------------------------------------------------
# lm_apply with frames
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", [None, "masked", "grouped"])
def test_lm_apply_with_frames_matches_jax(path):
    cfg, jcfg, tree = _build(path)
    params, jparams = _params(tree)
    tok, pos = _tokens(cfg)
    fr = _frames(cfg)
    jplans = _jplans() if path == "grouped" else None
    plans = transformer.encode_plans(params, cfg) if path == "grouped" \
        else None
    want, _, _ = jtransformer.lm_apply(
        jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos),
        frames=jnp.asarray(fr), q_chunk=Q_CHUNK, remat=False, plans=jplans)
    with torch.no_grad():
        got, aux, _ = transformer.lm_apply(
            params, cfg, torch.from_numpy(tok), torch.from_numpy(pos),
            frames=torch.from_numpy(fr), q_chunk=Q_CHUNK, plans=plans)
    assert got.shape == (BATCH, SEQ, cfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if path == "grouped":
        # one chunk (the unchunked plain core) gives the same logits
        with torch.no_grad():
            one, _, _ = transformer.lm_apply(
                params, cfg, torch.from_numpy(tok), torch.from_numpy(pos),
                frames=torch.from_numpy(fr), q_chunk=512, plans=plans)
        np.testing.assert_allclose(one.numpy(), got.numpy(), **TOL)


def _decode_run(cfg, jcfg, params, jparams, tok, fr, jplans):
    """Both packages' lockstep decode of ``tok``: the first step with the
    frames (the encoder runs and writes ``encoder_out`` into the cache),
    the rest from the cache. Returns (port logits, JAX logits, port
    cache, JAX cache)."""
    steps = tok.shape[1]
    jcache = jtransformer.init_cache(jcfg, BATCH, steps)
    cache = transformer.init_cache(cfg, BATCH, steps, params=params,
                                   device="cpu")
    if jplans is not None:
        from repro.core import encoder as jencoder
        jcache["plans"] = jencoder.attach_compact(jplans, jparams)
        assert grouped.has_compact(cache["plans"].plans)
    else:
        cache["plans"] = ()
    apply = jax.jit(lambda p, t, ps, c, **kw: jtransformer.lm_apply(
        p, jcfg, t, ps, cache=c, remat=False, **kw))
    got, want = [], []
    for t in range(steps):
        kw = {} if t else {"frames": fr}
        tp = np.full((BATCH, 1), t, np.int32)
        w, _, jcache = apply(jparams, jnp.asarray(tok[:, t:t + 1]),
                             jnp.asarray(tp), jcache,
                             **{k: jnp.asarray(v) for k, v in kw.items()})
        with torch.inference_mode():
            g, _, cache = transformer.lm_apply(
                params, cfg, torch.from_numpy(tok[:, t:t + 1]),
                torch.from_numpy(tp), cache=cache,
                **{k: torch.from_numpy(v) for k, v in kw.items()})
        got.append(g.numpy()[:, 0])
        want.append(np.asarray(w)[:, 0])
    return np.stack(got, 1), np.stack(want, 1), cache, jcache


@pytest.mark.parametrize("path", [None, "grouped"])
def test_decode_with_frames_then_from_the_cache_matches_jax(path):
    cfg, jcfg, tree = _build(path)
    params, jparams = _params(tree)
    tok, _ = _tokens(cfg, 6, seed=5)
    fr = _frames(cfg, seed=6)
    got, want, cache, jcache = _decode_run(
        cfg, jcfg, params, jparams, tok, fr,
        _jplans() if path == "grouped" else None)
    np.testing.assert_allclose(got, want, **TOL)
    # the cache carries the encoder's output the first step wrote
    np.testing.assert_allclose(cache["encoder_out"].numpy(),
                               np.asarray(jcache["encoder_out"]), **TOL)
    assert float(cache["encoder_out"].abs().max()) > 0


def test_prefill_last_logits_equal_token_by_token_decode():
    """The serving prefill (frames in the batch) against a decode that
    takes the same tokens one at a time, its first step with the frames:
    the same encoder output, the same causal decoder."""
    cfg, _, tree = _build()
    params = interop.lm_params_from_numpy(tree)
    tok, pos = _tokens(cfg, 10, seed=7)
    fr = _frames(cfg, seed=8)
    session = ServeSession(cfg, params)
    batch = {"tokens": torch.from_numpy(tok), "positions":
             torch.from_numpy(pos), "frames": torch.from_numpy(fr)}
    last = session.prefill(batch)
    with torch.inference_mode():
        full, _, _ = transformer.lm_apply(
            params, cfg, batch["tokens"], batch["positions"],
            frames=batch["frames"], plans=session.plans)
    cache = session.new_cache(BATCH, 10)
    assert cache["encoder_out"].shape == (BATCH, cfg.num_frames, cfg.d_model)
    steps = []
    with torch.inference_mode():
        for t in range(10):
            kw = {} if t else {"frames": batch["frames"]}
            lg, _, cache = transformer.lm_apply(
                params, cfg, batch["tokens"][:, t:t + 1],
                batch["positions"][:, t:t + 1], cache=cache, **kw)
            steps.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(),
                               **TOL)
    np.testing.assert_allclose(steps[-1][:, None].numpy(), last.numpy(),
                               **TOL)
    # session.decode keeps the cache's encoder output step after step
    eo = cache["encoder_out"].clone()
    nxt, cache = session.decode(cache, batch["tokens"][:, :1],
                                session.greedy_positions(BATCH, 10))
    assert torch.equal(cache["encoder_out"], eo) and nxt.shape == (BATCH, 1)


def test_reset_slots_leaves_the_encoder_output():
    cfg, _, tree = _build()
    params = interop.lm_params_from_numpy(tree)
    cache = transformer.init_cache(cfg, 3, 8, params=params, per_slot=True)
    cache["encoder_out"].normal_()
    before = cache["encoder_out"].clone()
    cache["pos"] += 4
    out = transformer.reset_slots(cache, torch.tensor([False, True, False]))
    assert out["pos"].tolist() == [4, 0, 4]
    assert torch.equal(out["encoder_out"], before)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", [None, "grouped"])
def test_train_loss_and_grads_with_frames_match_jax(path):
    cfg, jcfg, tree = _build(path)
    params, jparams = _params(tree)
    tok, pos = _tokens(cfg)
    tgt = np.roll(tok, -1, axis=1)
    fr = _frames(cfg)
    jplans = _jplans() if path == "grouped" else None
    plans = transformer.encode_plans(params, cfg) if path == "grouped" \
        else None
    jbatch = {"tokens": jnp.asarray(tok), "positions": jnp.asarray(pos),
              "targets": jnp.asarray(tgt), "frames": jnp.asarray(fr)}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jstep._loss_fn(p, jbatch, jcfg, Q_CHUNK, False,
                                 ce_chunk=8, plans=jplans),
        has_aux=True)(jparams)
    batch = {"tokens": torch.from_numpy(tok).long(),
             "positions": torch.from_numpy(pos).long(),
             "targets": torch.from_numpy(tgt).long(),
             "frames": torch.from_numpy(fr)}
    loss, _, grads = step_lib.loss_and_grads(params, batch, cfg,
                                             q_chunk=Q_CHUNK, ce_chunk=8,
                                             plans=plans)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    got = interop.tree_to_numpy(grads)
    flat = jax.tree_util.tree_flatten_with_path(got)[0]
    want = jax.tree.leaves(jgrads)
    assert len(flat) == len(want)
    reached = set()
    for (kp, a), b in zip(flat, want):
        a, b = np.asarray(a), np.asarray(b)
        keep = np.ones(a.shape, bool)
        # the reference's STE uses the wrong group at item M-1 / N-1 of
        # every grouped projection, the encoder's and the cross layer's
        # too (ROADMAP Queue 3)
        if path == "grouped" and kp[-1].key == "ig":
            keep[..., -1, :] = False
        elif path == "grouped" and kp[-1].key == "og":
            keep[..., :, -1] = False
        np.testing.assert_allclose(a[keep], b[keep], **TOL,
                                   err_msg=jax.tree_util.keystr(kp))
        if np.abs(a).max() > 0:
            reached.add(kp[0].key)
    # the loss reaches the encoder through the cross layers
    assert {"encoder", "enc_norm", "blocks", "embed"} <= reached


def test_train_step_takes_a_frames_batch():
    from repro_torch.train import state as state_lib
    cfg, _, _ = _build()
    state = state_lib.init_state(torch.Generator().manual_seed(0), cfg)
    tok, pos = _tokens(cfg)
    batch = {"tokens": torch.from_numpy(tok).long(),
             "positions": torch.from_numpy(pos).long(),
             "targets": torch.from_numpy(np.roll(tok, -1, axis=1)).long(),
             "frames": torch.from_numpy(_frames(cfg))}
    step = step_lib.make_train_step(cfg, microbatches=2)
    state, m = step(state, batch)
    assert int(state.step) == 1 and np.isfinite(float(m["loss"]))
    assert isinstance(state.plans, encoder.PlanState)


# ---------------------------------------------------------------------------
# The reference's faults around frames (ROADMAP Queue 3), pinned
# ---------------------------------------------------------------------------

def test_reference_cross_attention_without_frames_sees_the_future():
    """Fault 1: JAX's ``lm_apply`` without frames or a cache gives the
    cross layer ``kv_x=None``, so it attends the decoder's own stream
    with no causal mask: the logits before position t move when token t
    changes. The port raises there. With frames both are causal and
    agree. If the reference is ever fixed, flip the first assertion."""
    cfg, jcfg, tree = _build(None)
    params, jparams = _params(tree)
    tok, pos = _tokens(cfg)
    moved = tok.copy()
    moved[:, 10] = (moved[:, 10] + 1) % cfg.vocab

    def jax_logits(t, **kw):
        return np.asarray(jtransformer.lm_apply(
            jparams, jcfg, jnp.asarray(t), jnp.asarray(pos), remat=False,
            **kw)[0])
    leak = np.abs(jax_logits(moved) - jax_logits(tok))[:, :10].max()
    assert leak > 1e-3
    with pytest.raises(ValueError, match="no frames") as e:
        transformer.lm_apply(params, cfg, torch.from_numpy(tok),
                             torch.from_numpy(pos))
    assert "attention.py:103-112" in str(e.value)
    fr = _frames(cfg)
    for t in (tok, moved):
        want = jax_logits(t, frames=jnp.asarray(fr))
        with torch.no_grad():
            got = transformer.lm_apply(params, cfg, torch.from_numpy(t),
                                       torch.from_numpy(pos),
                                       frames=torch.from_numpy(fr))[0]
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        if t is tok:
            before, jbefore = got.numpy(), want
    np.testing.assert_array_equal(got.numpy()[:, :10], before[:, :10])
    np.testing.assert_array_equal(want[:, :10], jbefore[:, :10])


def test_engine_decodes_against_a_zero_encoder_output_as_jax():
    """Fault 2: no serving entry point carries audio past the prefill.
    The ``Engine`` decodes from ``init_cache``'s zero ``encoder_out``,
    and with no bias in the projections each cross layer adds exactly 0.
    The port mirrors it: the same greedy tokens as JAX's Engine."""
    cfg, jcfg, tree = _build("grouped", seed=1)
    params, jparams = _params(tree)
    reqs = synthetic_requests(4, 6, vocab=cfg.vocab, p_arrive=0.6,
                              prompt_len=(3, 6), gen_len=(2, 5))
    jreqs = [JRequest(rid=r.rid, prompt=r.prompt,
                      max_new_tokens=r.max_new_tokens, arrival=r.arrival)
             for r in reqs]
    want = JEngine(JSession(jcfg, jparams), 3, 12,
                   admission="lockstep").run(jreqs)
    session = ServeSession(cfg, params)
    got = Engine(session, 3, 12, admission="lockstep").run(reqs)
    assert got.steps == want.steps
    assert [r.tokens for r in got.records] == [r.tokens for r in want.records]
    # every cross layer, in both packages, adds exactly 0 against zeros
    cache = session.new_cache(3, 12)
    assert not cache["encoder_out"].any()
    jzero = jtransformer.init_cache(jcfg, 3, 12)["encoder_out"]
    h = np.random.default_rng(9).standard_normal(
        (3, 1, cfg.d_model)).astype(np.float32)
    pos = np.full((3, 1), 5, np.int32)
    fl = FLGWConfig(groups=4, path="grouped")
    bplans = cache["plans"].plans["blocks"]
    jplans = jax.jit(lambda p: jtransformer.encode_plans(p, jcfg))(jparams)
    for i in range(cfg.n_blocks):
        cross = transformer._index(params["blocks"], i)["slot0"]["cross"]
        with torch.inference_mode():
            out, _ = attention.attention(
                cross, torch.from_numpy(h), torch.from_numpy(pos), cfg,
                causal=False, kv_x=cache["encoder_out"], flgw=fl,
                plans=transformer._index(bplans, i)["slot0"]["cross"])
        assert not out.any()
        jcross = jax.tree.map(lambda a: a[i],
                              jparams["blocks"]["slot0"]["cross"])
        jout, _ = jattention.attention(
            jcross, jnp.asarray(h), jnp.asarray(pos), jcfg, causal=False,
            kv_x=jzero, flgw=JFLGW(groups=4, path="grouped"),
            plans=jax.tree.map(lambda a: a[i],
                               jplans.plans["blocks"]["slot0"]["cross"]))
        assert not np.asarray(jout).any()


def test_serving_cli_refuses_whisper_without_frames(capsys):
    with pytest.raises(SystemExit) as e:
        serve_cli.main(["--arch", ARCH, "--device", "cpu"])
    assert e.value.code != 0
    err = capsys.readouterr().err
    assert "no frames" in err and "attention.py:103-112" in err
