"""The port's SSM and hybrid families against the JAX package:
mamba2-1.3b (pure Mamba2 blocks, no FFN) and jamba-1.5-large (attention,
SSM, MLP and MoE slots) at their smoke configs.

The Mamba2 layer's pieces (``_causal_conv``, ``_ssd_chunked`` at one and
several chunks, ``ssm_step``, ``ssm()`` prefill and decode); both configs
field by field, their parameter counts, ``lm_init`` trees and plans;
``lm_apply`` logits on the dense, masked and grouped paths; prefill
against token-by-token decode (JAX's ``test_parity_ssm_decode`` and
``test_parity_hybrid_jamba`` on the port); decode on a cached PlanState
against plan-less decode; ``reset_slots`` on SSM state; a continuous
``Engine`` run; and the reference's SSD gradient fault, pinned.

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
from repro.models import config as jconfig  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
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
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import ssm, transformer  # noqa: E402
from repro_torch.models.config import ModelConfig, SlotSpec  # noqa: E402
from repro_torch.serving import (Engine, ServeSession, plan_cache,  # noqa: E402
                                 synthetic_requests)
from repro_torch.train import step as step_lib  # noqa: E402

ARCHS = ("mamba2_1_3b", "jamba_1_5_large")
TARGETS = ("ssm", "moe", "mlp", "attn")
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
# JAX's tests/test_decode_parity.py: bf16, decode against the full forward
PARITY_TOL = dict(rtol=2e-2, atol=5e-2)
BATCH = 2


@pytest.fixture(scope="module", autouse=True)
def _jax_reference_kernels():
    with jkernels.use_reference_impl():
        yield


@pytest.fixture(autouse=True)
def _fresh_plan_caches():
    plan_cache.clear()
    jplan_cache.clear()
    yield


def masked_ssd_chunked(xh, bm, cm, dt, a_neg, chunk: int,
                       unroll: bool = False):
    """``repro.models.ssm._ssd_chunked`` with the causal mask applied
    before the ``exp`` (``where(causal, exp(where(causal, seg, 0)), 0)``):
    the same forward, finite gradients. Tests swap it in with
    ``monkeypatch``; no file of the JAX package changes."""
    b, s, h, p = xh.shape
    n = bm.shape[-1]
    nc = s // chunk

    def to_chunks(t):
        return t.reshape(b, nc, chunk, *t.shape[2:]).transpose(
            1, 0, *range(2, t.ndim + 1))

    def body(hstate, inp):
        x_i, b_i, c_i, dt_i = inp
        cs = jnp.cumsum(dt_i * a_neg, axis=1)
        y_off = jnp.einsum("bln,bhpn->blhp", c_i, hstate) * \
            jnp.exp(cs)[..., None]
        cb = jnp.einsum("bln,bmn->blm", c_i, b_i)
        seg = cs[:, :, None, :] - cs[:, None, :, :]
        li = jnp.arange(chunk)
        causal = (li[:, None] >= li[None, :])[None, :, :, None]
        decay = jnp.where(causal, jnp.exp(jnp.where(causal, seg, 0.0)), 0.0)
        y_diag = jnp.einsum("blm,blmh,bmh,bmhp->blhp",
                            cb, decay, dt_i, x_i.astype(jnp.float32))
        dec_state = jnp.exp(cs[:, -1:, :] - cs)
        dbx = jnp.einsum("bln,blh,blhp->bhpn",
                         b_i, dt_i * dec_state, x_i.astype(jnp.float32))
        hstate = hstate * jnp.exp(cs[:, -1])[..., None, None] + dbx
        return hstate, (y_off + y_diag).astype(xh.dtype)

    h0 = jnp.zeros((b, h, p, n), jnp.float32)
    _, yc = jax.lax.scan(body, h0, tuple(map(to_chunks, (xh, bm, cm, dt))))
    return yc.transpose(1, 0, 2, 3, 4).reshape(b, s, h, p)


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


def _cfgs(arch, path="grouped"):
    """The f32 smoke configs of both packages, FLGW G=4 on ``path`` for
    every target (None: no FLGW)."""
    fl = {} if path is None else dict(flgw_groups=4, flgw_path=path,
                                      flgw_targets=TARGETS)
    return (registry.get_smoke_config(arch, dtype=torch.float32, **fl),
            jregistry.get_smoke_config(arch, dtype=jnp.float32, **fl))


@functools.lru_cache(maxsize=None)
def _build(arch, path="grouped"):
    """(cfg, jcfg, params, jparams): one weight draw from the port's
    init at seed 0, in f32, given to both packages."""
    cfg, jcfg = _cfgs(arch, path)
    tree = interop.tree_to_numpy(
        transformer.lm_init(torch.Generator().manual_seed(0), cfg))
    return (cfg, jcfg, interop.lm_params_from_numpy(tree),
            jax.tree.map(jnp.asarray, tree))


@functools.lru_cache(maxsize=None)
def _jplans(arch, path="grouped"):
    """JAX's PlanState of ``_build(arch, path)``'s weights (encoded under
    jit: op by op it takes seconds a call)."""
    _, jcfg, _, jparams = _build(arch, path)
    return jax.jit(lambda p: jtransformer.encode_plans(p, jcfg))(jparams)


def _tokens(cfg, s, seed=1, b=BATCH):
    t = np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)
                                             ).astype(np.int32)
    pos = np.ascontiguousarray(np.broadcast_to(np.arange(s, dtype=np.int32),
                                               (b, s)))
    return t, pos


# ---------------------------------------------------------------------------
# The Mamba2 layer
# ---------------------------------------------------------------------------

def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(0)
    x, w = _randn(rng, 2, 11, 24), _randn(rng, 4, 24)
    np.testing.assert_allclose(
        ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jssm._causal_conv(jnp.asarray(x), jnp.asarray(w))),
        **LAYER_TOL)


def _ssd_inputs(seed, b=2, s=16, h=3, p=8, n=5):
    rng = np.random.default_rng(seed)
    xh, bm, cm = _randn(rng, b, s, h, p), _randn(rng, b, s, n), \
        _randn(rng, b, s, n)
    dt = np.log1p(np.exp(_randn(rng, b, s, h)))            # softplus > 0
    a_neg = -np.exp(np.log(np.linspace(1.0, 16.0, h, dtype=np.float32)))
    return xh, bm, cm, dt.astype(np.float32), a_neg


@pytest.mark.parametrize("chunk", [16, 4])      # one chunk, four
def test_ssd_chunked_matches_jax(chunk):
    args = _ssd_inputs(chunk)
    got = ssm._ssd_chunked(*map(torch.from_numpy, args), chunk)
    want = jssm._ssd_chunked(*map(jnp.asarray, args), chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    with pytest.raises(ValueError, match="divide"):
        ssm._ssd_chunked(*map(torch.from_numpy, args), 5)


def test_ssm_step_matches_jax():
    rng = np.random.default_rng(3)
    args = (_randn(rng, 2, 3, 8, 5), _randn(rng, 2, 3, 8), _randn(rng, 2, 5),
            _randn(rng, 2, 5), np.abs(_randn(rng, 2, 3)),
            -np.abs(_randn(rng, 3)))
    state, y = ssm.ssm_step(*map(torch.from_numpy, args))
    jstate, jy = jssm.ssm_step(*map(jnp.asarray, args))
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **LAYER_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **LAYER_TOL)


PATHS = ("dense", "masked", "grouped")


@functools.lru_cache(maxsize=None)
def _layer(path):
    """One mamba2 smoke layer's weights (numpy, the port's init at seed
    0) with FLGW G=4 on ``path`` (dense: none)."""
    cfg, _ = _cfgs("mamba2_1_3b", None)
    fl = None if path == "dense" else FLGWConfig(groups=4, path=path)
    return interop.tree_to_numpy(ssm.ssm_init(
        torch.Generator().manual_seed(0), cfg, flgw=fl))


@pytest.mark.parametrize("path", PATHS)
def test_ssm_prefill_and_decode_match_jax(path):
    cfg, jcfg = _cfgs("mamba2_1_3b", None)
    tree = _layer(path)
    p, jp = interop.lm_params_from_numpy(tree), jax.tree.map(jnp.asarray, tree)
    fl = None if path == "dense" else FLGWConfig(groups=4, path=path)
    jfl = None if path == "dense" else JFLGW(groups=4, path=path)
    rng = np.random.default_rng(4)
    x = _randn(rng, 2, 12, cfg.d_model)
    # prefill in three chunks of 4
    want, _ = jssm.ssm(jp, jnp.asarray(x), jcfg, chunk=4, flgw=jfl)
    got = ssm.ssm(p, torch.from_numpy(x), cfg, chunk=4, flgw=fl)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **LAYER_TOL)
    # one decode step from a random state and conv ring, written in place
    state = _randn(rng, 2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    conv = _randn(rng, 2, cfg.conv_width - 1, cfg.d_inner + 2 * cfg.ssm_state)
    want, jnew = jssm.ssm(jp, jnp.asarray(x[:, :1]), jcfg, flgw=jfl,
                          cache={"state": jnp.asarray(state),
                                 "conv": jnp.asarray(conv)})
    cache = {"state": torch.from_numpy(state.copy()),
             "conv": torch.from_numpy(conv.copy())}
    with torch.no_grad():
        got = ssm.ssm(p, torch.from_numpy(x[:, :1]), cfg, flgw=fl,
                      cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    for leaf in ("state", "conv"):
        np.testing.assert_allclose(cache[leaf].numpy(),
                                   np.asarray(jnew[leaf]), **LAYER_TOL)
    with pytest.raises(ValueError, match="one token"):
        ssm.ssm(p, torch.from_numpy(x[:, :2]), cfg, flgw=fl, cache=cache)


# ---------------------------------------------------------------------------
# Configs, counts, trees, plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_jax_field_by_field(arch):
    assert arch in registry.ARCH_IDS
    for get, jget in ((registry.get_config, jregistry.get_config),
                      (registry.get_smoke_config,
                       jregistry.get_smoke_config)):
        assert _fields(get(arch)) == _fields(jget(arch))


@pytest.mark.parametrize("arch,count", [("mamba2_1_3b", 1_343_628_288),
                                        ("jamba_1_5_large", 397_108_075_136)])
def test_param_counts_equal_jax(arch, count):
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    assert tconfig.param_count(cfg) == jconfig.param_count(jcfg) == count
    assert tconfig.active_param_count(cfg) == \
        jconfig.active_param_count(jcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_init_tree_is_jax_and_plans_are_bitwise(arch):
    cfg, jcfg, params, jparams = _build(arch)
    shapes = jax.eval_shape(
        lambda k: jtransformer.lm_init(k, jcfg)[0], jax.random.PRNGKey(0))
    ours = transformer.lm_init(torch.Generator().manual_seed(0), cfg)
    assert jax.tree.map(lambda a: tuple(a.shape), ours) == \
        jax.tree.map(lambda a: tuple(a.shape), shapes)
    assert jax.tree.map(lambda a: str(a.dtype).split(".")[-1], ours) == \
        jax.tree.map(lambda a: str(a.dtype), shapes)
    jplans = _jplans(arch)
    plans = transformer.encode_plans(params, cfg)
    assert int(plans.sig) == int(np.asarray(jplans.sig))
    ref = interop.plans_from_numpy(jplans.plans)
    n = 0
    for path, _ in grouped.iter_flgw_layers(params):
        a, b = ref, plans.plans
        for name in path:
            a, b = a[name], b[name]
        # ids and validity bitwise; the groups differ only at item M-1 by
        # the reference's make_plan fault (ROADMAP Queue 3)
        for x, y in zip(a[:4], b[:4]):
            assert torch.equal(x, y), path
        for x, y in zip(a[4:6], b[4:6]):
            assert torch.equal(x[..., :-1], y[..., :-1]), path
        n += 1
    # mamba2: in, out; jamba: attention + MLP (7), 4 x SSM + MoE (5),
    # 3 x SSM + MLP (5)
    assert n == (2 if arch == "mamba2_1_3b" else 7 + 4 * 5 + 3 * 5)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_apply_logits_match_jax(arch, path):
    cfg, jcfg, params, jparams = _build(arch, path)
    tok, pos = _tokens(cfg, 16)
    jplans = _jplans(arch, path)
    want, jaux, _ = jtransformer.lm_apply(
        jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos), remat=False,
        plans=jplans)
    with torch.inference_mode():
        got, aux, _ = transformer.lm_apply(
            params, cfg, torch.from_numpy(tok), torch.from_numpy(pos),
            plans=transformer.encode_plans(params, cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


# ---------------------------------------------------------------------------
# Decode: against the full forward, on cached plans, recycled slots
# ---------------------------------------------------------------------------

def _full_then_decode(cfg, seq):
    """tests/test_decode_parity.py's ``_full_then_decode`` on the port:
    a dropless full forward against token-by-token decode through the
    KV and SSM caches, in the config's own dtype (bf16)."""
    params = transformer.lm_init(torch.Generator().manual_seed(0), cfg)
    tok, pos = _tokens(cfg, seq, seed=5)
    tok, pos = torch.from_numpy(tok), torch.from_numpy(pos)
    with torch.inference_mode():
        full, _, _ = transformer.lm_apply(params, cfg, tok, pos,
                                          moe_dropless=True)
        cache = transformer.init_cache(cfg, BATCH, seq, device="cpu")
        steps = []
        for t in range(seq):
            lg, _, cache = transformer.lm_apply(
                params, cfg, tok[:, t:t + 1], pos[:, t:t + 1], cache=cache)
            steps.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(steps, 1).float().numpy(),
                               full.float().numpy(), **PARITY_TOL)


def test_parity_ssm_decode():
    _full_then_decode(registry.get_smoke_config("mamba2_1_3b"), seq=10)


def test_parity_hybrid_jamba():
    _full_then_decode(registry.get_smoke_config("jamba_1_5_large"), seq=8)


def test_cached_plans_decode_as_plan_less_on_ssm_slots():
    """tests/test_decode_parity.py's ``test_grouped_serve_parity_ssm_slots``
    on the port: decode on the PlanState beside the caches (compact
    weights attached: fused_bmm) against plan-less decode (a per-call
    encode: grouped_bmm). The reference holds it bitwise, which fails on
    the CPU (ROADMAP Queue 3); the two paths sum in other orders."""
    cfg = ModelConfig(
        name="g_ssm", family="ssm", n_layers=2, d_model=32, n_heads=2,
        n_kv_heads=2, head_dim=16, d_ff=64, vocab=64,
        pattern=(SlotSpec(mixer="ssm", ffn="mlp"),), ssm_state=8,
        ssm_head_dim=16, flgw_groups=4, flgw_path="grouped",
        flgw_targets=("ssm", "mlp"), dtype=torch.float32, remat=False)
    params = transformer.lm_init(torch.Generator().manual_seed(3), cfg)
    tok, pos = _tokens(cfg, 5, seed=6, b=1)
    runs = {}
    with torch.inference_mode():
        for cached in (True, False):
            cache = transformer.init_cache(
                cfg, 1, 5, params=params if cached else None, device="cpu")
            assert isinstance(cache["plans"],
                              encoder.PlanState if cached else tuple)
            logits = []
            for t in range(5):
                lg, _, cache = transformer.lm_apply(
                    params, cfg, torch.from_numpy(tok[:, t:t + 1]),
                    torch.from_numpy(pos[:, t:t + 1]), cache=cache)
                logits.append(lg[:, 0])
            runs[cached] = torch.stack(logits, 1).numpy()
    np.testing.assert_allclose(runs[True], runs[False], **LAYER_TOL)


def test_reset_slots_rewinds_only_masked_rows():
    """tests/test_scheduler.py's test on the port, jamba's cache (attention
    and SSM slots): the recycled row's SSM state and conv ring zeroed,
    the other rows and the KV rings bitwise untouched."""
    cfg = registry.get_smoke_config("jamba_1_5_large")
    cache = transformer.init_cache(cfg, 3, 8, per_slot=True, device="cpu")
    for blk in cache["blocks"].values():
        for leaf in blk.values():
            leaf.fill_(1)
    cache["pos"] = torch.tensor([5, 3, 7])
    before = {name: {k: v.clone() for k, v in blk.items()}
              for name, blk in cache["blocks"].items()}

    out = transformer.reset_slots(cache, np.array([False, True, False]))
    assert out["pos"].tolist() == [5, 0, 7]
    saw_state = False
    for name, blk in out["blocks"].items():
        for leaf in ("state", "conv"):
            if leaf in blk:
                saw_state = True
                assert (blk[leaf][:, 1] == 0).all()
                assert torch.equal(blk[leaf][:, [0, 2]],
                                   before[name][leaf][:, [0, 2]])
        for leaf in ("k", "v"):
            if leaf in blk:
                assert torch.equal(blk[leaf], before[name][leaf])
    assert saw_state


@pytest.mark.parametrize("admission", ["continuous", "lockstep"])
def test_engine_token_ids_match_jax(admission):
    """A continuous run recycles slots through ``reset_slots``: a
    recycled row's SSM state must start from zero, as JAX's does."""
    cfg, jcfg = _cfgs("mamba2_1_3b", "grouped")
    tree = interop.tree_to_numpy(
        transformer.lm_init(torch.Generator().manual_seed(1), cfg))
    reqs = synthetic_requests(4, 6, vocab=cfg.vocab, p_arrive=0.6,
                              prompt_len=(3, 6), gen_len=(2, 5))
    jreqs = [JRequest(rid=r.rid, prompt=r.prompt,
                      max_new_tokens=r.max_new_tokens, arrival=r.arrival)
             for r in reqs]
    want = JEngine(JSession(jcfg, jax.tree.map(jnp.asarray, tree)), 3, 12,
                   admission=admission).run(jreqs)
    got = Engine(ServeSession(cfg, interop.lm_params_from_numpy(tree)), 3,
                 12, admission=admission).run(reqs)
    assert got.steps == want.steps
    assert [r.tokens for r in got.records] == [r.tokens for r in want.records]
    assert [(r.admitted, r.slot) for r in got.records] == [
        (r.admitted, r.slot) for r in want.records]
    if admission == "continuous":
        assert len({r.slot for r in got.records}) < len(reqs)   # recycled


# ---------------------------------------------------------------------------
# The reference's SSD gradient fault (ROADMAP Queue 3), pinned
# ---------------------------------------------------------------------------

SSD_FAULT_SEQ = 8


def _loss_batch(cfg, s, seed=7):
    tok, pos = _tokens(cfg, s, seed=seed)
    return tok, pos, np.roll(tok, -1, axis=1)


def _jax_loss_grads(jcfg, jparams, tok, pos, tgt):
    jbatch = {"tokens": jnp.asarray(tok), "positions": jnp.asarray(pos),
              "targets": jnp.asarray(tgt)}
    (loss, _), grads = jax.value_and_grad(
        lambda p: jstep._loss_fn(p, jbatch, jcfg, tok.shape[1], False,
                                 ce_chunk=tok.shape[1]),
        has_aux=True)(jparams)
    return float(loss), grads


def _port_loss_grads(cfg, params, tok, pos, tgt):
    batch = {"tokens": torch.from_numpy(tok).long(),
             "positions": torch.from_numpy(pos).long(),
             "targets": torch.from_numpy(tgt).long()}
    loss, _, grads = step_lib.loss_and_grads(
        params, batch, cfg, q_chunk=tok.shape[1], ce_chunk=tok.shape[1])
    return float(loss), grads


def test_reference_ssd_gradient_fault_is_pinned(monkeypatch):
    """``repro.models.ssm._ssd_chunked`` takes ``where(causal, exp(seg),
    0)`` (src/repro/models/ssm.py:89): exp overflows above the diagonal
    and the backward multiplies a zero cotangent by inf. Its gradients
    are non-finite; the port's are finite and equal JAX's with the mask
    moved before the exp. If the reference is ever fixed, flip the first
    assertion."""
    cfg, jcfg, params, jparams = _build("mamba2_1_3b", None)
    tok, pos, tgt = _loss_batch(cfg, SSD_FAULT_SEQ)
    jloss, jgrads = _jax_loss_grads(jcfg, jparams, tok, pos, tgt)
    bad = [not np.isfinite(np.asarray(g)).all()
           for g in jax.tree.leaves(jgrads)]
    assert sum(bad) >= len(bad) // 2          # 9 of 10 leaves

    loss, grads = _port_loss_grads(cfg, params, tok, pos, tgt)
    got = interop.tree_to_numpy(grads)
    assert all(np.isfinite(g).all() for g in jax.tree.leaves(got))
    np.testing.assert_allclose(loss, jloss, **TOL)

    monkeypatch.setattr(jssm, "_ssd_chunked", masked_ssd_chunked)
    mloss, mgrads = _jax_loss_grads(jcfg, jparams, tok, pos, tgt)
    assert mloss == jloss                     # the same forward
    flat = jax.tree_util.tree_flatten_with_path(got)[0]
    want = jax.tree.leaves(mgrads)
    assert len(flat) == len(want)
    for (kp, a), b in zip(flat, want):
        np.testing.assert_allclose(a, np.asarray(b), **TOL,
                                   err_msg=jax.tree_util.keystr(kp))
