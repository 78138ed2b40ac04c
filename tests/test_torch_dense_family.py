"""The rest of the port's dense family against the JAX package: gemma2-27b,
internlm2-20b, gemma3-12b and paligemma-3b (prefix-LM) at their f32 smoke
configs with FLGW G=4 on the grouped path for mlp and attn. Configs field
by field, plans bitwise, prefill logits (chunked, past the local window,
banded), lockstep decode, paligemma's patch-prefix prefill and its loss
and gradients.

The same numpy weights (drawn from a seed) go to both packages through
``interop.lm_params_from_numpy``. JAX runs its kernels through their
plain reference (``use_reference_impl``), one of the two ways the JAX
package's own tests run them on the CPU; interpret-mode Pallas would
take minutes here.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import kernels as jkernels  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.core import encoder as jencoder  # noqa: E402
from repro.models import config as jconfig  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import grouped  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serving import ServeSession, plan_cache  # noqa: E402
from repro_torch.train import step as step_lib  # noqa: E402

ARCHS = ("gemma2_27b", "internlm2_20b", "gemma3_12b", "paligemma_3b")
FLGW = dict(flgw_groups=4, flgw_path="grouped", flgw_targets=("mlp", "attn"))
# f32 throughout; sums taken in other orders move logits by ~1e-6
TOL = dict(rtol=1e-4, atol=1e-4)
# past the smoke configs' local window (16) and long enough that a banded
# chunk of 8 queries (band 24) skips keys
SEQ, Q_CHUNK, BATCH = 40, 8, 2


@pytest.fixture(scope="module", autouse=True)
def _jax_reference_kernels():
    with jkernels.use_reference_impl():
        yield


@pytest.fixture(autouse=True)
def _fresh_plan_cache():
    plan_cache.clear()
    yield


@functools.lru_cache(maxsize=None)
def _build(arch):
    """(arch, jcfg, jparams, cfg, params, JAX PlanState, port PlanState):
    one weight draw from seed 0 in both packages."""
    jcfg = jregistry.get_smoke_config(arch, dtype=jnp.float32, **FLGW)
    cfg = registry.get_smoke_config(arch, dtype=torch.float32, **FLGW)
    tree = interop.tree_to_numpy(
        transformer.lm_init(torch.Generator().manual_seed(0), cfg))
    params = interop.lm_params_from_numpy(tree, device="cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    return (arch, jcfg, jparams, cfg, params,
            jtransformer.encode_plans(jparams, jcfg),
            transformer.encode_plans(params, cfg))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _build(request.param)


def _tokens(cfg, s=SEQ, seed=1):
    t = np.random.default_rng(seed).integers(0, cfg.vocab, (BATCH, s)
                                             ).astype(np.int32)
    pos = np.ascontiguousarray(np.broadcast_to(np.arange(s, dtype=np.int32),
                                               (BATCH, s)))
    return t, pos


def _patches(cfg, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (BATCH, cfg.prefix_len, cfg.d_model)).astype(np.float32)


def _port_prefill(m, *, banded=False, q_chunk=Q_CHUNK, patches=None,
                  flash=False):
    _, _, _, cfg, params, _, plans = m
    tok, pos = _tokens(cfg)
    kw = {} if patches is None else {"patch_embeds": torch.from_numpy(patches)}
    with torch.inference_mode():
        got, _, _ = transformer.lm_apply(
            params, cfg.with_updates(use_flash=flash), torch.from_numpy(tok),
            torch.from_numpy(pos), q_chunk=q_chunk, banded=banded,
            plans=plans, **kw)
    return got.numpy()


@functools.lru_cache(maxsize=None)
def _prefill(arch, banded=False):
    """(JAX logits, port logits) of one chunked prefill of both packages
    (paligemma's with its patch prefix)."""
    m = _build(arch)
    _, jcfg, jparams, cfg, _, jplans, _ = m
    tok, pos = _tokens(cfg)
    patches = _patches(cfg) if cfg.prefix_len else None
    jkw = {} if patches is None else {"patch_embeds": jnp.asarray(patches)}
    want, _, _ = jtransformer.lm_apply(
        jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos), remat=False,
        q_chunk=Q_CHUNK, banded=banded, plans=jplans, **jkw)
    return np.asarray(want), _port_prefill(m, banded=banded, patches=patches)


def _fields(cfg) -> dict:
    """A config's fields, dtype by name and slots as dicts, so the two
    packages' configs compare field by field."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name == "dtype":
            v = str(v).split(".")[-1].split("'")[0]
        elif f.name == "pattern":
            v = tuple(dataclasses.asdict(s) for s in v)
        out[f.name] = v
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_jax_field_by_field(arch):
    assert arch in registry.ARCH_IDS
    for get, jget in ((registry.get_config, jregistry.get_config),
                      (registry.get_smoke_config,
                       jregistry.get_smoke_config)):
        cfg, jcfg = get(arch), jget(arch)
        assert _fields(cfg) == _fields(jcfg)
        assert tconfig.param_count(cfg) == jconfig.param_count(jcfg)
    # the MoE family is held by tests/test_torch_moe.py, the SSM and
    # hybrid ones by tests/test_torch_ssm.py, the audio one by
    # tests/test_torch_whisper.py
    assert set(registry.ARCH_IDS) == {"gemma2_2b", *ARCHS, "mixtral_8x22b",
                                      "arctic_480b", "mamba2_1_3b",
                                      "jamba_1_5_large", "whisper_large_v3"}


def test_plans_are_bitwise_jax(model):
    _, _, _, cfg, params, jplans, plans = model
    assert int(plans.sig) == int(np.asarray(jplans.sig))
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
    assert n == 7 * cfg.period


def test_prefill_logits_match_jax(model):
    cfg = model[3]
    want, got = _prefill(model[0])
    assert got.shape == (BATCH, SEQ + cfg.prefix_len, cfg.vocab)
    np.testing.assert_allclose(got, want, **TOL)
    # one chunk: the unchunked plain core
    one = _port_prefill(model, q_chunk=512,
                        patches=_patches(cfg) if cfg.prefix_len else None)
    np.testing.assert_allclose(one, got, **TOL)


def test_banded_prefill_matches_jax_and_the_unbanded_one(model):
    cfg = model[3]
    want, got = _prefill(model[0], banded=True)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _prefill(model[0])[1], **TOL)
    if any(s.window for s in cfg.pattern):
        # the band (24 keys a chunk of 8) is narrower than the 40 keys
        window = max(s.window for s in cfg.pattern)
        assert min(SEQ, (-(-window // Q_CHUNK) + 1) * Q_CHUNK) < SEQ


def test_lockstep_decode_matches_jax(model):
    _, jcfg, jparams, cfg, params, jplans, _ = model
    steps = 18                              # the local ring (16) wraps
    tok, pos = _tokens(cfg, steps, seed=2)
    jcache = jtransformer.init_cache(jcfg, BATCH, steps)
    jcache["plans"] = jencoder.attach_compact(jplans, jparams)
    apply = jax.jit(lambda p, t, ps, c: jtransformer.lm_apply(
        p, jcfg, t, ps, cache=c, remat=False))
    cache = transformer.init_cache(cfg, BATCH, steps, params=params)
    assert grouped.has_compact(cache["plans"].plans)
    for t in range(steps):
        want, _, jcache = apply(jparams, jnp.asarray(tok[:, t:t + 1]),
                                jnp.asarray(pos[:, t:t + 1]), jcache)
        with torch.inference_mode():
            got, _, cache = transformer.lm_apply(
                params, cfg, torch.from_numpy(tok[:, t:t + 1]),
                torch.from_numpy(pos[:, t:t + 1]), cache=cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_patch_prefix_prefill_matches_jax_and_skips_flash():
    """paligemma's [patches; text] prefill: the prefix attends both ways;
    ``use_flash`` with a prefix takes the chunked core, as in JAX (the
    kernel's plain version on the CPU would move the logits)."""
    model = _build("paligemma_3b")
    _, jcfg, jparams, cfg, params, jplans, _ = model
    patches = _patches(cfg)
    want, got = _prefill("paligemma_3b")
    np.testing.assert_allclose(got, want, **TOL)
    flash = _port_prefill(model, patches=patches, flash=True)
    np.testing.assert_array_equal(flash, got)
    # the prefix is bidirectional: the first patch sees the last one
    moved = patches.copy()
    moved[:, -1] += 1.0
    got_moved = _port_prefill(model, patches=moved)
    assert not np.allclose(got_moved[:, 0], got[:, 0])
    # the serving prefill step reads batch["patch_embeds"]
    tok, pos = _tokens(cfg)
    batch = {"tokens": torch.from_numpy(tok), "positions":
             torch.from_numpy(pos), "patch_embeds": torch.from_numpy(patches)}
    last = ServeSession(cfg, params).prefill(batch)
    np.testing.assert_allclose(last.numpy(), want[:, -1:], **TOL)


def test_patch_prefix_loss_and_grads_match_jax():
    _, jcfg, jparams, cfg, params, jplans, plans = _build("paligemma_3b")
    tok, pos = _tokens(cfg)
    tgt = np.roll(tok, -1, axis=1)
    patches = _patches(cfg)
    jbatch = {"tokens": jnp.asarray(tok), "positions": jnp.asarray(pos),
              "targets": jnp.asarray(tgt), "patch_embeds": jnp.asarray(patches)}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jstep._loss_fn(p, jbatch, jcfg, Q_CHUNK, False,
                                 ce_chunk=16, plans=jplans),
        has_aux=True)(jparams)
    batch = {"tokens": torch.from_numpy(tok).long(),
             "positions": torch.from_numpy(pos).long(),
             "targets": torch.from_numpy(tgt).long(),
             "patch_embeds": torch.from_numpy(patches)}
    loss, _, grads = step_lib.loss_and_grads(params, batch, cfg,
                                             q_chunk=Q_CHUNK, ce_chunk=16,
                                             plans=plans)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    got = interop.tree_to_numpy(grads)
    flat = jax.tree_util.tree_flatten_with_path(got)[0]
    want = jax.tree.leaves(jgrads)
    assert len(flat) == len(want)
    for (kp, a), b in zip(flat, want):
        a, b = np.asarray(a), np.asarray(b)
        keep = np.ones(a.shape, bool)
        # the reference's STE uses the wrong group at item M-1 / N-1
        # (ROADMAP Queue 3)
        if kp[-1].key == "ig":
            keep[..., -1, :] = False
        elif kp[-1].key == "og":
            keep[..., :, -1] = False
        np.testing.assert_allclose(a[keep], b[keep], **TOL,
                                   err_msg=jax.tree_util.keystr(kp))


def test_banded_train_step_keeps_the_loss(model):
    """``make_train_step(banded=True)`` gives the unbanded step's loss and
    gradient norm (the band is exact)."""
    _, _, _, cfg, params, _, plans = model
    tok, pos = _tokens(cfg)
    batch = {"tokens": torch.from_numpy(tok).long(),
             "positions": torch.from_numpy(pos).long(),
             "targets": torch.from_numpy(np.roll(tok, -1, axis=1)).long()}
    if cfg.prefix_len:
        batch["patch_embeds"] = torch.from_numpy(_patches(cfg))
    out = [step_lib.loss_and_grads(params, batch, cfg, q_chunk=Q_CHUNK,
                                   banded=banded, plans=plans)
           for banded in (False, True)]
    np.testing.assert_allclose(float(out[1][0]), float(out[0][0]),
                               rtol=1e-6)
    for a, b in zip(*(jax.tree.leaves(interop.tree_to_numpy(g))
                      for _, _, g in out)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
