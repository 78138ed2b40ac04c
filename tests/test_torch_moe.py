"""The port's MoE family against the JAX package: mixtral-8x22b (``moe``
slots) and arctic-480b (``moe_dense``: the MoE beside a dense MLP
residual) at their f32 smoke configs.

Configs field by field; ``param_count`` and ``active_param_count`` for
every registered config; ``moe()`` on the dense, masked and grouped
paths (JAX's plans converted, per-call encode, compact weights
attached), dropless and capacity bounded with tokens dropped; the
batched compact products bitwise equal to a per-expert loop; the plans
of an MoE stack bitwise JAX's; ``lm_apply`` logits and aux; the serving
session's prefill and decode; the full forward against prefill +
decode; and training: the grouped MoE's loss and gradients (the
backward over the expert axis, bitwise a per-expert loop of the 2-D
one) and a masked one's match JAX's, and so do jamba-1.5-large's
grouped loss and gradients with the reference's SSD fault masked.

The same numpy weights (drawn from a seed) go to both packages through
``interop``. JAX runs its kernels through their plain reference
(``use_reference_impl``), as ``tests/test_torch_dense_family.py`` does.
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
from repro.core import encoder as jencoder  # noqa: E402
from repro.core.flgw import FLGWConfig as JFLGW  # noqa: E402
from repro.models import config as jconfig  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serving import ServeSession as JSession  # noqa: E402
from repro.serving import plan_cache as jplan_cache  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import encoder, grouped  # noqa: E402
from repro_torch.core.flgw import FLGWConfig  # noqa: E402
from repro_torch.kernels.flgw_matmul import ops as fm_ops  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import moe, transformer  # noqa: E402
from repro_torch.serving import ServeSession, plan_cache  # noqa: E402
from repro_torch.train import step as step_lib  # noqa: E402

ARCHS = ("mixtral_8x22b", "arctic_480b")
TARGETS = {"mixtral_8x22b": ("moe", "attn"),
           "arctic_480b": ("moe", "mlp", "attn"),
           "jamba_1_5_large": ("ssm", "moe", "mlp", "attn")}
# f32 throughout; sums taken in other orders move values by ~1e-7
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
AUX_TOL = dict(rtol=1e-6, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-4)
BATCH, SEQ = 2, 12
# moe() cases: the FFN path and, on the grouped path, where plans come
# from (JAX's converted, a per-call encode, compact weights attached)
PATHS = ("dense", "masked", "grouped_plans", "grouped_encode",
         "grouped_fused")


@pytest.fixture(scope="module", autouse=True)
def _jax_reference_kernels():
    with jkernels.use_reference_impl():
        yield


@pytest.fixture(autouse=True)
def _fresh_plan_caches():
    plan_cache.clear()
    jplan_cache.clear()
    yield


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


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_jax_field_by_field(arch):
    assert arch in registry.ARCH_IDS
    for get, jget in ((registry.get_config, jregistry.get_config),
                      (registry.get_smoke_config,
                       jregistry.get_smoke_config)):
        assert _fields(get(arch)) == _fields(jget(arch))


def _as_port_config(jcfg) -> tconfig.ModelConfig:
    """A JAX config as the port's, field for field (dtype aside)."""
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    kw["pattern"] = tuple(tconfig.SlotSpec(**dataclasses.asdict(s))
                          for s in jcfg.pattern)
    return tconfig.ModelConfig(**kw)


@pytest.mark.parametrize("arch", [
    a for a in jregistry.ARCH_IDS
    if isinstance(jregistry.get_config(a), jconfig.ModelConfig)])
def test_param_counts_equal_jax(arch):
    """Every LM config JAX registers (the ported ones through the port's
    registry, the others converted field for field)."""
    for jget, get in ((jregistry.get_config, registry.get_config),
                      (jregistry.get_smoke_config,
                       registry.get_smoke_config)):
        jcfg = jget(arch)
        cfg = get(arch) if arch in registry.ARCH_IDS else \
            _as_port_config(jcfg)
        assert tconfig.param_count(cfg) == jconfig.param_count(jcfg)
        assert tconfig.active_param_count(cfg) == \
            jconfig.active_param_count(jcfg)
    if arch in ARCHS:
        cfg = registry.get_config(arch)
        assert tconfig.active_param_count(cfg) < tconfig.param_count(cfg)


# ---------------------------------------------------------------------------
# moe()
# ---------------------------------------------------------------------------

def _moe_cfgs(arch, path):
    flgw_path = "dense" if path == "dense" else path.split("_")[0]
    kw = dict(flgw_groups=4, flgw_path=flgw_path, flgw_targets=("moe",))
    return (registry.get_smoke_config(arch, dtype=torch.float32, **kw),
            jregistry.get_smoke_config(arch, dtype=jnp.float32, **kw))


@functools.lru_cache(maxsize=None)
def _moe_params(arch, skew):
    """One moe layer's weights (numpy, from the port's init at seed 0)
    and its input; ``skew`` points every token at expert 0 first."""
    cfg, _ = _moe_cfgs(arch, "masked")
    tree = interop.tree_to_numpy(moe.moe_init(
        torch.Generator().manual_seed(0), cfg,
        flgw=FLGWConfig(groups=4, path="masked")))
    x = np.random.default_rng(1).standard_normal(
        (BATCH, SEQ, cfg.d_model)).astype(np.float32)
    if skew:
        x += 1.0
        tree["router"][:, 0] += 0.5
    return tree, x


def _dropped(cfg, router, x) -> int:
    """(token, slot) assignments past their expert's capacity."""
    t = x.shape[0] * x.shape[1]
    probs = torch.softmax(torch.from_numpy(x).reshape(t, -1)
                          @ torch.from_numpy(router), -1)
    top = torch.sort(probs, dim=-1, descending=True,
                     stable=True)[1][:, :cfg.top_k]
    load = torch.bincount(top.reshape(-1), minlength=cfg.n_experts)
    return int((load - moe.capacity(t, cfg, False)).clamp(min=0).sum())


# (dropless, skew): a router skewed toward expert 0 drops tokens when
# the dispatch is capacity bounded
@pytest.mark.parametrize("dropless,skew", [(True, False), (False, False),
                                           (False, True)])
@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_jax(arch, path, dropless, skew):
    cfg, jcfg = _moe_cfgs(arch, path)
    tree, x = _moe_params(arch, skew)
    params = interop.lm_params_from_numpy(tree)
    jparams = jax.tree.map(jnp.asarray, tree)
    fl = FLGWConfig(groups=4, path=cfg.flgw_path)
    jfl = JFLGW(groups=4, path=cfg.flgw_path)
    plans = jplans = None
    if path in ("grouped_plans", "grouped_fused"):
        jplans = jencoder.encode_plans(jparams, jfl).plans
        if path == "grouped_fused":
            jplans = jencoder.attach_compact(
                jencoder.PlanState(jplans, jnp.zeros((), jnp.uint32)),
                jparams).plans
        plans = interop.plans_from_numpy(jax.tree.map(np.asarray, jplans))
    want, jaux = jmoe.moe(jparams, jnp.asarray(x), jcfg, flgw=jfl,
                          dropless=dropless, plans=jplans)
    with torch.inference_mode():
        got, aux = moe.moe(params, torch.from_numpy(x), cfg, flgw=fl,
                           dropless=dropless, plans=plans)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **AUX_TOL)
    if skew:
        assert _dropped(cfg, tree["router"], x) > 0


def test_capacity_rounds_as_python():
    cfg = registry.get_smoke_config("mixtral_8x22b")      # E 4, k 2, 1.25
    assert moe.capacity(12, cfg, False) == round(12 * 2 / 4 * 1.25) == 8
    assert moe.capacity(4, cfg, False) == 2      # round(2.5) is 2 (even)
    assert moe.capacity(1, cfg, False) == 1      # capped at t
    assert moe.capacity(12, cfg, True) == 24


def test_top_k_keeps_the_lower_expert_on_ties():
    cfg = registry.get_smoke_config("mixtral_8x22b", dtype=torch.float32)
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    p["router"] = torch.zeros_like(p["router"])             # all tied
    x = torch.randn(1, 3, cfg.d_model)
    out, aux = moe.moe(p, x, cfg, dropless=True)
    jp = jax.tree.map(jnp.asarray, interop.tree_to_numpy(p))
    jcfg = jregistry.get_smoke_config("mixtral_8x22b", dtype=jnp.float32)
    want, jaux = jmoe.moe(jp, jnp.asarray(x.numpy()), jcfg, dropless=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **AUX_TOL)


# ---------------------------------------------------------------------------
# The batched compact products
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e,c,m,n,g", [(4, 24, 64, 128, 4), (8, 5, 96, 64, 4),
                                       (3, 1, 40, 24, 2)])
def test_batched_products_equal_a_per_expert_loop(e, c, m, n, g,
                                                  monkeypatch):
    gen = torch.Generator().manual_seed(e * 100 + c)
    x = torch.randn((e, c, m), generator=gen)
    w = torch.randn((e, m, n), generator=gen)
    ig = torch.randn((e, m, g), generator=gen)
    og = torch.randn((e, g, n), generator=gen)
    plan = grouped.make_plan(ig, og, 1.25)
    wc = fm_ops.compact_weights(w, plan.row_ids, plan.col_ids,
                                plan.row_valid, plan.col_valid)
    gather = fm_ops.grouped_matmul(x, w, plan.row_ids, plan.col_ids,
                                   plan.row_valid, plan.col_valid)
    fused = fm_ops.grouped_matmul_fused(x, wc, plan.row_ids, plan.row_valid,
                                        plan.col_ids, plan.col_valid, n=n)
    assert gather.shape == fused.shape == (e, c, n)
    # compact_weights gathering one expert at a time gives the same bits
    monkeypatch.setattr(fm_ops, "_INDEX_BYTES", 1)
    assert torch.equal(wc, fm_ops.compact_weights(
        w, plan.row_ids, plan.col_ids, plan.row_valid, plan.col_valid))
    for i in range(e):
        one = grouped.GroupPlan(*(t[i] for t in plan[:6]))
        assert torch.equal(gather[i], fm_ops.grouped_matmul(
            x[i], w[i], one.row_ids, one.col_ids, one.row_valid,
            one.col_valid))
        assert torch.equal(wc[i], fm_ops.compact_weights(
            w[i], one.row_ids, one.col_ids, one.row_valid, one.col_valid))
        assert torch.equal(fused[i], fm_ops.grouped_matmul_fused(
            x[i], wc[i], one.row_ids, one.row_valid, one.col_ids,
            one.col_valid, n=n))


# ---------------------------------------------------------------------------
# The MoE stack
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _build(arch, path="grouped"):
    """(jcfg, jparams, cfg, params, JAX PlanState, port PlanState): one
    weight draw from seed 0 in both packages."""
    kw = dict(flgw_groups=4, flgw_path=path, flgw_targets=TARGETS[arch])
    jcfg = jregistry.get_smoke_config(arch, dtype=jnp.float32, **kw)
    cfg = registry.get_smoke_config(arch, dtype=torch.float32, **kw)
    tree = interop.tree_to_numpy(
        transformer.lm_init(torch.Generator().manual_seed(0), cfg))
    params = interop.lm_params_from_numpy(tree, device="cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    return (jcfg, jparams, cfg, params,
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


def test_moe_stack_plans_are_bitwise_jax(model):
    _, _, cfg, params, jplans, plans = model
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
        if "moe" in path:
            assert b.row_ids.shape[:2] == (cfg.n_blocks, cfg.n_experts)
        n += 1
    assert n == (7 if cfg.pattern[0].ffn == "moe" else 10) * cfg.period


@pytest.mark.parametrize("dropless", [False, True])
def test_lm_apply_logits_and_aux_match_jax(model, dropless):
    jcfg, jparams, cfg, params, jplans, plans = model
    tok, pos = _tokens(cfg)
    want, jaux, _ = jtransformer.lm_apply(
        jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos), remat=False,
        moe_dropless=dropless, plans=jplans)
    with torch.inference_mode():
        got, aux, _ = transformer.lm_apply(
            params, cfg, torch.from_numpy(tok), torch.from_numpy(pos),
            moe_dropless=dropless, plans=plans)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    assert float(aux) > 0


def test_serve_session_prefill_and_decode_match_jax(model):
    jcfg, jparams, cfg, params, _, _ = model
    tok, pos = _tokens(cfg, seed=2)
    want = JSession(jcfg, jparams).prefill(
        {"tokens": jnp.asarray(tok), "positions": jnp.asarray(pos)})
    sess = ServeSession(cfg, params)
    got = sess.prefill({"tokens": torch.from_numpy(tok),
                        "positions": torch.from_numpy(pos)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # lockstep greedy decode, each session fed its own tokens
    jsess = JSession(jcfg, jparams)
    jcache, cache = jsess.new_cache(BATCH, SEQ), sess.new_cache(BATCH, SEQ)
    assert grouped.has_compact(cache["plans"].plans)
    jnxt = jnp.asarray(tok[:, :1])
    nxt = torch.from_numpy(tok[:, :1])
    for t in range(SEQ - 4):
        jnxt, jcache = jsess.decode(jcache, jnxt, jnp.full((BATCH, 1), t))
        nxt, cache = sess.decode(cache, nxt, sess.greedy_positions(BATCH, t))
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))


def test_full_forward_matches_prefill_then_decode(model):
    """The port's counterpart of ``tests/test_decode_parity.py``'s MoE
    case: a dropless full forward against token-by-token decode through
    the KV cache and its plans (the fused path)."""
    _, _, cfg, params, _, plans = model
    tok, pos = _tokens(cfg, seed=3)
    with torch.inference_mode():
        full, _, _ = transformer.lm_apply(
            params, cfg, torch.from_numpy(tok), torch.from_numpy(pos),
            moe_dropless=True, plans=plans)
        cache = transformer.init_cache(cfg, BATCH, SEQ, params=params)
        steps = []
        for t in range(SEQ):
            lg, _, cache = transformer.lm_apply(
                params, cfg, torch.from_numpy(tok[:, t:t + 1]),
                torch.from_numpy(pos[:, t:t + 1]), cache=cache)
            steps.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(),
                               **TOL)


def _loss_batch(cfg):
    tok, pos = _tokens(cfg, seed=4)
    tgt = np.roll(tok, -1, axis=1)
    return tok, pos, tgt


def _ste_fault_mask(params):
    """{path: (bool mask of ig, bool mask of og)}: True at ig[..., M-1, :]
    and og[..., :, N-1] of every FLGW layer (each expert's), the entries
    whose gradient the reference's ``make_plan`` fault (ROADMAP Queue 3)
    moves."""
    out = {}
    for path, p in grouped.iter_flgw_layers(params):
        ig = np.zeros(p["ig"].shape, bool)
        og = np.zeros(p["og"].shape, bool)
        ig[..., -1, :] = True
        og[..., :, -1] = True
        out[path] = (ig, og)
    return out


def _compare_grads(grads, jgrads, params, tol):
    """Every gradient leaf within ``tol``, the STE entries of the
    reference fault excluded; returns how many FLGW ig/og leaves moved."""
    fault = _ste_fault_mask(params)
    flat = jax.tree_util.tree_flatten_with_path(
        interop.tree_to_numpy(grads))[0]
    want = jax.tree.leaves(jgrads)
    assert len(flat) == len(want)
    moved = 0
    for (kp, a), b in zip(flat, want):
        path = tuple(k.key for k in kp)
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert np.isfinite(a).all() and np.isfinite(b).all(), path
        keep = np.ones(a.shape, bool)
        if path[:-1] in fault and path[-1] in ("ig", "og"):
            keep = ~fault[path[:-1]][0 if path[-1] == "ig" else 1]
            moved += bool(np.abs(a[keep]).max() > 0)
        np.testing.assert_allclose(a[keep], b[keep], **tol,
                                   err_msg="/".join(path))
    return moved


@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_moe_loss_and_grads_match_jax(arch):
    """The grouped MoE trains: the expert-axis backward (every expert's
    dx, dW, dIG and dOG at once) against JAX's vmap of its backward over
    the experts, each package on its own plans."""
    jcfg, jparams, cfg, params, jplans, plans = _build(arch)
    tok, pos, tgt = _loss_batch(cfg)
    jbatch = {"tokens": jnp.asarray(tok), "positions": jnp.asarray(pos),
              "targets": jnp.asarray(tgt)}
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jstep._loss_fn(p, jbatch, jcfg, SEQ, False, ce_chunk=16,
                                 plans=jplans), has_aux=True)(jparams)
    batch = {"tokens": torch.from_numpy(tok).long(),
             "positions": torch.from_numpy(pos).long(),
             "targets": torch.from_numpy(tgt).long()}
    loss, metrics, grads = step_lib.loss_and_grads(
        params, batch, cfg, q_chunk=SEQ, ce_chunk=16, plans=plans)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    np.testing.assert_allclose(float(metrics["aux"]),
                               float(jmetrics["aux"]), **TOL)
    # every FLGW layer's ig and og get gradients: the experts' up, gate,
    # down and attention's q, k, v, o (and arctic's residual MLP)
    assert _compare_grads(grads, jgrads, params, TOL) == 2 * (
        7 if cfg.pattern[0].ffn == "moe" else 10)


@pytest.mark.parametrize("e,c,m,n,g", [(4, 24, 64, 128, 4), (8, 5, 96, 64, 4),
                                       (3, 1, 40, 24, 2)])
def test_expert_axis_backward_equals_a_per_expert_loop(e, c, m, n, g,
                                                       monkeypatch):
    """The backward over a leading expert axis is bitwise the 2-D
    backward run expert by expert: through ``_grouped_bwd`` on a bare
    plan and on attached compact weights, with dW's flat offsets built a
    tile at a time, and through ``grouped_apply`` under autograd."""
    gen = torch.Generator().manual_seed(e * 100 + c)
    x = torch.randn((e, c, m), generator=gen)
    w = torch.randn((e, m, n), generator=gen)
    ig = torch.randn((e, m, g), generator=gen)
    og = torch.randn((e, g, n), generator=gen)
    gy = torch.randn((e, c, n), generator=gen)
    plan = grouped.make_plan(ig, og, 1.25)
    fused = plan._replace(wc=fm_ops.compact_weights(
        w, plan.row_ids, plan.col_ids, plan.row_valid, plan.col_valid))
    got = grouped._grouped_bwd(x, w, ig, og, plan, 1.0, gy)
    assert torch.equal(got[1], grouped._grouped_bwd(
        x, w, ig, og, fused, 1.0, gy)[1])
    leaves = [t.requires_grad_() for t in (x.clone(), w.clone(), ig.clone(),
                                           og.clone())]
    fl = FLGWConfig(groups=g, path="grouped")
    y = grouped.grouped_apply(*leaves, fl, plan=plan)
    y.backward(gy)
    monkeypatch.setattr(fm_ops, "_INDEX_BYTES", 1)
    assert all(torch.equal(a, b) for a, b in zip(
        got, grouped._grouped_bwd(x, w, ig, og, plan, 1.0, gy)))
    for i in range(e):
        one = grouped.GroupPlan(*(t[i] for t in plan[:6]))
        want = grouped._grouped_bwd(x[i], w[i], ig[i], og[i], one, 1.0,
                                    gy[i])
        for a, b, t in zip(got, want, leaves):
            assert a[i].shape == b.shape
            assert torch.equal(a[i], b)
            assert torch.equal(t.grad[i], b)


@pytest.mark.parametrize("arch", ARCHS)
def test_masked_moe_loss_and_grads_match_jax(arch):
    jcfg, jparams, cfg, params, _, _ = _build(arch, "masked")
    tok, pos, tgt = _loss_batch(cfg)
    jbatch = {"tokens": jnp.asarray(tok), "positions": jnp.asarray(pos),
              "targets": jnp.asarray(tgt)}
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jstep._loss_fn(p, jbatch, jcfg, SEQ, False, ce_chunk=16),
        has_aux=True)(jparams)
    batch = {"tokens": torch.from_numpy(tok).long(),
             "positions": torch.from_numpy(pos).long(),
             "targets": torch.from_numpy(tgt).long()}
    loss, metrics, grads = step_lib.loss_and_grads(params, batch, cfg,
                                                   q_chunk=SEQ, ce_chunk=16)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    np.testing.assert_allclose(float(metrics["aux"]),
                               float(jmetrics["aux"]), **TOL)
    got = interop.tree_to_numpy(grads)
    flat = jax.tree_util.tree_flatten_with_path(got)[0]
    want = jax.tree.leaves(jgrads)
    assert len(flat) == len(want)
    moved = 0
    for (kp, a), b in zip(flat, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL,
                                   err_msg=jax.tree_util.keystr(kp))
        if "moe" in jax.tree_util.keystr(kp):
            moved += bool(np.abs(np.asarray(a)).max() > 0)
    assert moved >= 4        # router and the experts' w, ig, og get gradients


JAMBA_SEQ = 16


def test_jamba_grouped_loss_and_grads_match_jax(monkeypatch):
    """jamba-1.5-large's smoke config, G=4 grouped on its SSM, MoE, MLP
    and attention projections: the port's loss and gradients against
    JAX's with the reference's SSD fault masked (JAX's own are NaN;
    tests/test_torch_ssm.py pins it)."""
    from test_torch_ssm import masked_ssd_chunked
    from repro.models import ssm as jssm
    monkeypatch.setattr(jssm, "_ssd_chunked", masked_ssd_chunked)
    jcfg, jparams, cfg, params, jplans, plans = _build("jamba_1_5_large")
    tok, pos = _tokens(cfg, s=JAMBA_SEQ, seed=4)
    tgt = np.roll(tok, -1, axis=1)
    jbatch = {"tokens": jnp.asarray(tok), "positions": jnp.asarray(pos),
              "targets": jnp.asarray(tgt)}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jstep._loss_fn(p, jbatch, jcfg, JAMBA_SEQ, False,
                                 ce_chunk=16, plans=jplans),
        has_aux=True)(jparams)
    batch = {"tokens": torch.from_numpy(tok).long(),
             "positions": torch.from_numpy(pos).long(),
             "targets": torch.from_numpy(tgt).long()}
    loss, _, grads = step_lib.loss_and_grads(
        params, batch, cfg, q_chunk=JAMBA_SEQ, ce_chunk=16, plans=plans)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    # every FLGW layer's ig and og move: 42 projections (ssm in/out,
    # the experts', the MLPs', attention's)
    assert _compare_grads(grads, jgrads, params, TOL) == 2 * 42
