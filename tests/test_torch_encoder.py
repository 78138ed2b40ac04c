"""The port's plan encoder (plans, their uint32 signature and the
training refresh policies) against the JAX package."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite's workers share the host's cores

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.core import encoder as jencoder  # noqa: E402
from repro.core import schedule as jschedule  # noqa: E402
from repro.core.flgw import FLGWConfig as JFLGWConfig  # noqa: E402
from repro_torch.core import encoder, grouped, schedule  # noqa: E402
from repro_torch.core.flgw import FLGWConfig  # noqa: E402


def _tree(seed, g, nested=True):
    """An IC3Net-shaped param tree (hidden 32) with FLGW layers, one of
    them nested, plus dense leaves the walk must skip."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    layer = lambda m, n: {"w": f(m, n), "ig": f(m, g), "og": f(g, n)}  # noqa
    tree = {"enc": layer(18, 32), "lstm_x": layer(32, 128),
            "policy": layer(32, 5), "lstm_b": f(128), "value": {"w": f(32, 1)}}
    if nested:
        tree["block"] = {"comm": layer(32, 32)}
    return tree


def _conv(tree, fn):
    return {k: _conv(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("g", [2, 4])
def test_plan_signature_is_bitwise_the_reference(g):
    tree = _tree(g, g)
    want = int(np.asarray(jencoder.plan_signature(_conv(tree, jnp.asarray))))
    got = encoder.plan_signature(_conv(tree, torch.from_numpy))
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == want


def test_signature_moves_with_a_single_rank_change():
    tree = _conv(_tree(3, 4, nested=False), torch.from_numpy)
    base = int(encoder.plan_signature(tree))
    ig = tree["enc"]["ig"]
    pref, rank = encoder._layout_ranks(ig)
    i = int((rank > 0).nonzero()[0])  # an item that is not its group's first
    ig[i, pref[i]] += 10.0            # now first: same argmax, new order
    assert int(encoder.plan_signature(tree)) != base


def test_layout_ranks_match_reference():
    s = np.random.default_rng(9).standard_normal((3, 40, 4)).astype(np.float32)
    jp, jr = jencoder._layout_ranks(jnp.asarray(s))
    tp, tr = encoder._layout_ranks(torch.from_numpy(s))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_encode_plans_mirrors_the_tree_and_matches_reference():
    tree = _tree(5, 2)
    js = jencoder.encode_plans(_conv(tree, jnp.asarray), JFLGWConfig(
        groups=2, path="grouped"))
    ts = encoder.encode_plans(_conv(tree, torch.from_numpy), FLGWConfig(
        groups=2, path="grouped"))
    assert bool(ts) and int(ts.sig) == int(np.asarray(js.sig))
    paths = [p for p, _ in grouped.iter_flgw_layers(tree)]
    assert paths == [("block", "comm"), ("enc",), ("lstm_x",), ("policy",)]
    for path in paths:
        jp, tp = js.plans, ts.plans
        for name in path:
            jp, tp = jp[name], tp[name]
        for f in ("row_ids", "col_ids", "row_valid", "col_valid"):
            np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                          np.asarray(getattr(jp, f)))
    empty = encoder.empty_state()
    assert not empty and int(empty.sig) == 0


@pytest.mark.parametrize("mode,every", [("period", 1), ("period", 3),
                                        ("on_change", 1), ("hybrid", 2)])
def test_maybe_refresh_matches_jax(mode, every):
    rng = np.random.default_rng(every)
    p = {"l": {"w": rng.standard_normal((24, 16)).astype(np.float32),
               "ig": rng.standard_normal((24, 4)).astype(np.float32),
               "og": rng.standard_normal((4, 16)).astype(np.float32)}}
    moved = {"l": dict(p["l"], ig=p["l"]["ig"].copy())}
    moved["l"]["ig"][3] = -moved["l"]["ig"][3]           # argmax flips
    jsched = jschedule.SparsitySchedule(groups=4, refresh_every=every,
                                        refresh=mode)
    tsched = schedule.SparsitySchedule(groups=4, refresh_every=every,
                                       refresh=mode)
    jcfg = JFLGWConfig(groups=4, path="grouped")
    tcfg = FLGWConfig(groups=4, path="grouped")

    def jtree(t):
        return jax.tree.map(jnp.asarray, t)

    def ttree(t):
        return jax.tree.map(torch.from_numpy, t)
    jst = jencoder.encode_plans(jtree(p), jcfg)
    tst = encoder.encode_plans(ttree(p), tcfg)
    jrefresh = jax.jit(jencoder.maybe_refresh, static_argnums=(3, 4))
    for it in range(4):
        for params in (p, moved):
            jnew = jrefresh(jtree(params), jst, it, jcfg, jsched)
            tnew = encoder.maybe_refresh(ttree(params), tst, it, tcfg, tsched)
            assert int(tnew.sig) == int(jnew.sig)
            # bitwise but for the reference's group of the last item
            # (ROADMAP Queue 3)
            for a, b in zip(tnew.plans["l"][:6], jnew.plans["l"][:6]):
                a = a.numpy()
                b = np.asarray(b).astype(a.dtype)
                if a.ndim == 1:
                    a, b = a[:-1], b[:-1]
                np.testing.assert_array_equal(a, b)
    with pytest.raises(TypeError, match="PlanState"):
        encoder.maybe_refresh(ttree(p), {}, 0, tcfg)


def test_schedule_is_the_jax_schedule():
    for kw in (dict(groups=4, refresh_every=3, warmup_steps=2),
               dict(groups=2, refresh="on_change")):
        j, t = jschedule.SparsitySchedule(**kw), schedule.SparsitySchedule(**kw)
        assert [t.groups_at(s) for s in range(5)] == \
            [j.groups_at(s) for s in range(5)]
        assert [t.refresh_at(s) for s in range(5)] == \
            [j.refresh_at(s) for s in range(5)]
        assert t.avg_sparsity == j.avg_sparsity
    with pytest.raises(ValueError, match="refresh must be one of"):
        schedule.SparsitySchedule(refresh="sometimes")
