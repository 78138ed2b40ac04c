"""The port's plan encoder (plans and their uint32 signature) against the
JAX package."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

jnp = pytest.importorskip("jax.numpy")

from repro.core import encoder as jencoder  # noqa: E402
from repro.core.flgw import FLGWConfig as JFLGWConfig  # noqa: E402
from repro_torch.core import encoder, grouped  # noqa: E402
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
