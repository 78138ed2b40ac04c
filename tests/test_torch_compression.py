"""The port's ``optim/compression.py`` against the JAX package's: the
top-k round trip and error-feedback cases of ``tests/test_perf_infra.py``
on the port, ``topk_compress`` equal to JAX's on seeded inputs, and
``compressed_allreduce`` on 2 gloo ranks equal to JAX's own under a
2-wide ``vmap`` axis (its ``pmean`` over the ranks)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite's workers share the host's cores
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import torch.distributed as dist  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.optim import (CompressionState, compressed_allreduce,  # noqa: E402
                               compression_init, topk_compress,
                               topk_decompress)


def test_topk_roundtrip_keeps_largest():
    g = torch.tensor([0.1, -5.0, 0.01, 3.0, -0.2, 0.0])
    vals, idx, k = topk_compress(g, ratio=0.34)     # k = 2
    assert k == 2 and idx.dtype == torch.int32
    dense = topk_decompress(vals, idx, g.shape)
    np.testing.assert_allclose(dense.numpy(), [0, -5.0, 0, 3.0, 0, 0],
                               atol=1e-6)


def test_error_feedback_accumulates_residual():
    """What is not sent this step is sent eventually: over T rounds the
    average transmitted gradient converges to the true gradient."""
    grads = {"w": torch.tensor([1.0, 0.5, 0.25, 0.125])}
    state = compression_init(grads)
    rounds = 64
    total_sent = torch.zeros(4)
    for _ in range(rounds):
        g32 = grads["w"] + state.error["w"]
        vals, idx, _ = topk_compress(g32, 0.25)   # k=1 per round
        sent = topk_decompress(vals, idx, (4,))
        state = CompressionState(error={"w": g32 - sent})
        total_sent = total_sent + sent
    avg = (total_sent / rounds).numpy()
    bound = float(state.error["w"].abs().max()) / rounds + 0.05
    np.testing.assert_allclose(avg, grads["w"].numpy(), atol=bound + 0.1)


def _distinct(rng, shape):
    """Values of distinct magnitudes, so top-k has no ties."""
    n = int(np.prod(shape))
    mags = rng.permutation(n).astype(np.float32) + 1.0
    signs = rng.choice([-1.0, 1.0], n).astype(np.float32)
    return (mags * signs / n).reshape(shape)


@pytest.mark.parametrize("shape,ratio", [((64,), 0.25), ((16, 12), 0.1),
                                         ((3, 5, 7), 0.5), ((9,), 0.01),
                                         ((128, 32), 1 / 3)])
def test_topk_compress_matches_jax(shape, ratio):
    g = _distinct(np.random.default_rng(len(shape) * 7 + shape[0]), shape)
    jv, ji, jk = jcomp.topk_compress(jnp.asarray(g), ratio)
    tv, ti, tk = topk_compress(torch.from_numpy(g), ratio)
    assert tk == jk
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(
        topk_decompress(tv, ti, shape).numpy(),
        np.asarray(jcomp.topk_decompress(jv, ji, shape)))
    st = compression_init({"g": torch.from_numpy(g)})
    assert st.error["g"].dtype == torch.float32 and not st.error["g"].any()


RANKS = 2
RATIO = 0.25
SHAPES = {"w": (16, 12), "b": (12,), "head": {"w": (12, 5)}}


def _tree(rng, shapes):
    return {k: _tree(rng, v) if isinstance(v, dict) else _distinct(rng, v)
            for k, v in shapes.items()}


def _inputs():
    """Each rank's gradient and residual trees (numpy)."""
    rng = np.random.default_rng(3)
    grads = [_tree(rng, SHAPES) for _ in range(RANKS)]
    # residuals from a continuous draw, so g + e has no ties either
    errors = [jax.tree.map(
        lambda x: (0.01 * rng.standard_normal(x.shape)).astype(np.float32),
        _tree(rng, SHAPES)) for _ in range(RANKS)]
    return grads, errors


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _rank_allreduce(grads, errors):
    r = dist.get_rank()
    out, st = compressed_allreduce(
        _to_torch(grads[r]), CompressionState(error=_to_torch(errors[r])),
        dist.group.WORLD, ratio=RATIO)
    return out, st.error


def test_compressed_allreduce_matches_jax_on_two_ranks(tmp_path):
    grads, errors = _inputs()
    stack = lambda trees: jax.tree.map(  # noqa: E731
        lambda *xs: jnp.stack(xs), *trees)
    want, wst = jax.vmap(
        lambda g, e: jcomp.compressed_allreduce(
            g, jcomp.CompressionState(error=e), "ranks", ratio=RATIO),
        axis_name="ranks")(stack(grads), stack(errors))
    got = mesh_lib.spawn(_rank_allreduce, RANKS, grads, errors,
                         backend="gloo", init_file=str(tmp_path / "rdv"),
                         timeout_s=90, torch_threads=1)
    for r, (out, err) in enumerate(got):
        for path, leaf in jax.tree_util.tree_leaves_with_path(want):
            keys = [p.key for p in path]
            o, e = out, err
            for k in keys:
                o, e = o[k], e[k]
            we = wst.error
            for k in keys:
                we = we[k]
            np.testing.assert_allclose(o, np.asarray(leaf)[r], rtol=0,
                                       atol=1e-7, err_msg=str(keys))
            np.testing.assert_array_equal(e, np.asarray(we)[r],
                                          err_msg=str(keys))


def test_compressed_allreduce_in_one_process_sends_its_top_k():
    """Without a group the mean over one process is its own scatter."""
    grads, errors = _inputs()
    out, st = compressed_allreduce(
        _to_torch(grads[0]), CompressionState(error=_to_torch(errors[0])),
        None, ratio=RATIO)
    want, wst = jax.vmap(
        lambda g, e: jcomp.compressed_allreduce(
            g, jcomp.CompressionState(error=e), "ranks", ratio=RATIO),
        axis_name="ranks")(jax.tree.map(lambda x: x[None], grads[0]),
                           jax.tree.map(lambda x: x[None], errors[0]))
    np.testing.assert_array_equal(out["w"].numpy(), np.asarray(want["w"])[0])
    np.testing.assert_array_equal(out["head"]["w"].numpy(),
                                  np.asarray(want["head"]["w"])[0])
    np.testing.assert_array_equal(st.error["b"].numpy(),
                                  np.asarray(wst.error["b"])[0])
