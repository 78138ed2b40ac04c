"""The port's optimizers and gradient clip against the JAX package's, on
one random tree of float32 and bf16 leaves."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite's workers share the host's cores

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.optim import optimizers as opt  # noqa: E402

# the same float32 arithmetic term for term; 1e-6 leaves room for XLA's
# and ATen's elementwise kernels (sqrt, division)
RTOL = 1e-6


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (scale * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    return {"a": {"w": f(5, 7), "b": f(7)}, "c": f(3, 2, 4), "z": f(6)}


def _both(tree, bf16=()):
    """The tree as JAX arrays and as tensors; keys in ``bf16`` in bf16."""
    j, t = {}, {}
    for k, v in tree.items():
        if isinstance(v, dict):
            j[k], t[k] = _both(v, bf16)
        elif k in bf16:
            j[k] = jnp.asarray(v, jnp.bfloat16)
            t[k] = interop.tensor_from_numpy(np.asarray(j[k]))
        else:
            j[k], t[k] = jnp.asarray(v), torch.from_numpy(v.copy())
    return j, t


def _close(got, want):
    """Float32 leaves within RTOL; bf16 leaves within one bf16 rounding
    (2**-8), which an f32 difference in the last place can flip."""
    bf16 = [t.dtype == torch.bfloat16 for t in opt.tree_leaves(got)]
    got = jax.tree.leaves(interop.tree_to_numpy(got))
    want = [np.asarray(a, np.float32) for a in jax.tree.leaves(want)]
    assert len(got) == len(want) == len(bf16)
    for a, b, half in zip(got, want, bf16):
        np.testing.assert_allclose(a, b, rtol=2 ** -8 if half else RTOL)


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    jg, tg = _both(_tree(0), bf16=("c",))
    want, jnorm = jopt.clip_by_global_norm(jg, max_norm)
    got, norm = opt.clip_by_global_norm(tg, max_norm)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=RTOL)
    assert got["c"].dtype == torch.bfloat16
    _close(got, want)


def test_global_norm_matches_jax():
    jg, tg = _both(_tree(1))
    np.testing.assert_allclose(float(opt.global_norm(tg)),
                               float(jopt.global_norm(jg)), rtol=RTOL)


@pytest.mark.parametrize("bf16", [(), ("w",)])
def test_adamw_matches_jax_over_steps(bf16):
    jp, tp = _both(_tree(2), bf16)
    js, ts = jopt.adamw_init(jp), opt.adamw_init(tp)
    assert ts.count.dtype == torch.int32
    for step in range(3):
        jg, tg = _both(_tree(10 + step, scale=0.1), bf16)
        jp, js = jopt.adamw(jp, jg, js, lr=1e-2)
        tp, ts = opt.adamw(tp, tg, ts, lr=1e-2)
    assert int(ts.count) == 3
    _close(tp, jp)
    _close(ts.mu, js.mu)
    _close(ts.nu, js.nu)


def test_rmsprop_matches_jax_over_steps():
    jp, tp = _both(_tree(3))
    js, ts = jopt.rmsprop_init(jp), opt.rmsprop_init(tp)
    for step in range(3):
        jg, tg = _both(_tree(20 + step, scale=0.1))
        jp, js = jopt.rmsprop(jp, jg, js)
        tp, ts = opt.rmsprop(tp, tg, ts)
    _close(tp, jp)
    _close(ts, js)


def test_updates_write_into_the_given_tensors():
    _, tp = _both(_tree(4))
    state = opt.adamw_init(tp)
    w, mu = tp["a"]["w"], state.mu["a"]["w"]
    before = w.clone()
    _, tg = _both(_tree(5))
    new_p, new_s = opt.adamw(tp, tg, state)
    assert new_p["a"]["w"] is w and new_s.mu["a"]["w"] is mu
    assert not torch.equal(w, before) and state.count == 0 \
        and new_s.count == 1


def test_tree_leaves_follow_sorted_keys_as_jax():
    tree = {"z": torch.zeros(1), "a": {"y": torch.ones(1), "b": torch.ones(2)}}
    assert [t.numel() for t in opt.tree_leaves(tree)] == [2, 1, 1]


def test_rmsprop_state_converts_from_jax():
    from repro.train import state as jstate_lib
    jp, _ = _both(_tree(6), bf16=("w",))
    js = jstate_lib.TrainState(params=jp, opt=jopt.rmsprop_init(jp),
                               step=jnp.int32(2))
    state = interop.train_state_from_numpy(jax.tree.map(np.asarray, js))
    assert state.plans == () and int(state.step) == 2
    assert state.params["a"]["w"].dtype == torch.bfloat16
    assert state.opt["a"]["w"].dtype == torch.float32
    _close(state.params, jp)
