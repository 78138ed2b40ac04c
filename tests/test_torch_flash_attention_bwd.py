"""The port's flash-attention backward (its plain path ``ref_flash_bwd``,
the ``flash_bwd`` wrapper and the ``flash_attention`` autograd Function)
against the JAX package's Pallas ``flash_bwd`` in interpret mode and
``jax.vjp`` of its ``flash_attention``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

# f32 math on both sides, sums over at most 64 keys in another order
ATOL = 2e-5


def _case(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    return f(b, hq, s, d), f(b, hkv, s, d), f(b, hkv, s, d), f(b, hq, s, d)


@pytest.mark.parametrize("s", [64, 40])          # 40: not a tile multiple
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_ref_flash_bwd_matches_the_jax_kernels(s, window, softcap):
    q, k, v, do = _case(s + window, 2, 4, 2, s, 16)
    kw = dict(causal=True, window=window, softcap=softcap)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    out, lse = jflash.flash_fwd(jq, jk, jv, bq=8, bk=8, interpret=True, **kw)
    want = jflash.flash_bwd(jq, jk, jv, out, lse, jdo, bq=8, bk=8,
                            interpret=True, **kw)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    tout = torch.from_numpy(np.array(out))
    tlse = torch.from_numpy(np.array(lse))
    got = ops.flash_bwd(*t, tout, tlse, torch.from_numpy(do), **kw)
    assert all(torch.equal(a, b) for a, b in zip(
        got, ref.ref_flash_bwd(*t, tout, tlse, torch.from_numpy(do), **kw)))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("window,softcap", [(0, 50.0), (12, 0.0)])
def test_flash_attention_autograd_matches_jax_vjp(window, softcap):
    q, k, v, do = _case(window + 1, 1, 4, 2, 48, 16)

    def f(q, k, v):
        return jops.flash_attention(q, k, v, True, window, softcap, None, 16,
                                    16, True)
    out_j, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=True, window=window,
                              softcap=softcap)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=ATOL)
    out.backward(torch.from_numpy(do))
    for name, t, b in zip(("dq", "dk", "dv"), leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=ATOL, err_msg=name)


def test_flash_attention_grads_equal_the_dense_core_under_autograd():
    """The Function's grads against autograd through a plain softmax
    attention (f64), GQA, window and softcap on."""
    q, k, v, do = (torch.from_numpy(a).double()
                   for a in _case(9, 2, 4, 2, 21, 8))
    cap, window = 5.0, 6
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    ops.flash_attention(*leaves, window=window, softcap=cap).backward(do)

    dense = [a.clone().requires_grad_() for a in (q, k, v)]
    qg = dense[0].reshape(2, 2, 2, 21, 8)
    z = torch.einsum("bgqsd,bgtd->bgqst", qg, dense[1]) * 8 ** -0.5
    z = torch.tanh(z / cap) * cap
    z = torch.where(ref.allowed_mask(21, 21, causal=True, window=window), z,
                    -torch.inf)
    o = torch.einsum("bgqst,bgtd->bgqsd", torch.softmax(z, -1), dense[2])
    o.reshape(2, 4, 21, 8).backward(do)
    for a, b in zip(leaves, dense):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-5)


def test_flash_attention_under_inference_mode_is_the_forward():
    q, k, v, _ = (torch.from_numpy(a) for a in _case(2, 1, 2, 1, 8, 4))
    with torch.inference_mode():
        out = ops.flash_attention(q, k, v, window=3)
    assert torch.equal(out, ops.flash_fwd(q, k, v, window=3)[0])


def test_rows_with_no_allowed_key_get_zero_gradient():
    q, k, v, do = (torch.from_numpy(a) for a in _case(4, 1, 2, 2, 8, 4))
    kv = (k[:, :, :3].contiguous(), v[:, :, :3].contiguous())
    out, lse = ops.flash_fwd(q, *kv, causal=False, window=1)
    dq, dk, dv = ops.flash_bwd(q, *kv, out, lse, do, causal=False, window=1)
    assert torch.all(dq[:, :, 4:] == 0)
    assert torch.isfinite(dk).all() and torch.isfinite(dv).all()
