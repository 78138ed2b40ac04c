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


@pytest.mark.parametrize("scale,window,softcap", [
    (0.5, 0, 50.0), (0.1, 12, 0.0), (1.3, 0, 5.0)])
def test_scale_matches_the_jax_kernels(scale, window, softcap):
    """A logits scale other than D ** -0.5: the port's flash_fwd,
    flash_bwd and the flash_attention autograd Function against the JAX
    kernels in interpret mode and the VJP of its flash_attention."""
    q, k, v, do = _case(int(scale * 10) + window, 1, 4, 2, 40, 16)
    kw = dict(causal=True, window=window, softcap=softcap, scale=scale)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    out_j, lse_j = jflash.flash_fwd(jq, jk, jv, bq=8, bk=8, interpret=True,
                                    **kw)
    want = jflash.flash_bwd(jq, jk, jv, out_j, lse_j, jdo, bq=8, bk=8,
                            interpret=True, **kw)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out, lse = ops.flash_fwd(*t, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=1e-5,
                               atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), rtol=1e-5,
                               atol=ATOL)
    got = ops.flash_bwd(*t, out, lse, torch.from_numpy(do), **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=ATOL, err_msg=name)

    def f(q, k, v):
        return jops.flash_attention(q, k, v, True, window, softcap, scale, 8,
                                    8, True)
    _, vjp = jax.vjp(f, jq, jk, jv)
    leaves = [a.clone().requires_grad_() for a in t]
    ops.flash_attention(*leaves, **kw).backward(torch.from_numpy(do))
    for name, a, b in zip(("dq", "dk", "dv"), leaves, vjp(jdo)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=1e-5,
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


def _emulate_tc_dkv(q, k, v, out, lse, do, *, causal, window, softcap):
    """The card's bf16 dk, dv pass (flash_bwd_dkv_mma_kernel) in plain
    PyTorch: S^T and dP^T from bf16 operands with f32 sums, p and dz in
    f32 from lse and delta, each entering P^T.dO and dZ^T.Q as a bf16
    pair (the rounded value and its rounding residue) with f32 sums, dk
    and dv rounded once to bf16."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hkv, hq // hkv, s, d)
    dog = do.float().reshape(b, hkv, hq // hkv, s, d)
    z = torch.einsum("bgqsd,bgtd->bgqst", qg, k.float()) * d ** -0.5
    dcap = torch.ones_like(z)
    if softcap > 0:
        th = torch.tanh(z * (1.0 / softcap))
        z, dcap = th * softcap, 1.0 - th * th
    allowed = ref.allowed_mask(s, t, causal=causal, window=window)
    lse_g = lse.reshape(b, hkv, hq // hkv, s, 1)
    p = torch.where(allowed, torch.exp(z - lse_g), 0.0)
    delta = ref.delta_of(out, do).reshape(b, hkv, hq // hkv, s, 1)
    dp = torch.einsum("bgqsd,bgtd->bgqst", dog, v.float())
    dz = p * (dp - delta) * dcap
    dk, dv = (sum(torch.einsum("bgqst,bgqsd->bgtd", part, x)
                  for part in _bf16_pair(a)) for a, x in ((dz, qg), (p, dog)))
    return (dk * d ** -0.5).bfloat16(), dv.bfloat16()


def _emulate_tc_dq(q, k, v, out, lse, do, *, causal, window, softcap):
    """The card's bf16 dq pass (flash_bwd_dq_mma_kernel) in plain
    PyTorch: S and dP from bf16 operands with f32 sums, p and dz in f32
    from lse and delta, dz rounded once to bf16 as dZ.K's operand with
    f32 sums, dq scaled and rounded once to bf16."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hkv, hq // hkv, s, d)
    dog = do.float().reshape(b, hkv, hq // hkv, s, d)
    z = torch.einsum("bgqsd,bgtd->bgqst", qg, k.float()) * d ** -0.5
    dcap = torch.ones_like(z)
    if softcap > 0:
        th = torch.tanh(z * (1.0 / softcap))
        z, dcap = th * softcap, 1.0 - th * th
    allowed = ref.allowed_mask(s, t, causal=causal, window=window)
    lse_g = lse.reshape(b, hkv, hq // hkv, s, 1)
    p = torch.where(allowed, torch.exp(z - lse_g), 0.0)
    delta = ref.delta_of(out, do).reshape(b, hkv, hq // hkv, s, 1)
    dp = torch.einsum("bgqsd,bgtd->bgqst", dog, v.float())
    dz = p * (dp - delta) * dcap
    dq = torch.einsum("bgqst,bgtd->bgqsd", dz.bfloat16().float(), k.float())
    return (dq * d ** -0.5).reshape(b, hq, s, d).bfloat16()


def _bf16_pair(x):
    """x as the kernel's two bf16 operands: rounded, and the residue
    rounded (f32 values)."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


@pytest.mark.parametrize("hkv,s,window,softcap", [
    (4, 256, 0, 50.0), (4, 256, 100, 0.0),
    (2, 300, 100, 50.0)])                        # qpk 4, S ragged for 64
def test_tensor_core_rounding_fits_the_card_tolerance(hkv, s, window,
                                                      softcap):
    """The card's bf16 dk, dv design, emulated at the model's head dim on
    the forward's bf16 out and lse, against the JAX kernels on the same
    bf16 values in f32 math: within the card tests' bf16 tolerance."""
    q, k, v, do = (torch.from_numpy(a).bfloat16()
                   for a in _case(8, 1, 8, hkv, s, 256))
    kw = dict(causal=True, window=window, softcap=softcap)
    jq, jk, jv, jdo = (jnp.asarray(x.float().numpy()) for x in (q, k, v, do))
    blk = dict(bq=s // 2, bk=s // 2, interpret=True)
    out, lse = jflash.flash_fwd(jq, jk, jv, **blk, **kw)
    _, want_dk, want_dv = jflash.flash_bwd(jq, jk, jv, out, lse, jdo, **blk,
                                           **kw)
    got_dk, got_dv = _emulate_tc_dkv(
        q, k, v, torch.from_numpy(np.array(out)).bfloat16(),
        torch.from_numpy(np.array(lse)), do, **kw)
    for name, got, want in (("dk", got_dk, want_dk), ("dv", got_dv, want_dv)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                                   rtol=1e-2, atol=1e-2, err_msg=name)


@pytest.mark.parametrize("hkv,s,window,softcap", [
    (4, 256, 0, 50.0), (4, 256, 100, 0.0),
    (2, 300, 100, 50.0)])                        # qpk 4, S ragged for 64
def test_tensor_core_dq_rounding_fits_the_card_tolerance(hkv, s, window,
                                                         softcap):
    """The card's bf16 dq design, emulated at the model's head dim on the
    forward's bf16 out and lse, against the JAX kernels on the same bf16
    values in f32 math: within the card tests' bf16 tolerance."""
    q, k, v, do = (torch.from_numpy(a).bfloat16()
                   for a in _case(8, 1, 8, hkv, s, 256))
    kw = dict(causal=True, window=window, softcap=softcap)
    jq, jk, jv, jdo = (jnp.asarray(x.float().numpy()) for x in (q, k, v, do))
    blk = dict(bq=s // 2, bk=s // 2, interpret=True)
    out, lse = jflash.flash_fwd(jq, jk, jv, **blk, **kw)
    want_dq = jflash.flash_bwd(jq, jk, jv, out, lse, jdo, **blk, **kw)[0]
    got_dq = _emulate_tc_dq(q, k, v,
                            torch.from_numpy(np.array(out)).bfloat16(),
                            torch.from_numpy(np.array(lse)), do, **kw)
    np.testing.assert_allclose(got_dq.float().numpy(), np.asarray(want_dq),
                               rtol=1e-2, atol=1e-2)
