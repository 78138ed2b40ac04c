"""The port's flash-attention forward (its plain path: ``out`` and
``lse``) against the JAX package's Pallas kernel in interpret mode."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

jnp = pytest.importorskip("jax.numpy")

from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

# f32: both sides run f32 math, summed in another order. bf16: the same
# f32 math on bf16 inputs, the output rounded to bf16 (2**-8 relative).
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2 ** -7, atol=2e-3)}
LSE_TOL = dict(rtol=1e-5, atol=1e-4)


def _qkv(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,s,window,softcap,causal", [
    (4, 2, 40, 0, 50.0, True),      # GQA qpk=2, softcap, S not a tile multiple
    (4, 2, 40, 12, 50.0, True),     # window < S: dead blocks skipped
    (2, 2, 24, 0, 0.0, True),
    (4, 1, 16, 5, 0.0, False),      # window without the causal mask
])
def test_flash_fwd_plain_matches_the_jax_kernel(dtype, hq, hkv, s, window,
                                                 softcap, causal):
    q, k, v = _qkv(s + hq, 2, hq, hkv, s, 16)
    jd = getattr(jnp, dtype)
    want_o, want_lse = jflash.flash_fwd(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
        causal=causal, window=window, softcap=softcap, bq=8, bk=8,
        interpret=True)
    td = getattr(torch, dtype)
    got_o, got_lse = ops.flash_fwd(
        torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
        torch.from_numpy(v).to(td), causal=causal, window=window,
        softcap=softcap)
    assert got_o.dtype == td and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.float().numpy(),
                               np.asarray(want_o, np.float32), **TOL[dtype])
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               **LSE_TOL)


def test_rows_with_no_allowed_key_give_zero_and_neg_inf():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 2, 2, 8, 4))
    # a window of 1 with the causal mask off still allows the diagonal;
    # shorten T so queries past it have no key at all
    out, lse = ops.flash_fwd(q, k[:, :, :3], v[:, :, :3], causal=False,
                             window=1)
    assert torch.all(out[:, :, 4:] == 0)
    assert torch.all(lse[:, :, 4:] == ref.NEG_INF)
    assert torch.isfinite(lse[:, :, :3]).all()


# The card's bf16 forward (flash_fwd_wgmma_kernel): 64-key tiles, bf16
# operands with f32 sums, the online softmax in f32, p rounded to bf16
# only as the operand of P.V, l summed from the f32 p, the softcap's
# division as a product by 1 / cap.
TC_BK = 64


def _emulate_tc_fwd(q, k, v, *, causal, window, softcap):
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    qf = q.float()
    kf, vf = (x.float().repeat_interleave(hq // hkv, 1) for x in (k, v))
    m = torch.full((b, hq, s, 1), ref.NEG_INF)
    l = torch.zeros((b, hq, s, 1))
    acc = torch.zeros((b, hq, s, d))
    allowed = ref.allowed_mask(s, t, causal=causal, window=window)
    for k0 in range(0, t, TC_BK):
        z = qf @ kf[:, :, k0:k0 + TC_BK].transpose(-1, -2) * d ** -0.5
        if softcap > 0:
            z = torch.tanh(z * (1.0 / softcap)) * softcap
        z = torch.where(allowed[:, k0:k0 + TC_BK], z, -torch.inf)
        m_new = torch.maximum(m, z.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(z - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.bfloat16().float() @ vf[:, :, k0:k0 + TC_BK]
        m = m_new
    l_safe = torch.where(l == 0, 1.0, l)
    lse = torch.where(l == 0, ref.NEG_INF, m + torch.log(l_safe))
    return (acc / l_safe).bfloat16(), lse[..., 0]


@pytest.mark.parametrize("window,softcap", [(0, 50.0), (100, 0.0)])
def test_tensor_core_rounding_fits_the_card_tolerance(window, softcap):
    """The card's bf16 design, emulated at the model's head dim, against
    the JAX kernel on the same bf16 values in f32 math: within the card
    tests' bf16 tolerance (1e-2) and lse's (rtol 1e-5, atol 1e-4)."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(7, 1, 8, 4, 256, 256))
    kw = dict(causal=True, window=window, softcap=softcap)
    want_o, want_lse = jflash.flash_fwd(
        *(jnp.asarray(x.float().numpy()) for x in (q, k, v)), bq=128,
        bk=128, interpret=True, **kw)
    got_o, got_lse = _emulate_tc_fwd(q, k, v, **kw)
    np.testing.assert_allclose(got_o.float().numpy(), np.asarray(want_o),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               **LSE_TOL)
