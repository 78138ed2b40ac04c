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
