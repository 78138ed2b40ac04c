"""The port's fused compact matmul (plain path of ``fused_bmm``),
``compact_weights`` and the attach helpers against the JAX package."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

jnp = pytest.importorskip("jax.numpy")

from repro.core import grouped as jgrouped  # noqa: E402
from repro.kernels.flgw_matmul import flgw_matmul as jkernel  # noqa: E402
from repro.kernels.flgw_matmul import ops as jkops  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import flgw, grouped  # noqa: E402
from repro_torch.kernels.flgw_matmul import ops as kops  # noqa: E402
from repro_torch.kernels.flgw_matmul import ref as kref  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)   # f32 sums taken in another order


def _layer(seed, m, n, g, lead=()):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"w": f(*lead, m, n) / np.float32(np.sqrt(m)),
            "ig": f(*lead, m, g), "og": f(*lead, g, n)}


def _plans(p):
    jp = jgrouped.make_plan(jnp.asarray(p["ig"]), jnp.asarray(p["og"]), 1.25)
    return jp, interop.plan_from_numpy(jp)


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
def test_compact_weights_is_bitwise_the_reference(lead):
    p = _layer(len(lead), 40, 24, 4, lead)
    jp, plan = _plans(p)
    want = jkops.compact_weights(jnp.asarray(p["w"]), jp.row_ids, jp.col_ids,
                                 jp.row_valid, jp.col_valid)
    got = kops.compact_weights(torch.from_numpy(p["w"]), plan.row_ids,
                               plan.col_ids, plan.row_valid, plan.col_valid)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,n,g,b", [(32, 128, 4, 6), (30, 5, 2, 3),
                                     (70, 33, 4, 9)])
def test_fused_matmul_plain_path_matches_jax(m, n, g, b):
    """Ragged capM/capN and padding slots routed to the sink column."""
    p = _layer(m + n, m, n, g)
    x = np.random.default_rng(b).standard_normal((b, m)).astype(np.float32)
    jp, plan = _plans(p)
    assert not bool(np.asarray(jp.row_valid).all())   # sink ids exercised
    jwc = jkops.compact_weights(jnp.asarray(p["w"]), jp.row_ids, jp.col_ids,
                                jp.row_valid, jp.col_valid)
    want = jkops.grouped_matmul_fused(jnp.asarray(x), jwc, jp.row_ids,
                                      jp.row_valid, jp.col_ids, jp.col_valid,
                                      n=n, interpret=True)
    wc = kops.compact_weights(torch.from_numpy(p["w"]), plan.row_ids,
                              plan.col_ids, plan.row_valid, plan.col_valid)
    got = kops.grouped_matmul_fused(torch.from_numpy(x), wc, plan.row_ids,
                                    plan.row_valid, plan.col_ids,
                                    plan.col_valid, n=n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    gather = kops.grouped_matmul(torch.from_numpy(x), torch.from_numpy(p["w"]),
                                 plan.row_ids, plan.col_ids, plan.row_valid,
                                 plan.col_valid)
    torch.testing.assert_close(got, gather, **TOL)


def test_fused_bmm_plain_version_matches_the_jax_kernel():
    rng = np.random.default_rng(0)
    b, m, g, k, n = 8, 20, 4, 16, 24
    x = rng.standard_normal((b, m + 1)).astype(np.float32)
    x[:, m] = 0.0                                   # the zero sink column
    wc = rng.standard_normal((g, k, n)).astype(np.float32)
    ids = rng.integers(0, m + 1, (g, k)).astype(np.int32)
    ids[:, -3:] = m
    want = jkernel.fused_bmm(jnp.asarray(x), jnp.asarray(wc), jnp.asarray(ids),
                             bb=8, bn=8, bk=8, interpret=True)
    xt = torch.from_numpy(np.ascontiguousarray(x.T))   # the kernel's layout
    assert torch.equal(kops.sink_transposed(torch.from_numpy(x[:, :m])), xt)
    got = kref.ref_fused_bmm(xt, torch.from_numpy(wc), torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(kops.fused_bmm(xt, torch.from_numpy(wc),
                                      torch.from_numpy(ids)), got)


def test_bf16_fused_plain_path_rounds_like_the_reference():
    """bf16 operands, f32 accumulation, bf16 out: within one bf16 ulp of
    JAX's reference gather path (its Pallas path cannot run bf16 on
    XLA's CPU)."""
    p = _layer(5, 48, 40, 4)
    x = np.random.default_rng(6).standard_normal((5, 48)).astype(np.float32)
    jp, plan = _plans(p)
    jw = jnp.asarray(p["w"], jnp.bfloat16)
    want = jkops.grouped_matmul(jnp.asarray(x, jnp.bfloat16), jw, jp.row_ids,
                                jp.col_ids, jp.row_valid, jp.col_valid,
                                impl="reference")
    w = torch.from_numpy(p["w"]).bfloat16()
    wc = kops.compact_weights(w, plan.row_ids, plan.col_ids, plan.row_valid,
                              plan.col_valid)
    got = kops.grouped_matmul_fused(torch.from_numpy(x).bfloat16(), wc,
                                    plan.row_ids, plan.row_valid,
                                    plan.col_ids, plan.col_valid, n=40)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2 ** -7, atol=1e-3)


def test_attached_plans_take_the_fused_path_and_agree_with_gather():
    lead = (2,)
    p = {k: torch.from_numpy(v) for k, v in _layer(7, 32, 48, 4, lead).items()}
    params = {"blk": {"ffn": p}}
    cfg = flgw.FLGWConfig(groups=4, path="grouped")
    plans = grouped.encode_plans(params, cfg)
    assert not grouped.has_compact(plans)
    attached = grouped.attach_compact(plans, params)
    assert grouped.has_compact(attached)
    assert attached["blk"]["ffn"].wc.shape == (2, 4, 10, 15)
    assert not grouped.has_compact(grouped.strip_compact(attached))
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (5, 32)).astype(np.float32))
    calls = kops.FUSED.launches
    with torch.inference_mode():
        for i in range(2):
            layer = {k: v[i] for k, v in p.items()}
            bare = grouped.GroupPlan(*(t[i] for t in plans["blk"]["ffn"][:6]))
            fused = bare._replace(wc=attached["blk"]["ffn"].wc[i])
            y_f = grouped.grouped_apply(x, *layer.values(), cfg, plan=fused)
            y_g = grouped.grouped_apply(x, *layer.values(), cfg, plan=bare)
            torch.testing.assert_close(y_f, y_g, **TOL)
    assert kops.FUSED.launches == calls          # the CPU took the plain path


@pytest.mark.parametrize("fused", [True, False])
def test_compact_outputs_keep_rows_16_byte_aligned(fused):
    """y (B, N) is a view past the sink columns whose rows start 16 bytes
    apart in bf16, so a projection's output handed to the flash kernels
    (the prefill's v) meets the tensor-core route's row alignment."""
    m, n, g, b = 64, 128, 4, 5
    p = _layer(7, m, n, g)
    _, plan = _plans(p)
    w = torch.from_numpy(p["w"]).bfloat16()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (b, m)).astype(np.float32)).bfloat16()
    if fused:
        wc = kops.compact_weights(w, plan.row_ids, plan.col_ids,
                                  plan.row_valid, plan.col_valid)
        y = kops.grouped_matmul_fused(x, wc, plan.row_ids, plan.row_valid,
                                      plan.col_ids, plan.col_valid, n=n)
    else:
        y = kops.grouped_matmul(x, w, plan.row_ids, plan.col_ids,
                                plan.row_valid, plan.col_valid)
    assert y.shape == (b, n) and y.stride(1) == 1
    assert y.stride(0) * y.element_size() % 16 == 0
    assert y.data_ptr() % 16 == 0


@pytest.mark.parametrize("k,n", [(720, 640), (720, 320), (640, 720),
                                 (720, 2880), (2880, 720)])
@pytest.mark.parametrize("b", [4, 64])
def test_decode_splits_cover_k_in_k_steps(k, n, b):
    """The split plan of a bf16 decode call at gemma2-2b's compact widths
    (G = 4) on a 132-SM card: splits of a multiple of the 32-deep k-step,
    at most the 512 k-rows a block stages, covering K exactly (the last
    one not empty); a prefill's 4096 rows take none."""
    splits, k_split = kops.k_splits(4, b, k, n, 132)
    assert k_split % 32 == 0 and k_split <= 512
    assert (splits - 1) * k_split < k <= splits * k_split
    assert kops.k_splits(4, 4096, k, n, 132) == (1, k)
