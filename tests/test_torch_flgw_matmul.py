"""The port's FLGW forward (masked and grouped paths, the grouped-bmm
plain version, proj) against the JAX package."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

jnp = pytest.importorskip("jax.numpy")

from repro.core import flgw as jflgw  # noqa: E402
from repro.core import grouped as jgrouped  # noqa: E402
from repro.kernels import use_reference_impl  # noqa: E402
from repro.kernels.flgw_matmul import flgw_matmul as jkernel  # noqa: E402
from repro.kernels.flgw_matmul import ops as jkops  # noqa: E402
from repro.kernels.flgw_matmul import ref as jref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import flgw, grouped  # noqa: E402
from repro_torch.kernels.flgw_matmul import ops as kops  # noqa: E402
from repro_torch.models import layers  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)   # f32 sums taken in another order


def _layer(seed, m, n, g, b=6):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    w = (f(m, n) / np.sqrt(m)).astype(np.float32)
    return {"w": w, "ig": f(m, g), "og": f(g, n)}, f(b, m)


def _t(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_bmm_plain_version_matches_jax_kernel(dtype):
    """At a ragged K (36: not a multiple of 8, so no TMA tile divides it):
    f32 against the Pallas kernel in interpret mode; bf16 against the JAX
    reference under ``use_reference_impl()``, as the other bf16 parity
    tests run it, within one bf16 rounding (f32 sums in another order)."""
    rng = np.random.default_rng(0)
    xg = rng.standard_normal((4, 8, 36)).astype(np.float32)
    wc = rng.standard_normal((4, 36, 16)).astype(np.float32)
    if dtype == "float32":
        want = jkernel.grouped_bmm(jnp.asarray(xg), jnp.asarray(wc), bb=8,
                                   bn=16, bk=36, interpret=True)
        got = kops.grouped_bmm(torch.from_numpy(xg), torch.from_numpy(wc))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        return
    with use_reference_impl():
        want = jref.ref_grouped_bmm(jnp.asarray(xg, jnp.bfloat16),
                                    jnp.asarray(wc, jnp.bfloat16))
    got = kops.grouped_bmm(torch.from_numpy(xg).bfloat16(),
                           torch.from_numpy(wc).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2 ** -7, atol=1e-3)


@pytest.mark.parametrize("b,k,n,aligned,route", [
    (64, 720, 640, True, kops.WMMA),      # rows: wmma up to 64 ...
    (65, 720, 640, True, kops.TMA),       # ... TMA past it, any row count
    (72, 720, 640, True, kops.TMA),
    (4096, 720, 2880, True, kops.TMA),    # the train MLP's up and gate
    (4096, 2880, 720, True, kops.TMA),    # and down
    (300, 8, 136, True, kops.TMA),        # K = 8, N = 136
    (300, 720, 45, True, kops.WMMA),      # N not a multiple of 8
    (300, 37, 720, True, kops.WMMA),      # K not a multiple of 8
    (300, 0, 136, True, kops.WMMA),       # K = 0: no TMA map
    (4096, 720, 2880, False, kops.WMMA),  # an unaligned view
    (4, 720, 2880, True, kops.WMMA)])
def test_bf16_bmm_route_is_a_shape_test(b, k, n, aligned, route):
    assert kops.bmm_bf16_route(b, k, n, aligned) == route


@pytest.mark.parametrize("g,b,n,cols", [
    (4, 128, 3, 32), (4, 128, 40, 32), (4, 128, 160, 32),  # the actor's
    (4, 64, 160, 32), (4, 65, 160, 32), (4, 72, 160, 32),
    (1, 128, 160, 32), (4, 128, 720, 64), (1, 256, 720, 64),
    (4, 128, 2880, 64), (4, 4096, 2880, 64)])
def test_f32_bmm_tile_width_fills_one_wave(g, b, n, cols):
    """32-column blocks while they fit a 132-SM card in one wave, 64
    past it."""
    assert kops.bmm_f32_cols(g, b, n, 132) == cols


def test_tma_route_rounding_fits_the_card_tolerance():
    """The TMA kernel's sums as the card takes them: a 128 x 256 tile's
    f32 accumulators over 16-deep steps of zero-filled 64-deep k-tiles
    (K = 200: the last k-tile ragged), rounded once to bf16, against the
    plain version within the card tests' rtol = atol = 1e-2."""
    rng = np.random.default_rng(7)
    g, b, k, n = 2, 130, 200, 264
    xg = torch.from_numpy(rng.standard_normal((g, b, k)).astype(
        np.float32)).bfloat16()
    wc = torch.from_numpy(rng.standard_normal((g, k, n)).astype(
        np.float32)).bfloat16()
    kp = -(-k // 64) * 64
    x = torch.zeros((g, b, kp))
    w = torch.zeros((g, kp, n))
    x[:, :, :k], w[:, :k] = xg.float(), wc.float()
    acc = torch.zeros((g, b, n))
    for s in range(0, kp, 16):
        acc += x[:, :, s:s + 16] @ w[:, s:s + 16]
    torch.testing.assert_close(acc.bfloat16().float(),
                               kops.grouped_bmm(xg, wc).float(),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("m,n,g", [(32, 128, 4), (30, 5, 2)])
def test_grouped_matmul_matches_jax_on_a_shared_plan(m, n, g):
    p, x = _layer(1, m, n, g)
    jp = jgrouped.make_plan(jnp.asarray(p["ig"]), jnp.asarray(p["og"]), 1.25)
    plan = interop.plan_from_numpy(jp)
    want = jkops.grouped_matmul(jnp.asarray(x), jnp.asarray(p["w"]),
                                jp.row_ids, jp.col_ids, jp.row_valid,
                                jp.col_valid, impl="pallas")
    got = kops.grouped_matmul(torch.from_numpy(x), torch.from_numpy(p["w"]),
                              plan.row_ids, plan.col_ids, plan.row_valid,
                              plan.col_valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("path", ["grouped", "masked", "dense"])
@pytest.mark.parametrize("transpose", [False, True])
def test_proj_matches_jax(path, transpose):
    m, n, g = 32, 96, 4
    p, x = _layer(2, m, n, g, b=5)
    if transpose:
        x = np.random.default_rng(3).standard_normal((5, n)).astype(np.float32)
    jcfg = jflgw.FLGWConfig(groups=g, path=path)
    tcfg = flgw.FLGWConfig(groups=g, path=path)
    want = jlayers.proj(_j(p), jnp.asarray(x), jcfg, transpose=transpose)
    with torch.inference_mode():
        got = layers.proj(_t(p), torch.from_numpy(x), tcfg,
                          transpose=transpose)
        if path == "grouped":   # a cached plan gives the same product
            plan = grouped.make_plan(torch.from_numpy(p["ig"]),
                                     torch.from_numpy(p["og"]), 1.25)
            cached = layers.proj(_t(p), torch.from_numpy(x), tcfg,
                                 transpose=transpose, plan=plan)
            assert torch.equal(cached, got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_grouped_path_flattens_leading_dims():
    p, _ = _layer(4, 32, 64, 4)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 3, 32)).astype(np.float32))
    cfg = flgw.FLGWConfig(groups=4, path="grouped")
    with torch.inference_mode():
        y = layers.proj(_t(p), x, cfg)
        flat = layers.proj(_t(p), x.reshape(6, 32), cfg)
    assert y.shape == (2, 3, 64)
    assert torch.equal(y.reshape(6, 64), flat)


def test_grouping_indices_mask_and_sparsity_match_jax():
    p, _ = _layer(6, 40, 24, 4)
    p["ig"][3, 1] = p["ig"][3, 2] = 5.0          # an argmax tie: first wins
    ji, jo = jflgw.grouping_indices(jnp.asarray(p["ig"]), jnp.asarray(p["og"]))
    ti, to = flgw.grouping_indices(torch.from_numpy(p["ig"]),
                                   torch.from_numpy(p["og"]))
    assert ti[3].item() == 1
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(flgw.mask_from_indices(ti, to).numpy(),
                                  np.asarray(jflgw.mask_from_indices(ji, jo)))
    assert float(flgw.mask_sparsity(ti, to, 4)) == pytest.approx(
        float(jflgw.mask_sparsity(ji, jo, 4)), abs=1e-7)
    cfg = flgw.FLGWConfig(groups=4)
    assert cfg.enabled and cfg.avg_sparsity == 0.75
    assert not flgw.FLGWConfig(groups=4, path="dense").enabled


def test_unported_paths_raise():
    """The compact-weight path is ported now (tests/test_torch_fused_bmm.py),
    MoE FFNs are served and trained (tests/test_torch_moe.py), SSM
    mixers run (tests/test_torch_ssm.py) and whisper-large-v3's
    cross-attention and encoder stack run (tests/test_torch_whisper.py).
    What still raises instead of running something else: a cross slot
    with no encoder output to attend (the reference's fault, ROADMAP
    Queue 3), the JAX package's dry-run cost variants, and an unknown
    mixer. The SSM mixer now initialises, and the grouped product of
    stacked experts now takes gradients under autograd."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer
    from repro_torch.models.config import SlotSpec
    p, x = _layer(8, 16, 16, 2)
    cfg = registry.get_smoke_config("gemma2_2b", dtype=torch.float32)
    tok = torch.zeros((1, 4), dtype=torch.long)
    pos = torch.arange(4)[None]
    # a cross slot, with and without an encoder stack, given no frames
    # and no cache; the dry-run cost variants; an unknown mixer
    whisper = SlotSpec(mixer="attn", window=0, ffn="mlp", cross=True)
    for bad in (dict(pattern=(whisper,), encoder_layers=2),
                dict(pattern=(SlotSpec(cross=True),))):
        c = cfg.with_updates(n_layers=2, **bad)
        params = transformer.lm_init(torch.Generator(), c)
        with pytest.raises(ValueError, match="no frames"):
            transformer.lm_apply(params, c, tok, pos)
    params = transformer.lm_init(torch.Generator(), cfg.with_updates(
        n_layers=2, encoder_layers=2))
    for variant in ("unroll_blocks", "attn_identity", "ssd_unroll"):
        with pytest.raises(NotImplementedError, match=variant):
            transformer.lm_apply(params, cfg.with_updates(
                n_layers=2, encoder_layers=2), tok, pos, **{variant: True})
    with pytest.raises(NotImplementedError, match="'mlp' mixer"):
        transformer.lm_init(torch.Generator(), cfg.with_updates(
            n_layers=2, pattern=(SlotSpec(mixer="mlp"),)))
    ssm = transformer.lm_init(torch.Generator(), cfg.with_updates(
        n_layers=2, pattern=(SlotSpec(mixer="ssm"),), ssm_state=8,
        ssm_head_dim=16))
    assert set(ssm["blocks"]["slot0"]["mixer"]) == {
        "in", "out", "conv_w", "A_log", "D", "dt_bias", "norm"}
    experts = [torch.from_numpy(np.stack([a] * 3)) for a in
               (x, p["w"], p["ig"], p["og"])]
    experts[1].requires_grad_()
    y = flgw.flgw_linear(*experts, flgw.FLGWConfig(groups=2, path="grouped"))
    y.sum().backward()
    # three identical experts: three identical weight gradients
    assert experts[1].grad.shape == experts[1].shape
    assert torch.equal(experts[1].grad[0], experts[1].grad[2])
    assert experts[1].grad.abs().sum() > 0
    with pytest.raises(ValueError, match="unknown FLGW path"):
        flgw.flgw_linear(torch.from_numpy(x), torch.from_numpy(p["w"]),
                         torch.from_numpy(p["ig"]), torch.from_numpy(p["og"]),
                         flgw.FLGWConfig(groups=2, path="bogus"))
