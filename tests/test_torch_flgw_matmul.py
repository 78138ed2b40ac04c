"""The port's FLGW forward (masked and grouped paths, the grouped-bmm
plain version, proj) against the JAX package."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

jnp = pytest.importorskip("jax.numpy")

from repro.core import flgw as jflgw  # noqa: E402
from repro.core import grouped as jgrouped  # noqa: E402
from repro.kernels.flgw_matmul import flgw_matmul as jkernel  # noqa: E402
from repro.kernels.flgw_matmul import ops as jkops  # noqa: E402
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


def test_grouped_bmm_plain_version_matches_jax_kernel():
    rng = np.random.default_rng(0)
    xg = rng.standard_normal((4, 8, 40)).astype(np.float32)
    wc = rng.standard_normal((4, 40, 16)).astype(np.float32)
    want = jkernel.grouped_bmm(jnp.asarray(xg), jnp.asarray(wc), bb=8, bn=16,
                               bk=40, interpret=True)
    got = kops.grouped_bmm(torch.from_numpy(xg), torch.from_numpy(wc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


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
    """The compact-weight path is ported now (tests/test_torch_fused_bmm.py);
    what is still unported raises instead of running something else."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer
    from repro_torch.models.config import SlotSpec
    p, x = _layer(8, 16, 16, 2)
    cfg = registry.get_smoke_config("gemma2_2b", dtype=torch.float32)
    for slot in (SlotSpec(mixer="ssm"), SlotSpec(ffn="moe"),
                 SlotSpec(cross=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            transformer.lm_init(torch.Generator(),
                                cfg.with_updates(pattern=(slot,), n_layers=2))
    with pytest.raises(ValueError, match="unknown FLGW path"):
        flgw.flgw_linear(torch.from_numpy(x), torch.from_numpy(p["w"]),
                         torch.from_numpy(p["ig"]), torch.from_numpy(p["og"]),
                         flgw.FLGWConfig(groups=2, path="bogus"))
