"""The dry run's pieces against the JAX package: the registry's shape
cells and input specs, the roofline's analytic costs and terms, and the
flops the dry run counts on the ``meta`` device against the same step
on real CPU tensors. The dry run's collective counts against a real
spawned mesh are held in ``test_torch_lm_mesh.py``. The JAX side never
imports ``repro.launch.dryrun`` (its import sets ``XLA_FLAGS`` for the
whole worker)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite's workers share the host's cores
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs import registry as jregistry  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.train import state as state_lib  # noqa: E402
from repro_torch.train import step as step_lib  # noqa: E402

def test_registry_cells_and_shapes_are_the_references():
    assert registry.SHAPES == jregistry.SHAPES
    assert registry.LONG_OK == jregistry.LONG_OK
    assert registry.NO_LM_SHAPES == jregistry.NO_LM_SHAPES
    # the same cells; the two ARCH_IDS list the archs in other orders
    assert sorted(registry.all_cells()) == sorted(jregistry.all_cells())
    assert set(jregistry.ARCH_IDS) - set(registry.ARCH_IDS) == {"ic3net"}
    for arch in jregistry.ARCH_IDS:
        assert registry.cells(arch) == jregistry.cells(arch)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_input_specs_are_the_references(arch):
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    for shape in registry.SHAPES:
        got = registry.input_specs(cfg, shape)
        want = jregistry.input_specs(jcfg, shape)
        assert list(got) == list(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape)
            assert str(t.dtype).removeprefix("torch.") == \
                jnp.dtype(want[k].dtype).name


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_flash_cost_and_model_flops_equal_the_references(arch):
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    for shape, (seq, batch, kind) in registry.SHAPES.items():
        got = roofline.flash_attention_cost(cfg, batch=batch, seq=seq,
                                            kind=kind)
        assert got == jroofline.flash_attention_cost(jcfg, batch=batch,
                                                     seq=seq, kind=kind)
        for k in ("train", "serve"):
            assert roofline.model_flops(cfg, batch * seq, kind=k) == \
                jroofline.model_flops(jcfg, batch * seq, kind=k)


def test_roofline_terms_equal_the_reference_at_the_h100s_numbers(
        monkeypatch):
    monkeypatch.setattr(jroofline, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(jroofline, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(jroofline, "ICI_BW", roofline.LINK_BW)
    for kw in (dict(flops_per_chip=3e14, bytes_per_chip=2e12,
                    collective_bytes_per_chip=4e10, model_flops_total=5e16,
                    chips=256),
               dict(flops_per_chip=0.0, bytes_per_chip=1e9,
                    collective_bytes_per_chip=0.0, model_flops_total=1e12,
                    chips=1, fused_bytes_per_chip=5e8)):
        got, want = roofline.roofline_terms(**kw), jroofline.roofline_terms(
            **kw)
        assert got.keys() == want.keys()
        for k, v in want.items():
            if isinstance(v, float) and np.isnan(v):
                assert np.isnan(got[k])
            else:
                assert got[k] == v, k
    assert roofline.bound_ms(3.35e9, 0) == (1.0, "bytes")
    assert roofline.bound_ms(0, 67e9) == (1.0, "operations")


@pytest.fixture(scope="module")
def smoke():
    cfg = registry.get_smoke_config("gemma2_2b", dtype=torch.float32,
                                    flgw_groups=4, flgw_path="grouped")
    return cfg


def test_meta_flops_equal_the_real_cpu_steps(smoke):
    """The flops the dry run counts of one train step on ``meta`` equal
    the count of the same step on real CPU tensors (the kernels' plain
    versions run by shape alone on ``meta``); a prefill and a decode step
    count flops on ``meta`` too."""
    cfg = smoke
    kw = dict(q_chunk=16, ce_chunk=16)
    gen = torch.Generator().manual_seed(0)
    real = state_lib.init_state(gen, cfg)
    batch = {k: torch.randint(0, cfg.vocab, (2, 32), generator=gen)
             for k in ("tokens", "targets")}
    batch["positions"] = torch.arange(32).expand(2, 32).contiguous()
    counts = []
    for state, b in ((real, batch),
                     (state_lib.abstract_state(cfg),
                      dryrun._input_specs(cfg, 32, 2, "train"))):
        mode = dryrun.CostMode()
        with mode:
            step_lib.make_train_step(cfg, **kw)(state, b)
        counts.append(mode.flops)
    assert counts[0] == counts[1] > 0
    serve = [dryrun.measure_serve(cfg, seq=32, batch=2, kind=k)
             for k in ("prefill", "decode")]
    assert all(s["flops"] > 0 and s["collectives"] == {} for s in serve)


def test_dry_run_cell_reports_terms_on_a_fake_mesh(smoke):
    """A train cell at the smoke size on a fake (2, 2) world: the state
    bytes of rank 0's shards, the counted collectives, and the roofline
    terms with the model's flops divided by G on the grouped path."""
    res = dryrun.run_cell("gemma2_2b", "train_4k", flgw_groups=4,
                          flgw_path="grouped", save=False, cfg=smoke,
                          seq=32, batch=4, mesh_shape=(2, 2),
                          step_kw=dict(q_chunk=16, ce_chunk=16))
    assert res["mesh"] == "2x2" and res["chips"] == 4
    assert 0 < res["state_bytes_per_chip"] < res["state_bytes_whole"]
    ops = res["collectives"]
    assert {"all_gather", "reduce_scatter", "all_reduce"} <= set(ops)
    assert all(c["calls"] > 0 and c["bytes"] > 0 for c in ops.values())
    r = res["roofline"]
    assert r["model_flops_total"] == roofline.model_flops(
        smoke, 4 * 32, kind="train") / 4
    assert r["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert r["step_time_lower_bound_s"] > 0 and r["chips"] == 4
