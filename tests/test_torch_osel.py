"""The port's OSEL path against the JAX package: the mask-encode kernel's
plain version (the CUDA kernel's own check is in test_torch_gpu.py), the
baseline IS @ OS mask, the sparse row memory, the FPGA cycle and
footprint models, and the Table I load-balance allocators."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite's workers share the host's cores

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.core import grouped as jgrouped  # noqa: E402
from repro.core import load_balance as jlb  # noqa: E402
from repro.core import osel as josel  # noqa: E402
from repro.kernels.osel_encode import ops as jops  # noqa: E402
from repro.kernels.osel_encode import ref as jref  # noqa: E402
from repro.kernels.osel_encode.osel_encode import encode_mask  # noqa: E402
from repro_torch.core import flgw, grouped, load_balance, osel  # noqa: E402
from repro_torch.kernels.osel_encode import ops, ref  # noqa: E402

# the JAX kernel's own cases (tests/test_kernels.py) plus ragged ones
_SHAPES = [(8, 8), (128, 512), (300, 200), (1, 64), (257, 129), (5, 3),
           (33, 17), (64, 1)]


def _indices(m, n, g, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, g, m).astype(np.int32),
            rng.integers(0, g, n).astype(np.int32))


@pytest.mark.parametrize("g", [2, 4, 16])
@pytest.mark.parametrize("m,n", _SHAPES)
def test_osel_mask_matches_jax_kernel_bitwise(m, n, g):
    ig, og = _indices(m, n, g, m * n + g)
    want = np.asarray(encode_mask(jnp.asarray(ig), jnp.asarray(og),
                                  interpret=True))
    # int64 indices (as flgw.grouping_indices gives them) and int32 alike
    for dtype in (torch.int64, torch.int32):
        got = ops.osel_mask(torch.from_numpy(ig).to(dtype),
                            torch.from_numpy(og).to(dtype))
        assert got.dtype == torch.uint8 and got.shape == (m, n)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ref.ref_mask_indices(torch.from_numpy(ig), torch.from_numpy(og)),
        np.asarray(jref.ref_mask_indices(jnp.asarray(ig), jnp.asarray(og))))


def test_osel_mask_edges():
    empty = ops.osel_mask(torch.zeros(0, dtype=torch.int64),
                          torch.arange(5))
    assert empty.shape == (0, 5) and empty.dtype == torch.uint8
    assert ops.osel_mask(torch.arange(3), torch.zeros(0)).shape == (3, 0)
    with pytest.raises(ValueError, match="1-d index vectors"):
        ops.osel_mask(torch.zeros(2, 2), torch.zeros(2))


@pytest.mark.parametrize("m,g,n", [(64, 8, 96), (30, 4, 128), (7, 3, 5)])
def test_reference_mask_matches_jax_and_the_kernel(m, g, n):
    rng = np.random.default_rng(m)
    ig = rng.standard_normal((m, g)).astype(np.float32)
    og = rng.standard_normal((g, n)).astype(np.float32)
    want = np.asarray(jops.reference_mask(jnp.asarray(ig), jnp.asarray(og)))
    got = ops.reference_mask(torch.from_numpy(ig), torch.from_numpy(og))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    ig_idx, og_idx = flgw.grouping_indices(torch.from_numpy(ig),
                                           torch.from_numpy(og))
    np.testing.assert_array_equal(ops.osel_mask(ig_idx, og_idx).numpy() > 0,
                                  want)
    wl = ref.ref_workloads(ig_idx, og_idx, g)
    np.testing.assert_array_equal(
        wl.numpy(), np.asarray(jref.ref_workloads(
            jnp.asarray(ig_idx.numpy()), jnp.asarray(og_idx.numpy()), g)))
    np.testing.assert_array_equal(wl.numpy(), want.sum(1))


@pytest.mark.parametrize("m,n,g,cap_n", [(128, 512, 4, None), (40, 24, 8, 5),
                                         (17, 9, 3, None), (6, 40, 16, 3)])
def test_encode_matches_jax_bitwise(m, n, g, cap_n):
    """All four fields of the sparse row memory, forward and transposed;
    the memory rebuilds the mask and its transpose."""
    ig, og = _indices(m, n, g, m + n)
    ti, to = torch.from_numpy(ig).long(), torch.from_numpy(og).long()
    pairs = [(osel.encode(ti, to, g, cap_n),
              josel.encode(jnp.asarray(ig), jnp.asarray(og), g, cap_n)),
             (osel.transpose_encode(ti, to, g),
              josel.transpose_encode(jnp.asarray(ig), jnp.asarray(og), g))]
    for got, want in pairs:
        for name in got._fields:
            a, b = getattr(got, name), np.asarray(getattr(want, name))
            assert a.dtype == (torch.bool if name == "bitvectors"
                               else torch.int32), name
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    mask = flgw.mask_from_indices(ti, to, torch.bool)
    assert torch.equal(osel.mask_from_memory(pairs[0][0]), mask)
    assert torch.equal(osel.mask_from_memory(pairs[1][0]), mask.T)
    np.testing.assert_array_equal(
        osel.mask_from_memory(pairs[0][0]).numpy(),
        np.asarray(josel.mask_from_memory(pairs[0][1])))


def test_fpga_models_equal_jax_on_fig10_grid():
    grid = [(128, 512, g) for g in (2, 4, 8, 16, 32)] + \
        [(m, m // 4, 8) for m in (2048, 4096, 8192)] + [(30, 128, 4)]
    for m, n, g in grid:
        for use in (True, False):
            assert osel.cycle_model(m, n, g, use_osel=use) == \
                josel.cycle_model(m, n, g, use_osel=use)
            assert osel.footprint_model(m, n, g, use_grouping=use) == \
                josel.footprint_model(m, n, g, use_grouping=use)


@pytest.mark.parametrize("m,n,g,cores,seed", [(128, 64, 4, 4, 0),
                                              (97, 33, 8, 3, 1),
                                              (256, 128, 2, 8, 2)])
def test_load_balance_allocators_equal_jax(m, n, g, cores, seed):
    """The three Table I allocators and the deviation metric, on a random
    FLGW mask and on the balanced plan's groups, equal the JAX package's
    from tensors and from arrays."""
    rng = np.random.default_rng(seed)
    ig = rng.standard_normal((m, g)).astype(np.float32)
    og = rng.standard_normal((g, n)).astype(np.float32)
    ti, to = flgw.grouping_indices(torch.from_numpy(ig), torch.from_numpy(og))
    mask = flgw.mask_from_indices(ti, to)
    jmask = np.asarray(mask.numpy())
    for x in (mask, jmask):
        for fn in ("threshold_allocate", "row_allocate"):
            got = getattr(load_balance, fn)(x, cores)
            want = getattr(jlb, fn)(jmask, cores)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=fn)
            assert load_balance.deviation(got) == jlb.deviation(want)
        np.testing.assert_array_equal(load_balance.row_workloads(x),
                                      jlb.row_workloads(jmask))
    plan = grouped.make_plan(torch.from_numpy(ig), torch.from_numpy(og), 1.25)
    jplan = jgrouped.make_plan(jnp.asarray(ig), jnp.asarray(og), 1.25)
    # the groups of every item but the reference fault's M-1 / N-1 (ROADMAP
    # Queue 3) are equal; the allocators are held on the port's groups
    np.testing.assert_array_equal(plan.row_group[:-1].numpy(),
                                  np.asarray(jplan.row_group)[:-1])
    got = load_balance.balanced_allocate(plan.row_group, plan.col_group,
                                         cores, g)
    want = jlb.balanced_allocate(plan.row_group.numpy(),
                                 plan.col_group.numpy(), cores, g)
    np.testing.assert_array_equal(got, want)
    assert load_balance.deviation(torch.from_numpy(got)) == \
        jlb.deviation(want)
