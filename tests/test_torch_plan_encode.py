"""The port's plan encode (rank/place kernels' plain versions, the balanced
assignment and make_plan) against the JAX package's kernel path."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite's workers share the host's cores

jnp = pytest.importorskip("jax.numpy")

from repro.core import grouped as jgrouped  # noqa: E402
from repro.kernels import tiling as jtiling  # noqa: E402
from repro.kernels.plan_encode import ops as jops  # noqa: E402
from repro.kernels.plan_encode.plan_encode import assign_slots  # noqa: E402
from repro_torch.core import grouped  # noqa: E402
from repro_torch.kernels import tiling  # noqa: E402
from repro_torch.kernels.plan_encode import ops, ref  # noqa: E402

# (items, groups, slack, block): block=128 with items > 128 drives the
# multi-tile rank/place path; slack > 1 drives spills.
CASES = [(30, 4, 1.25, None), (40, 4, 1.0, None), (300, 4, 1.25, 128),
         (200, 3, 1.5, 128)]


def _scores(m, g, seed, lead=()):
    return np.random.default_rng(seed).standard_normal(
        (*lead, m, g)).astype(np.float32)


def test_tiling_copy_matches_reference():
    for m in (1, 7, 30, 128, 129, 512, 513, 4096):
        assert tiling.round_up(m, 128) == jtiling.round_up(m, 128)
        for block in (None, 128, 256):
            assert tiling.plan_block(m, block) == jtiling.plan_block(m, block)
        for g in (1, 2, 3, 4, 8):
            for slack in (1.0, 1.25, 1.5, 2.0):
                assert (tiling.compute_cap(m, g, slack)
                        == jtiling.compute_cap(m, g, slack))


@pytest.mark.parametrize("m,g,slack,block", CASES)
def test_balanced_assign_matches_jax_kernel_path(m, g, slack, block):
    s = _scores(m, g, seed=m + g)
    want = np.asarray(jops.balanced_assign(jnp.asarray(s), 1, slack,
                                           impl="pallas", block=block))
    got = ops.balanced_assign(torch.from_numpy(s), 1, slack, block=block)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # the sort oracle agrees with both
    np.testing.assert_array_equal(
        ref.ref_balanced_assign(torch.from_numpy(s), slack).numpy(), want)


def test_balanced_assign_columns_and_stacked_layers():
    # axis=0 (columns of OG) with two stacked layers in one launch
    s = np.swapaxes(_scores(200, 3, seed=5, lead=(2,)), -1, -2).copy()
    want = np.asarray(jops.balanced_assign(jnp.asarray(s), 0, 1.5,
                                           impl="pallas", block=128))
    got = ops.balanced_assign(torch.from_numpy(s), 0, 1.5, block=128)
    np.testing.assert_array_equal(got.numpy(), want)
    for layer in range(2):
        np.testing.assert_array_equal(
            got[layer].numpy(),
            ref.ref_balanced_assign(torch.from_numpy(s[layer].T), 1.5).numpy())


@pytest.mark.parametrize("m,g,slack,block", CASES[2:])
def test_rank_and_place_match_jax_assign_slots_on_every_item(m, g, slack,
                                                             block):
    """Bitwise on the whole padded range, padding items included: the
    CUDA kernels are held to these plain versions on the card."""
    s = torch.from_numpy(_scores(m, g, seed=3, lead=(2,)))
    pref, strength, bi = ops.preferences(s, 1, block)
    cap = tiling.compute_cap(m, g, slack)
    r, hist = ops.rank(pref, strength, g, bi)
    assert r.dtype == hist.dtype == torch.int32
    assert hist.shape == (2, pref.shape[1] // bi, g)
    slot = ops.place(pref, r, hist, g, cap)
    p, st = jnp.asarray(pref.numpy()), jnp.asarray(strength.numpy())
    want = assign_slots(p[..., None], st[..., None], p[:, None, :],
                        st[:, None, :], g=g, cap=cap, bi=bi, bj=bi,
                        interpret=True)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(want)[..., 0])


def _holder(ids, valid, size):
    """Group holding each item, from a plan's ids and validity mask."""
    out = np.full(size, -1)
    for grp in range(ids.shape[0]):
        out[ids[grp][valid[grp]]] = grp
    return out


@pytest.mark.parametrize("m,n,g,slack", [(30, 128, 4, 1.25),
                                         (32, 64, 2, 1.0)])
def test_make_plan_matches_jax_and_groups_every_item_correctly(m, n, g,
                                                               slack):
    rng = np.random.default_rng(7)
    ig = rng.standard_normal((m, g)).astype(np.float32)
    og = rng.standard_normal((g, n)).astype(np.float32)
    jp = jgrouped.make_plan(jnp.asarray(ig), jnp.asarray(og), slack)
    tp = grouped.make_plan(torch.from_numpy(ig), torch.from_numpy(og), slack)
    for f in ("row_ids", "col_ids", "row_valid", "col_valid"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    for side, size in (("row", m), ("col", n)):
        got = getattr(tp, f"{side}_group").numpy()
        want = np.asarray(getattr(jp, f"{side}_group"))
        holder = _holder(getattr(tp, f"{side}_ids").numpy(),
                         getattr(tp, f"{side}_valid").numpy(), size)
        # every item gets the group that holds it ...
        np.testing.assert_array_equal(got, holder)
        # ... which is the reference's value on every item it writes once;
        # with padding slots, the reference also writes item size-1 from
        # each of them (ids clipped to size-1), so that one may differ.
        padded = not getattr(tp, f"{side}_valid").numpy().all()
        same = np.ones(size, bool)
        if padded:
            same[size - 1] = False
        np.testing.assert_array_equal(got[same], want[same])


def test_reference_make_plan_last_item_group_fault_is_pinned():
    """The reference's make_plan clips padding ids to M-1 before it
    scatters the groups, so item M-1 takes a padding slot's group. This
    pins the fault: here the reference's value is wrong and the port's
    is the group that holds the item."""
    m, n, g = 30, 128, 4
    rng = np.random.default_rng(0)
    ig = rng.standard_normal((m, g)).astype(np.float32)
    og = rng.standard_normal((g, n)).astype(np.float32)
    jp = jgrouped.make_plan(jnp.asarray(ig), jnp.asarray(og), 1.25)
    tp = grouped.make_plan(torch.from_numpy(ig), torch.from_numpy(og), 1.25)
    holder = _holder(tp.row_ids.numpy(), tp.row_valid.numpy(), m)
    assert tp.row_group[m - 1].item() == holder[m - 1]
    assert int(np.asarray(jp.row_group)[m - 1]) != holder[m - 1]


def test_transpose_plan_swaps_rows_and_columns():
    rng = np.random.default_rng(1)
    ig = torch.from_numpy(rng.standard_normal((24, 2)).astype(np.float32))
    og = torch.from_numpy(rng.standard_normal((2, 40)).astype(np.float32))
    p = grouped.make_plan(ig, og, 1.25)
    pt = grouped.make_plan(og.T, ig.T, 1.25)
    for a, b in zip(grouped.transpose_plan(p)[:6], pt[:6]):
        assert torch.equal(a, b)
