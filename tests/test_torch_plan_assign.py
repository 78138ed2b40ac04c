"""The port's one-launch plan encode (``plan_assign``'s plain version, the
``assign`` wrapper and ``make_plan`` through it) against the JAX package's
kernel path, and a plain emulation of the CUDA kernel's sort-key and
rank-from-position arithmetic against the comparator rank."""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite's workers share the host's cores

jnp = pytest.importorskip("jax.numpy")

from repro.core import grouped as jgrouped  # noqa: E402
from repro.kernels.plan_encode import ops as jops  # noqa: E402
from repro_torch.core import grouped  # noqa: E402
from repro_torch.kernels.plan_encode import ops, ref  # noqa: E402
from repro_torch.kernels.tiling import compute_cap  # noqa: E402

ITEMS = (1, 5, 30, 300, 1000)
GROUPS = (1, 3, 4, 8)
SLACKS = (1.0, 1.25, 1.5)
CU = Path(ops.__file__).resolve().parents[2] / "csrc" / "plan_encode.cu"


def _scores(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _holder(ids, size):
    """Group whose slot holds each item, from unclipped (G, cap) ids."""
    out = np.full(size, -1)
    for grp, row in enumerate(ids):
        out[row[row < size]] = grp
    return out


def _emulate_plan_assign(flat):
    """What ``plan_assign_kernel`` computes, step by step, on (L, M, G)
    f32 scores: ``(rank (L, M), ids (L, G*cap), group (L, M))`` for
    ``cap`` = M/G rounded up (slack 1), numpy throughout."""
    flat = np.asarray(flat, dtype=np.float32)
    n_layers, m, g = flat.shape
    cap = compute_cap(m, g)
    ranks = np.zeros((n_layers, m), np.int64)
    ids = np.full((n_layers, g * cap), m, np.int64)
    group = np.zeros((n_layers, m), np.int64)
    for layer, s in enumerate(flat):
        # 1. argmax by a strict compare (first index wins a tie), the
        # strength folded -0.0 -> +0.0, its order-preserving key inverted
        pref = np.zeros(m, np.int64)
        best = s[:, 0].copy()
        for h in range(1, g):
            better = s[:, h] > best
            pref[better], best[better] = h, s[better, h]
        u = np.where(best == 0.0, np.float32(0.0), best).view(np.uint32)
        u = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)
        key = ~u
        packed = (pref.astype(np.uint32) << 16) | np.arange(m, dtype=np.uint32)
        # 2. stable sorts: the strength key, then the group bits alone
        packed = packed[np.argsort(key, kind="stable")]
        packed = packed[np.argsort(packed >> 16, kind="stable")]
        # 3. the histogram's prefixes
        counts = np.bincount(pref, minlength=g)
        kcount = np.minimum(counts, cap)
        start = np.cumsum(counts) - counts
        ovf_before = np.cumsum(counts - kcount) - (counts - kcount)
        free_before = np.cumsum(cap - kcount) - (cap - kcount)
        # 4. rank from the sorted position, then the closed-form slot
        for pos, word in enumerate(packed):
            item, p = int(word & 0xFFFF), int(word >> 16)
            r = pos - start[p]
            ranks[layer, item] = r
            if r < cap:
                slot = p * cap + r
            else:
                q = ovf_before[p] + r - cap
                k = int(np.searchsorted(free_before, q, side="right")) - 1
                slot = k * cap + kcount[k] + (q - free_before[k])
            ids[layer, slot] = item
            group[layer, item] = slot // cap
    return ranks, ids, group


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("m", ITEMS)
def test_assign_matches_jax_kernel_path_on_both_axes(m, g):
    """Rows (axis 1) and columns (axis 0) of two stacked layers; the
    slack cycles over 1.0, 1.25 and 1.5 across the cases."""
    slack = SLACKS[(ITEMS.index(m) + GROUPS.index(g)) % len(SLACKS)]
    cap = compute_cap(m, g, slack)
    rows = _scores((2, m, g), seed=m * 10 + g)
    for axis, s in ((1, rows), (0, np.swapaxes(rows, -1, -2).copy())):
        want = np.asarray(jops.balanced_assign(jnp.asarray(s), axis, slack,
                                               impl="pallas"))
        ids, grp = ops.assign(torch.from_numpy(s), axis, slack)
        assert ids.dtype == grp.dtype == torch.int64
        assert ids.shape == (2, g, cap) and grp.shape == (2, m)
        np.testing.assert_array_equal(ids.numpy(), want, err_msg=f"{axis}")
        r_ids, r_grp = ref.ref_assign(torch.from_numpy(s), axis, slack)
        np.testing.assert_array_equal(r_ids.numpy(), want.reshape(2, -1))
        np.testing.assert_array_equal(r_grp.numpy(), grp.numpy())
        for layer in range(2):
            np.testing.assert_array_equal(grp[layer].numpy(),
                                          _holder(want[layer], m))
            np.testing.assert_array_equal(
                ref.ref_balanced_assign(torch.from_numpy(rows[layer]),
                                        slack).numpy(), want[layer])


@pytest.mark.parametrize("lead,m,n,g,slack", [
    ((), 1, 5, 3, 1.0), ((2,), 30, 128, 4, 1.25), ((3,), 300, 40, 8, 1.5),
    ((2,), 5, 1000, 1, 1.25)])
def test_make_plan_through_assign_matches_jax(lead, m, n, g, slack):
    """Every leaf of the plan, stacked layers included, equals JAX's
    ``make_plan``, apart from the pinned item-M-1 / N-1 group fault
    (``test_reference_make_plan_last_item_group_fault_is_pinned``)."""
    ig = _scores((*lead, m, g), seed=m + n)
    og = _scores((*lead, g, n), seed=m * n)
    jp = jgrouped.make_plan(jnp.asarray(ig), jnp.asarray(og), slack)
    tp = grouped.make_plan(torch.from_numpy(ig), torch.from_numpy(og), slack)
    for f in ("row_ids", "col_ids", "row_valid", "col_valid"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    for side, size in (("row", m), ("col", n)):
        ids = ops.assign(torch.from_numpy(ig if side == "row" else og),
                         1 if side == "row" else 0, slack)[0].numpy()
        got = getattr(tp, f"{side}_group").numpy().reshape(-1, size)
        want = np.asarray(getattr(jp, f"{side}_group")).reshape(-1, size)
        for layer, layer_ids in enumerate(ids.reshape(-1, g, ids.shape[-1])):
            np.testing.assert_array_equal(got[layer],
                                          _holder(layer_ids, size))
            same = np.ones(size, bool)
            if (layer_ids >= size).any():     # padded: the reference's
                same[size - 1] = False         # item size-1 may differ
            np.testing.assert_array_equal(got[layer][same],
                                          want[layer][same])


def _tied(m, g, seed):
    """Scores from {-1, 0, 1}: many exactly tied strengths and argmaxes."""
    return np.random.default_rng(seed).integers(
        -1, 2, (2, m, g)).astype(np.float32)


def _signed_zeros(m, g, seed):
    """Every score -0.0, +0.0 or -1: the strengths tie across the sign of
    zero, which the comparator treats as equal."""
    rng = np.random.default_rng(seed)
    s = np.where(rng.random((2, m, g)) < 0.5, -0.0, 0.0).astype(np.float32)
    s[rng.random((2, m, g)) < 0.2] = -1.0
    return s


def _one_group(m, g, seed):
    s = _scores((2, m, g), seed)
    s[..., g - 1] += 100.0
    return s


def _empty_groups(m, g, seed):
    """Only groups 1 and 3 are ever preferred."""
    s = _scores((2, m, g), seed)
    s[..., [0, 2, 4, 5, 6, 7][:g - 2]] -= 100.0
    return s


@pytest.mark.parametrize("make,m,g", [
    (_tied, 300, 4), (_tied, 64, 3), (_signed_zeros, 200, 4),
    (_signed_zeros, 33, 2), (_one_group, 100, 4), (_one_group, 7, 8),
    (_empty_groups, 120, 8), (_empty_groups, 50, 4), (_tied, 1, 4),
    (_signed_zeros, 1, 1)])
def test_kernel_sort_key_and_rank_from_position_equal_the_comparator(
        make, m, g):
    s = make(m, g, seed=m + g)
    flat = torch.from_numpy(s)
    rank, ids, group = _emulate_plan_assign(s)
    pref, strength, bi = ref.preferences(flat, 1)
    want_rank, _ = ref.ref_rank(pref, strength, g, bi)
    np.testing.assert_array_equal(rank, want_rank[:, :m].numpy())
    want_ids, want_group = ref.ref_assign(flat, 1)
    np.testing.assert_array_equal(ids, want_ids.numpy())
    np.testing.assert_array_equal(group, want_group.numpy())


def test_signed_zero_strengths_tie_in_the_key():
    """-0.0 and +0.0 get one key, so index order breaks their tie, as the
    comparator's ``==`` does."""
    s = np.array([[[-0.0, -1.0], [0.0, -1.0], [-0.0, -2.0]]], np.float32)
    rank, ids, _ = _emulate_plan_assign(s)
    np.testing.assert_array_equal(rank, [[0, 1, 2]])
    np.testing.assert_array_equal(ids, [[0, 1, 2, 3]])


@pytest.mark.parametrize("m,g,route", [
    (1, 1, "sort"), (5, 4, "sort"), (9216, 4, "sort"),
    (ops.SORT_MAX_ITEMS, 4, "sort"), (ops.SORT_MAX_ITEMS + 1, 4, "tiled"),
    (36864, 4, "tiled"), (100, ops.SORT_MAX_GROUPS, "sort"),
    (100, ops.SORT_MAX_GROUPS + 1, "tiled"),
    (ops.SORT_MAX_ITEMS, ops.SORT_MAX_GROUPS, "sort"), (0, 4, "tiled")])
def test_assign_route_at_its_limits(m, g, route):
    assert ops.assign_route(m, g) == route


def test_route_limits_are_the_c_entry_limits():
    src = CU.read_text()
    for name, value in (("kAssignMaxItems", ops.SORT_MAX_ITEMS),
                        ("kAssignMaxGroups", ops.SORT_MAX_GROUPS)):
        found = re.search(rf"constexpr int {name} = (\d+);", src)
        assert found and int(found.group(1)) == value, name
    # an item's index and its group ride in 16 bits each of the packed
    # sort value
    assert ops.SORT_MAX_ITEMS <= 1 << 16 and ops.SORT_MAX_GROUPS <= 1 << 16


@pytest.mark.parametrize("view", ["ig", "og", "og_t", "stacked_og"])
def test_sort_route_reads_the_scores_through_their_strides(monkeypatch,
                                                           view):
    """The wrapper hands the kernel element strides that address score
    (layer, item, group) in place: no transposing copy of og. A stand-in
    for the launch reads the storage through them and emulates the
    kernel; its answer is ``ref_assign``'s."""
    base = torch.from_numpy(_scores((3 * 40 * 4 + 7,), seed=9))
    body = base[7:]
    scores, axis = {
        "ig": (body.view(3, 40, 4)[1], 1),
        "og": (body.view(3, 4, 40)[2], 0),
        "og_t": (body.view(3, 4, 40)[0].T, 1),      # (40, 4), strided
        "stacked_og": (body.view(3, 4, 40), 0)}[view]
    seen = {}

    def launch(device, scores_ptr, ids_ptr, group_ptr, l, m, g, cap,
               s_layer, s_item, s_group):
        offset = (scores_ptr - base.data_ptr()) // base.element_size()
        seen["flat"] = torch.as_strided(base, (l, m, g),
                                        (s_layer, s_item, s_group), offset)
        seen["cap"] = cap

    monkeypatch.setattr(ops, "ASSIGN", launch)
    m, g = scores.shape[-2:] if axis else scores.shape[-2:][::-1]
    ops._assign_sorted(scores, axis, m, g, compute_cap(m, g))
    _, ids, group = _emulate_plan_assign(seen["flat"].numpy())
    want_ids, want_group = ref.ref_assign(scores, axis)
    assert seen["cap"] == compute_cap(m, g)
    np.testing.assert_array_equal(ids, want_ids.numpy())
    np.testing.assert_array_equal(group, want_group.numpy())
