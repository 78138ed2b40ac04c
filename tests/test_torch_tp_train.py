"""Tensor-parallel training of the compact products: model ranks that hold
the same rows split each tile's capN columns in the forward and the
backward, against ``jax.vjp`` of the JAX package's ``grouped_apply``.

Two gloo ranks on the CPU, spawned once by a module fixture, form a
``(1, 2)`` mesh whose model ranks share their rows. Each runs
``grouped_apply`` forward and backward in f32 under
``partition.use_constraints`` on a 2-D plan (gather and fused paths) and
a stacked-expert plan (E = 2); the products run through the plain
``ref_grouped_bmm``. The mesh's gradient reduction (every rank's sum
over the ranks, times 1 / the ranks, as ``collectives.gather_shards``
weighs it) must give JAX's gradients and those of the same rows on one
rank without a group: a split gradient counts once.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite's workers share the host's cores
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import torch.distributed as dist  # noqa: E402
from repro.core import flgw as jflgw  # noqa: E402
from repro.core import grouped as jgrouped  # noqa: E402
from repro_torch.core import flgw, grouped  # noqa: E402
from repro_torch.kernels.flgw_matmul import ops as kops  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.sharding import collectives, partition  # noqa: E402

# test_torch_grouped_grad.py's f32 tolerances
TOL = dict(rtol=1e-5, atol=1e-6)
NAMES = ("y", "dx", "dw", "dig", "dog")
G, SLACK = 4, 1.25
# (name, experts (0: a 2-D plan), B, M, N, compact weights attached);
# capN = ceil(N / G * 1.25) = 40 and 20, both even
CASES = (("2d_gather", 0, 6, 30, 128, False),
         ("2d_fused", 0, 6, 30, 128, True),
         ("experts", 2, 5, 32, 64, False))
RANK_TIMEOUT_S = 90


def _inputs(seed, e, b, m, n):
    rng = np.random.default_rng(seed)
    lead = (e,) if e else ()

    def f(*s):
        return rng.standard_normal(s).astype(np.float32)
    x = f(*lead, b, m)
    w = (f(*lead, m, n) / np.sqrt(m)).astype(np.float32)
    return x, w, f(*lead, m, G), f(*lead, G, n), f(*lead, b, n)


def _plan(ig, og, w, fused):
    plan = grouped.make_plan(torch.from_numpy(ig), torch.from_numpy(og),
                             SLACK)
    if fused:
        plan = plan._replace(wc=kops.compact_weights(
            torch.from_numpy(w), plan.row_ids, plan.col_ids, plan.row_valid,
            plan.col_valid))
    return plan


def _apply(case, widths):
    """(y, dx, dW, dIG, dOG) of one case on this process, the collectives
    its forward and its backward counted, and the widths its compact
    products took (``widths``, appended by the recording product)."""
    name, e, b, m, n, fused = case
    x, w, ig, og, gy = _inputs(len(name) + b + m + n, e, b, m, n)
    plan = _plan(ig, og, w, fused)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, ig, og)]
    cfg = flgw.FLGWConfig(groups=G, path="grouped")
    del widths[:]
    collectives.clear()
    y = grouped.grouped_apply(*leaves, cfg, plan=plan)
    fwd = dict(collectives.CALLS), dict(collectives.BYTES)
    collectives.clear()
    y.backward(torch.from_numpy(gy))
    bwd = dict(collectives.CALLS), dict(collectives.BYTES)
    grads = [y.detach()] + [t.grad for t in leaves]
    return dict(grads=[t.numpy() for t in grads], fwd=fwd, bwd=bwd,
                widths=list(widths), cap=(plan.row_ids.shape[-1],
                                          plan.col_ids.shape[-1]))


def _record_widths(widths):
    """Make every compact product (``grouped_bmm``, ``fused_bmm``) append
    its compact tiles' width to ``widths``."""
    for name in ("grouped_bmm", "fused_bmm"):
        real = getattr(kops, name)

        def recording(x, wc, *rest, real=real):
            widths.append(wc.shape[-1])
            return real(x, wc, *rest)
        setattr(kops, name, recording)


def _rank():
    """One rank of the (1, 2) mesh: each case split (rows shared), and
    under a step whose rows spread over ``model`` (the guard)."""
    mesh = mesh_lib.make_mesh_from_devices(model=2)
    data, model = partition.mesh_groups(mesh)
    widths = []
    _record_widths(widths)
    out = {"rank": dist.get_rank()}
    with partition.use_constraints(mesh):
        with collectives.rows_over([data]):     # the model ranks share rows
            out["shared_group"] = partition.constraint_group(
                "flgw_cap", 40) is model
            out["split"] = {c[0]: _apply(c, widths) for c in CASES}
        with collectives.rows_over([data, model]):  # rows spread over model
            out["spread_group"] = partition.constraint_group("flgw_cap", 40)
            out["spread"] = {c[0]: _apply(c, widths) for c in CASES}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_train")
    ranks = mesh_lib.spawn(_rank, 2, backend="gloo",
                           init_file=str(d / "rdv"),
                           timeout_s=RANK_TIMEOUT_S, torch_threads=1)
    widths, real = [], (kops.grouped_bmm, kops.fused_bmm)
    _record_widths(widths)
    try:
        one = {c[0]: _apply(c, widths) for c in CASES}     # no group
    finally:
        kops.grouped_bmm, kops.fused_bmm = real
    return ranks, one


def _jax(case, plan):
    """y and the VJP of JAX's ``grouped_apply`` on the port's plan carried
    across (int32 ids and groups), so that no STE entry moves."""
    name, e, b, m, n, fused = case
    x, w, ig, og, gy = _inputs(len(name) + b + m + n, e, b, m, n)
    jplan = jgrouped.GroupPlan(*(
        jnp.asarray(t.numpy() if t.dtype == torch.bool
                    else t.numpy().astype(np.int32)) for t in plan[:6]))
    cfg = jflgw.FLGWConfig(groups=G, path="grouped")

    def f(x, w, ig, og, p):
        return jgrouped.grouped_apply(x, w, ig, og, cfg, plan=p)
    if e:
        f = jax.vmap(f)
    y, vjp = jax.vjp(lambda *a: f(*a, jplan),
                     *(jnp.asarray(a) for a in (x, w, ig, og)))
    return [np.asarray(y)] + [np.asarray(a) for a in vjp(jnp.asarray(gy))]


def _reduced(ranks, key, name):
    """The mesh's reduction of each output over the ranks: y and dx as
    rank 0 holds them, each gradient of a weight the ranks' sum times
    1 / the ranks (``collectives.gather_shards``)."""
    per = [r[key][name]["grads"] for r in ranks]
    return [per[0][0], per[0][1]] + [sum(p[i] for p in per) / len(per)
                                     for i in range(2, 5)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_split_step_gives_jax_gradients_on_every_rank(runs, case):
    ranks, _ = runs
    name, e, b, m, n, fused = case
    x, w, ig, og, _ = _inputs(len(name) + b + m + n, e, b, m, n)
    want = _jax(case, _plan(ig, og, w, fused))
    for r in ranks:
        got = r["split"][name]["grads"]
        # y, dx and dIG are whole on every rank
        for i in (0, 1, 3):
            np.testing.assert_allclose(got[i], want[i], err_msg=NAMES[i],
                                       **TOL)
    for i, (a, b_) in enumerate(zip(_reduced(ranks, "split", name), want)):
        np.testing.assert_allclose(a, b_, err_msg=NAMES[i], **TOL)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_split_gradients_count_once(runs, case):
    """The mesh's reduction of the split gradients is the one-rank run's
    without a group, not m times or 1/m times it; each rank's dW holds
    its own columns of every tile only."""
    ranks, one = runs
    name = case[0]
    want = one[name]["grads"]
    for i, (a, b_) in enumerate(zip(_reduced(ranks, "split", name), want)):
        np.testing.assert_allclose(a, b_, err_msg=NAMES[i], **TOL)
    dws = [r["split"][name]["grads"][2] for r in ranks]
    assert not np.any((dws[0] != 0) & (dws[1] != 0))
    assert np.all((dws[0] != 0) | (dws[1] != 0) | (want[2] == 0))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_each_rank_computes_its_columns_in_one_launch_and_collective(
        runs, case):
    """Each rank's forward (and only it: the backward's products are
    ``torch.bmm``) is one compact product (``grouped_bmm`` or, on attached
    compact weights, ``fused_bmm``) of capN/2 columns; it counts one
    all-gather of the outputs in the forward and one float32 all-reduce
    (dX's partial sums and the per-row STE sums) in the backward."""
    ranks, one = runs
    name, e, b, m, n, fused = case
    tiles = max(e, 1) * G
    for r in ranks:
        run = r["split"][name]
        cap_m, cap_n = run["cap"]
        assert run["widths"] == [cap_n // 2]
        assert run["fwd"] == ({("all_gather", "gloo"): 1},
                              {("all_gather", "gloo"): 4 * tiles * b * cap_n})
        assert run["bwd"] == ({("all_reduce", "gloo"): 1},
                              {("all_reduce", "gloo"):
                               4 * tiles * cap_m * (b + 1)})
    assert one[name]["widths"] == [one[name]["cap"][1]]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_ranks_of_distinct_rows_do_not_split(runs, case):
    """Under a step that spreads its rows over ``model`` the constraint
    group is None: whole tiles, no collective, the one-rank run's
    outputs and gradients."""
    ranks, one = runs
    name = case[0]
    for r in ranks:
        assert r["shared_group"] and r["spread_group"] is None
        run = r["spread"][name]
        assert run["fwd"] == ({}, {}) and run["bwd"] == ({}, {})
        assert run["widths"] == one[name]["widths"]
        for i, (a, b_) in enumerate(zip(run["grads"], one[name]["grads"])):
            np.testing.assert_array_equal(a, b_, err_msg=NAMES[i])
