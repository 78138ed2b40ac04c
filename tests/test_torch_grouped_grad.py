"""The port's FLGW backward (the grouped autograd Function and the masked
path's straight-through estimator) against ``jax.vjp`` of the JAX
package's ``grouped_apply`` and ``flgw_linear``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite's workers share the host's cores

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.core import flgw as jflgw  # noqa: E402
from repro.core import grouped as jgrouped  # noqa: E402
from repro_torch.core import flgw, grouped  # noqa: E402

# f32 on both sides; the compact products sum in another order
TOL = dict(rtol=1e-5, atol=1e-6)
NAMES = ("dx", "dw", "dig", "dog")


def _inputs(seed, m, n, g, transpose, b=6):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = f(b, n if transpose else m)
    w = (f(m, n) / np.sqrt(m)).astype(np.float32)
    gy = f(b, m if transpose else n)
    return x, w, f(m, g), f(g, n), gy


def _jax_plan(plan):
    """The port's GroupPlan as the JAX package's (int32 ids and groups)."""
    return jgrouped.GroupPlan(*(
        jnp.asarray(t.numpy() if t.dtype == torch.bool
                    else t.numpy().astype(np.int32)) for t in plan[:6]))


def _jax_grads(x, w, ig, og, gy, cfg, transpose, plan):
    def f(x, w, ig, og):
        return jgrouped.grouped_apply(x, w, ig, og, cfg, transpose=transpose,
                                      plan=plan)
    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, w, ig, og)))
    return [np.asarray(a) for a in vjp(jnp.asarray(gy))]


def _torch_grads(x, w, ig, og, gy, cfg, transpose, plan):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, ig, og)]
    y = grouped.grouped_apply(*leaves, cfg, transpose=transpose, plan=plan)
    y.backward(torch.from_numpy(gy))
    return [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("m,n", [(30, 128), (128, 512), (64, 128)])
def test_grouped_backward_matches_jax_vjp_on_one_plan(m, n, g, transpose):
    x, w, ig, og, gy = _inputs(m + n + g, m, n, g, transpose)
    plan = grouped.make_plan(torch.from_numpy(ig), torch.from_numpy(og), 1.25)
    jcfg = jflgw.FLGWConfig(groups=g, path="grouped")
    tcfg = flgw.FLGWConfig(groups=g, path="grouped")
    want = _jax_grads(x, w, ig, og, gy, jcfg, transpose, _jax_plan(plan))
    got = _torch_grads(x, w, ig, og, gy, tcfg, transpose, plan)
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("m,n,g", [(30, 128, 4), (64, 128, 2)])
def test_jax_own_plan_moves_only_the_last_row_and_column_of_the_ste(
        m, n, g, transpose):
    """JAX's ``make_plan`` gives item M-1 (and N-1) a padding slot's group
    (ROADMAP Queue 3); its backward reads that group, so on its own plan
    dIG may differ in row M-1 and dOG in column N-1, and nowhere else."""
    x, w, ig, og, gy = _inputs(7 * m + g, m, n, g, transpose)
    jcfg = jflgw.FLGWConfig(groups=g, path="grouped")
    jplan = jgrouped.make_plan(jnp.asarray(ig), jnp.asarray(og), 1.25)
    plan = grouped.make_plan(torch.from_numpy(ig), torch.from_numpy(og), 1.25)
    want = _jax_grads(x, w, ig, og, gy, jcfg, transpose, jplan)
    got = _torch_grads(x, w, ig, og, gy, flgw.FLGWConfig(groups=g,
                                                         path="grouped"),
                       transpose, plan)
    dx, dw, dig, dog = got
    np.testing.assert_allclose(dx, want[0], **TOL)
    np.testing.assert_allclose(dw, want[1], **TOL)
    np.testing.assert_allclose(dig[:-1], want[2][:-1], **TOL)
    np.testing.assert_allclose(dog[:, :-1], want[3][:, :-1], **TOL)
    # where JAX's group of the last item is right, its row agrees too
    if int(jplan.row_group[m - 1]) == int(plan.row_group[m - 1]):
        np.testing.assert_allclose(dig[-1], want[2][-1], **TOL)
    if int(jplan.col_group[n - 1]) == int(plan.col_group[n - 1]):
        np.testing.assert_allclose(dog[:, -1], want[3][:, -1], **TOL)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_masked_ste_grads_match_jax(transpose, temperature):
    m, n, g = 32, 48, 4
    x, w, ig, og, gy = _inputs(11, m, n, g, transpose)
    jcfg = jflgw.FLGWConfig(groups=g, path="masked",
                            ste_temperature=temperature)

    def f(x, w, ig, og):
        return jflgw.flgw_linear(x, w, ig, og, jcfg, transpose=transpose)
    y_j, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, w, ig, og)))
    want = [np.asarray(a) for a in vjp(jnp.asarray(gy))]
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, ig, og)]
    tcfg = flgw.FLGWConfig(groups=g, path="masked",
                           ste_temperature=temperature)
    y = flgw.flgw_linear(*leaves, tcfg, transpose=transpose)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               rtol=1e-5, atol=1e-5)
    y.backward(torch.from_numpy(gy))
    for name, t, b in zip(NAMES, leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), b, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_selection_matrices_are_hard_forward_soft_backward():
    rng = np.random.default_rng(3)
    ig = torch.from_numpy(rng.standard_normal((10, 4)).astype(np.float32))
    og = torch.from_numpy(rng.standard_normal((4, 9)).astype(np.float32))
    mask = flgw.mask_ste(ig, og)
    want = flgw.mask_from_indices(*flgw.grouping_indices(ig, og))
    np.testing.assert_allclose(mask.numpy(), want.numpy(), atol=1e-6)
    ig.requires_grad_()
    flgw.mask_ste(ig, og, 0.5).sum().backward()
    assert torch.isfinite(ig.grad).all() and ig.grad.abs().sum() > 0


def test_grouped_backward_runs_with_compact_weights_attached():
    """A plan carrying ``wc`` takes the fused forward; its backward reads
    ``wc`` in place of a fresh gather of W and gives the same grads."""
    x, w, ig, og, gy = _inputs(5, 64, 128, 4, False)
    plan = grouped.make_plan(torch.from_numpy(ig), torch.from_numpy(og), 1.25)
    params = {"l": {"w": torch.from_numpy(w), "ig": torch.from_numpy(ig),
                    "og": torch.from_numpy(og)}}
    attached = grouped.attach_compact({"l": plan}, params)["l"]
    cfg = flgw.FLGWConfig(groups=4, path="grouped")
    bare = _torch_grads(x, w, ig, og, gy, cfg, False, plan)
    fused = _torch_grads(x, w, ig, og, gy, cfg, False, attached)
    for name, a, b in zip(NAMES, fused, bare):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)
