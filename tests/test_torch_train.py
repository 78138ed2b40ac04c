"""The port's LM training slice against the JAX package: the train step
(remat, chunked and flash attention cores, the grouped FLGW backward,
the clip and AdamW) on gemma2-2b's f32 smoke config, the data pipeline
and the launcher. The plan refresh is in test_torch_encoder.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import kernels as jkernels  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.core import encoder as jencoder  # noqa: E402
from repro.core import grouped as jgrouped  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.train import state as jstate_lib  # noqa: E402
from repro.train import step as jstep_lib  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import encoder, grouped  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.train import state as state_lib  # noqa: E402
from repro_torch.train import step as step_lib  # noqa: E402

STEPS, BATCH, SEQ = 3, 2, 32
LR, B1 = 3e-4, 0.9
# q_chunk 16 runs the chunked core in two query chunks, ce_chunk 16 the
# loss in two sequence chunks (SEQ = 32)
CHUNKS = dict(q_chunk=16, ce_chunk=16)
F32_LOSS_RTOL, F32_GNORM_RTOL = 1e-5, 1e-4
# every gradient: 1e-4 relative; 1e-6 absolute for the entries near 0
F32_GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# AdamW normalises each update to about lr per step, so a gradient near 0
# that the two sides round to opposite signs could move its parameter by
# up to 2 lr a step. Outside the reference fault's entries (which do move
# by 6 lr in 3 steps) the gradients agree to ~1e-7 relative and the params
# to ~1.5e-6 after 3 steps; the bound is lr / 15.
PARAM_ATOL = LR / 15
BF16_TOL = dict(rtol=5e-2, atol=5e-2)


def _ste_fault_mask(params):
    """{path: (bool mask of ig, bool mask of og)}: True at ig[..., M-1, :]
    and og[..., :, N-1] of every FLGW layer, the entries whose gradient
    the reference's ``make_plan`` fault (ROADMAP Queue 3) moves."""
    out = {}
    for path, p in grouped.iter_flgw_layers(params):
        ig = np.zeros(p["ig"].shape, bool)
        og = np.zeros(p["og"].shape, bool)
        ig[..., -1, :] = True
        og[..., :, -1] = True
        out[path] = (ig, og)
    return out


def _compare_trees(got, want, params, *, rtol, atol):
    """Every leaf of two numpy param trees within the tolerance, the STE
    entries of the reference fault excluded."""
    fault = _ste_fault_mask(params)
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    want_leaves = jax.tree.leaves(want)
    assert len(flat_got) == len(want_leaves)
    for (kp, a), b in zip(flat_got, want_leaves):
        path = tuple(k.key for k in kp)
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        keep = np.ones(a.shape, bool)
        if path[:-1] in fault and path[-1] in ("ig", "og"):
            keep = ~fault[path[:-1]][0 if path[-1] == "ig" else 1]
        np.testing.assert_allclose(a[keep], b[keep], rtol=rtol, atol=atol,
                                   err_msg="/".join(path))


def _plans_equal_but_the_fault(port_plans, jax_plans):
    """Bitwise equal plans except row_group[..., M-1] and
    col_group[..., N-1]."""
    got = interop.tree_to_numpy(port_plans.plans)
    want = jax.tree.map(np.asarray, jax_plans.plans)
    for (kp, a), b in zip(
            jax.tree_util.tree_flatten_with_path(got)[0],
            jax.tree.leaves(want)):
        field = kp[-1].name if hasattr(kp[-1], "name") else str(kp[-1])
        a = np.asarray(a).astype(np.int64)
        b = np.asarray(b).astype(np.int64)
        if field in ("row_group", "col_group"):
            a, b = a[..., :-1], b[..., :-1]
        np.testing.assert_array_equal(a, b, err_msg=str(kp))


def _configs(flash, dtype="float32"):
    kw = dict(flgw_groups=4, flgw_path="grouped", use_flash=flash)
    jcfg = jregistry.get_smoke_config("gemma2_2b", dtype=getattr(jnp, dtype),
                                      **kw)
    tcfg = registry.get_smoke_config("gemma2_2b", dtype=getattr(torch, dtype),
                                     **kw)
    assert jcfg.remat and tcfg.remat
    return jcfg, tcfg


def _jax_tree(tree):
    """A tree of tensors -> JAX arrays of the same dtypes."""
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    dtype = jnp.bfloat16 if tree.dtype == torch.bfloat16 else None
    return jnp.asarray(interop.tree_to_numpy(tree), dtype)


def _jax_state(state):
    """The port's initial TrainState as the JAX package's (its plans as
    JAX GroupPlans; the step re-encodes them before its forward)."""
    def plan(p):
        if isinstance(p, dict):
            return {k: plan(v) for k, v in p.items()}
        return jgrouped.GroupPlan(*(
            jnp.asarray(t.numpy() if t.dtype == torch.bool
                        else t.numpy().astype(np.int32)) for t in p[:6]))
    params = _jax_tree(state.params)
    return jstate_lib.TrainState(
        params=params, opt=jopt.adamw_init(params),
        step=jnp.zeros((), jnp.int32),
        plans=jencoder.PlanState(plan(state.plans.plans),
                                 jnp.uint32(int(state.plans.sig))))


def _run_both(flash, dtype="float32", steps=STEPS):
    """The same init (the port's, carried over) and batches through both
    train steps. Returns the initial params and per-step records of each
    side."""
    jcfg, tcfg = _configs(flash, dtype)
    state = state_lib.init_state(torch.Generator().manual_seed(0), tcfg)
    jstate = _jax_state(state)
    params0 = interop.tree_to_numpy(state.params)
    jstep = jax.jit(jstep_lib.make_train_step(jcfg, **CHUNKS))
    tstep = step_lib.make_train_step(tcfg, **CHUNKS)
    ds = jpipeline.SyntheticTokens(jcfg.vocab, BATCH, SEQ, seed=0)
    tds = pipeline.SyntheticTokens(tcfg.vocab, BATCH, SEQ, seed=0)
    jrec, trec = [], []
    for i in range(steps):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in ds.batch_at(i).items()})
        state, tm = tstep(state, tds.tensors_at(i))
        jrec.append(dict(metrics=jax.tree.map(float, jm),
                         mu=jax.tree.map(np.asarray, jstate.opt.mu),
                         params=jax.tree.map(np.asarray, jstate.params),
                         plans=jstate.plans))
        trec.append(dict(metrics={k: float(v) for k, v in tm.items()},
                         mu=interop.tree_to_numpy(state.opt.mu),
                         params=interop.tree_to_numpy(state.params),
                         plans=state.plans))
    jrec[-1]["state"] = jstate
    return params0, jrec, trec


@pytest.fixture(scope="module", params=[False, True], ids=["chunked", "flash"])
def f32_runs(request):
    return _run_both(request.param)


def test_step0_loss_and_grad_norm_match_jax(f32_runs):
    _, jrec, trec = f32_runs
    jm, tm = jrec[0]["metrics"], trec[0]["metrics"]
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=F32_LOSS_RTOL)
    np.testing.assert_allclose(tm["ce"], jm["ce"], rtol=F32_LOSS_RTOL)
    np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"],
                               rtol=F32_GNORM_RTOL)
    for j, t in zip(jrec, trec):
        assert np.isfinite(t["metrics"]["loss"])
        np.testing.assert_allclose(t["metrics"]["loss"], j["metrics"]["loss"],
                                   rtol=F32_GRAD_TOL["rtol"])


def test_step0_grads_match_jax(f32_runs):
    """After one AdamW step from zero moments mu = (1 - b1) * the clipped
    gradient, so mu / (1 - b1) compares every gradient leaf."""
    params0, jrec, trec = f32_runs
    grads = jax.tree.map(lambda m: m / (1 - B1), trec[0]["mu"])
    want = jax.tree.map(lambda m: m / (1 - B1), jrec[0]["mu"])
    _compare_trees(grads, want, params0, **F32_GRAD_TOL)


def test_params_after_three_steps_match_jax(f32_runs):
    params0, jrec, trec = f32_runs
    _compare_trees(trec[-1]["params"], jrec[-1]["params"], params0, rtol=0,
                   atol=PARAM_ATOL)


def test_plans_of_every_step_match_jax_but_the_faulty_group(f32_runs):
    _, jrec, trec = f32_runs
    for j, t in zip(jrec, trec):
        assert isinstance(t["plans"], encoder.PlanState)
        _plans_equal_but_the_fault(t["plans"], j["plans"])


def test_train_state_from_numpy_carries_jax_state_after_three_steps(
        f32_runs):
    jstate = f32_runs[1][-1]["state"]
    state = interop.train_state_from_numpy(jax.tree.map(np.asarray, jstate))
    assert int(state.step) == STEPS and int(state.opt.count) == STEPS
    assert state.opt.count.dtype == torch.int32
    for got, want in ((state.params, jstate.params),
                      (state.opt.mu, jstate.opt.mu),
                      (state.opt.nu, jstate.opt.nu)):
        for a, b in zip(jax.tree.leaves(interop.tree_to_numpy(got)),
                        jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert int(state.plans.sig) == int(jstate.plans.sig)
    for a, b in zip(jax.tree.leaves(interop.tree_to_numpy(state.plans.plans)),
                    jax.tree.leaves(jstate.plans.plans)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_bf16_step_matches_jax_reference_impl():
    """bf16 smoke config; JAX under use_reference_impl (XLA's CPU cannot
    run the interpret-mode bf16 x bf16 -> f32 Pallas product, ROADMAP
    Queue 3)."""
    with jkernels.use_reference_impl():
        params0, jrec, trec = _run_both(False, "bfloat16", steps=1)
    jm, tm = jrec[0]["metrics"], trec[0]["metrics"]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(tm[key], jm[key], **BF16_TOL)
    grads = jax.tree.map(lambda m: m / (1 - B1), trec[0]["mu"])
    want = jax.tree.map(lambda m: m / (1 - B1), jrec[0]["mu"])
    _compare_trees(grads, want, params0, **BF16_TOL)


def test_microbatches_average_float32_grads():
    _, tcfg = _configs(False)
    ds = pipeline.SyntheticTokens(tcfg.vocab, 4, 16, seed=1)
    batch = ds.tensors_at(0)
    runs = []
    for mb in (1, 2):
        state = state_lib.init_state(torch.Generator().manual_seed(0), tcfg)
        step = step_lib.make_train_step(tcfg, microbatches=mb)
        state, m = step(state, batch)
        runs.append((state, m))
    (s1, m1), (s2, m2) = runs
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]),
                               rtol=1e-4)
    assert int(s2.step) == 1 and s2.opt.mu["embed"]["embedding"].dtype \
        == torch.float32


def test_remat_changes_no_number():
    _, tcfg = _configs(True)
    batch = pipeline.SyntheticTokens(tcfg.vocab, 2, 16, seed=2).tensors_at(0)
    state = state_lib.init_state(torch.Generator().manual_seed(0), tcfg)
    out = []
    for remat in (True, False):
        loss, _, grads = step_lib.loss_and_grads(
            state.params, batch, tcfg.with_updates(remat=remat), q_chunk=16,
            plans=state.plans)
        out.append((loss, grads))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(*(jax.tree.leaves(interop.tree_to_numpy(g))
                      for _, g in out)):
        np.testing.assert_array_equal(a, b)


def test_synthetic_tokens_are_bitwise_the_jax_batches():
    j = jpipeline.SyntheticTokens(512, 3, 20, seed=7)
    t = pipeline.SyntheticTokens(512, 3, 20, seed=7)
    it = pipeline.make_batch_iterator(t, start_step=2, prefetch=2)
    for step in (2, 3, 4):
        want = j.batch_at(step)
        got = next(it)
        for k, v in t.batch_at(step).items():
            np.testing.assert_array_equal(v, want[k])
            assert got[k].dtype == torch.int64
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    it.close()
    np.testing.assert_array_equal(t.batch_at(0, 1, 3)["tokens"],
                                  j.batch_at(0, 1, 3)["tokens"])


def test_train_lm_runs_on_the_cpu_and_logs(capsys):
    state, history = launch.train_lm(
        "gemma2_2b", steps=2, batch=2, seq=16, flgw_groups=4,
        flgw_path="grouped", log_every=1, device="cpu")
    out = capsys.readouterr().out
    assert "step 2: loss=" in out and "steps 0->2" in out
    assert len(history) == 2 and int(state.step) == 2
    for h in history:
        assert np.isfinite(float(h["loss"])) and h["step_s"] > 0
    assert isinstance(state.plans, encoder.PlanState)


def test_train_lm_refuses_what_is_not_ported():
    """Every LM architecture of the JAX package is ported; the launcher
    refuses whisper-large-v3 all the same, before it allocates a state:
    its token batches carry no frames, and the reference's launcher then
    trains a cross layer that sees the future (ROADMAP Queue 3). An
    unknown architecture refuses too."""
    with pytest.raises(ValueError, match="no frames"):
        launch.train_lm("whisper_large_v3", steps=1, device="cpu")
    with pytest.raises(ValueError, match="attention.py:103-112"):
        launch.main(["--arch", "whisper_large_v3", "--device", "cpu"])
    with pytest.raises(KeyError, match="unknown"):
        launch.train_lm("llama3_8b", steps=1, device="cpu")
    with pytest.raises(SystemExit):
        launch.main(["--arch", "llama3_8b", "--device", "cpu"])
