"""The port's checkpoint store, fault runner and plans-aware restore
against the JAX package: ``tests/test_substrate.py``'s checkpoint and
retry cases and ``tests/test_restore.py``'s cases on the port,
checkpoints crossing between the packages both ways (the checked-in
pre-plans fixture among them), and the port's own contracts (a failed
restore writes nothing, an in-place step is never retried, a SIGTERM
stops the runner and the launcher at a step boundary)."""
import importlib.util
import json
import os
import pathlib
import signal
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite's workers share the host's cores

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro import checkpoint as jckpt  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.train import state as jstate_lib  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.core import encoder  # noqa: E402
from repro_torch.core.flgw import FLGWConfig  # noqa: E402
from repro_torch.core.schedule import SparsitySchedule  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokens  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.runtime import fault  # noqa: E402
from repro_torch.train import state as state_lib  # noqa: E402
from repro_torch.train import step as step_lib  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
_FIX = ROOT / "tests" / "fixtures" / "prepr3_ckpt.py"
_spec = importlib.util.spec_from_file_location("prepr3_ckpt", _FIX)
prepr3 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(prepr3)

FL = FLGWConfig(groups=4, path="grouped")
LAUNCH_TIMEOUT_S = 180


def tiny_cfg(**kw) -> ModelConfig:
    """``prepr3_ckpt.tiny_cfg``, the grouped config the fixture was saved
    from, as the port's config."""
    return ModelConfig(
        name="prepr3_fixture", family="dense", n_layers=2, d_model=32,
        n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64, vocab=64,
        flgw_groups=4, flgw_path="grouped", flgw_targets=("mlp", "attn"),
        dtype=torch.float32, remat=False).with_updates(**kw)


def init_state(seed=prepr3.SEED, cfg=None, optimizer="rmsprop"):
    return state_lib.init_state(torch.Generator().manual_seed(seed),
                                cfg or tiny_cfg(), optimizer=optimizer)


def _leaves(tree):
    return [leaf for _, leaf in store.tree_paths(tree)]


def _snapshot(tree):
    return [leaf.clone() for leaf in _leaves(tree)]


def _tree_equal(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(la, lb))


def _batch(cfg, step, b=2, s=16):
    return SyntheticTokens(cfg.vocab, b, s, seed=99).tensors_at(step)


def _map_plans(fn, plans):
    if isinstance(plans, dict):
        return {k: _map_plans(fn, v) for k, v in plans.items()}
    return type(plans)(*(None if f is None else fn(f) for f in plans))


def _jax_paths(tree) -> list:
    return [jax.tree_util.keystr(kp)
            for kp, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _no_signals():
    return fault.PreemptionGuard(signals=())


# ---------------------------------------------------------------------------
# The store (test_substrate.py's checkpoint cases)
# ---------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16),
                  "d": torch.zeros((), dtype=torch.int32)}}


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    ckpt.save_checkpoint(tmp_path, 7, t)
    target = {"a": torch.zeros(2, 3), "b": {
        "c": torch.zeros(4, dtype=torch.bfloat16),
        "d": torch.full((), 5, dtype=torch.int32)}}
    got, step = ckpt.restore_checkpoint(tmp_path, target)
    assert step == 7
    assert got is target
    assert _tree_equal(got, t)


def test_checkpoint_keeps_latest_and_gc(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        ckpt.save_checkpoint(tmp_path, s, t, keep=2)
    assert ckpt.latest_step(tmp_path) == 5
    assert ckpt.list_steps(tmp_path) == [4, 5]


def test_checkpoint_ignores_partial_tmp(tmp_path):
    t = _tree()
    ckpt.save_checkpoint(tmp_path, 1, t)
    bad = tmp_path / "step_00000002.tmp-999-1"
    bad.mkdir()
    (bad / "arr_000000.npy").write_bytes(b"partial")
    assert ckpt.latest_step(tmp_path) == 1
    _, step = ckpt.restore_checkpoint(tmp_path, _tree())
    assert step == 1


def _corrupt_last_leaf(path):
    f = sorted(pathlib.Path(path).glob("arr_*.npy"))[-1]
    raw = bytearray(f.read_bytes())
    raw[-1] ^= 0xFF
    f.write_bytes(bytes(raw))


def test_checkpoint_detects_corruption(tmp_path):
    t = _tree()
    _corrupt_last_leaf(ckpt.save_checkpoint(tmp_path, 3, t))
    with pytest.raises(IOError, match="corruption"):
        ckpt.restore_checkpoint(tmp_path, t)


def test_leaf_paths_are_jax_keystr_in_jax_flatten_order():
    """Nested dicts (unsorted insertion), NamedTuples, tuples, lists,
    None and empty containers: the port's paths are JAX's, one for one."""
    port = {"z": (torch.zeros(1), [torch.zeros(2), None]), "a": (),
            "m": state_lib.TrainState(params={"y": torch.zeros(1),
                                              "b": torch.zeros(1)},
                                      opt={}, step=torch.zeros(()),
                                      plans=())}
    ref = {"z": (np.zeros(1), [np.zeros(2), None]), "a": (),
           "m": jstate_lib.TrainState(params={"y": np.zeros(1),
                                              "b": np.zeros(1)},
                                      opt={}, step=np.zeros(()), plans=())}
    assert [p for p, _ in store.tree_paths(port)] == _jax_paths(ref)


# ---------------------------------------------------------------------------
# Retry and the runner (test_substrate.py's runtime cases, and the port's
# in-place steps)
# ---------------------------------------------------------------------------

def test_retry_transient_retries_then_succeeds():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("DEADLINE_EXCEEDED: collective timed out")
        return 42

    assert fault.retry_transient(flaky, retries=5, backoff_s=0.0) == 42
    assert calls["n"] == 3


def test_retry_transient_raises_on_permanent():
    def broken():
        raise ValueError("shape mismatch")

    with pytest.raises(ValueError):
        fault.retry_transient(broken, retries=3, backoff_s=0.0)


def test_state_mutating_step_is_never_retried(tmp_path, monkeypatch):
    """A step that wrote its state in place and then failed with a
    transient-looking error propagates it (one attempt, no save); a step
    that leaves its input alone is retried. The port's train step is
    marked as the first kind."""
    calls = {"n": 0}

    def in_place(state, batch):
        calls["n"] += 1
        state["w"].add_(1.0)                      # half-written update
        if calls["n"] == 1:
            raise RuntimeError("UNAVAILABLE: connection reset")
        return state, {"loss": state["w"].sum()}

    in_place.mutates_state = True
    runner = fault.StepRunner(in_place, tmp_path, save_every=1,
                              guard=_no_signals())
    state = {"w": torch.zeros(3)}
    with pytest.raises(RuntimeError, match="UNAVAILABLE"):
        runner.run(state, iter([{}] * 3))
    assert calls["n"] == 1
    assert ckpt.latest_step(tmp_path) is None

    calls["n"] = 0

    def functional(state, batch):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("UNAVAILABLE: connection reset")
        return {"w": state["w"] + 1.0}, {"loss": state["w"].sum()}

    functional_runner = fault.StepRunner(functional, tmp_path / "f",
                                         save_every=1, guard=_no_signals())
    monkeypatch.setattr(fault.time, "sleep", lambda s: None)   # backoff
    state, end, _ = functional_runner.run({"w": torch.zeros(3)},
                                          iter([{}] * 2), max_steps=2)
    assert (end, calls["n"]) == (2, 3)
    assert torch.equal(state["w"], torch.full((3,), 2.0))
    assert step_lib.make_train_step(tiny_cfg()).mutates_state is True


def test_runner_stops_at_the_sigterm_boundary_and_resumes_bitwise(tmp_path):
    """A real SIGTERM inside step 3 of a grouped on_change run: the
    runner saves step 3 and stops, the handler in place before the guard
    comes back, and a fresh state restored through ``restore_state`` and
    stepped once writes a step-4 checkpoint identical, hash for hash, to
    the uninterrupted run's."""
    cfg = tiny_cfg()
    sched = SparsitySchedule(groups=4, refresh_every=2, refresh="on_change")
    train_step = step_lib.make_train_step(cfg, optimizer="rmsprop", lr=1e-2,
                                          schedule=sched)
    batches = (lambda start: (_batch(cfg, t) for t in range(start, 99)))

    def run(d, state, *, start=0, save_every, step_fn=train_step):
        runner = fault.StepRunner(step_fn, d, save_every=save_every)
        try:
            state, start = runner.restore_or(
                state, restore_fn=lambda s, sh: state_lib.restore_state(
                    d, s, cfg, shardings=sh))
            return runner.run(state, batches(start), start_step=start,
                              max_steps=4)
        finally:
            runner.guard.restore()

    before = signal.getsignal(signal.SIGTERM)
    run(tmp_path / "a", init_state(), save_every=4)

    def preempted(state, batch):
        if int(state.step) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return train_step(state, batch)

    preempted.mutates_state = True
    _, end, hist = run(tmp_path / "b", init_state(), save_every=2,
                       step_fn=preempted)
    assert (end, len(hist)) == (3, 3)
    assert ckpt.list_steps(tmp_path / "b") == [2, 3]
    assert signal.getsignal(signal.SIGTERM) is before

    _, end, hist = run(tmp_path / "b", init_state(seed=1), save_every=2)
    assert (end, len(hist)) == (4, 1)
    assert store.read_manifest(tmp_path / "a", step=4) == \
        store.read_manifest(tmp_path / "b", step=4)


def test_train_lm_resumes_and_gives_back_the_signal_handlers(tmp_path):
    """``train_lm`` with ``ckpt_dir`` saves, resumes from the latest step,
    and leaves SIGTERM's and SIGINT's handlers as it found them."""
    from repro_torch.launch import train as launch
    before = [signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)]
    kw = dict(steps=2, batch=2, seq=16, ckpt_dir=str(tmp_path),
              save_every=1, log_every=0, device="cpu")
    _, hist = launch.train_lm("gemma2_2b", **kw)
    assert len(hist) == 2 and all(h["step_s"] > 0 for h in hist)
    _, hist = launch.train_lm("gemma2_2b", **dict(kw, steps=3))
    assert len(hist) == 1
    assert ckpt.list_steps(tmp_path) == [1, 2, 3]
    assert [signal.getsignal(s)
            for s in (signal.SIGTERM, signal.SIGINT)] == before


def test_launcher_takes_sigterm_and_resumes(tmp_path):
    """``python -m repro_torch.launch.train --ckpt-dir``: SIGTERM once
    step 2 is logged lands inside step 3; the launcher saves step 3 and
    exits 0, and the same command resumes at 3."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "gemma2_2b", "--device", "cpu", "--ckpt-dir", str(tmp_path),
           "--save-every", "2", "--steps", "6", "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        for line in proc.stdout:
            if line.startswith("step 2:"):
                proc.send_signal(signal.SIGTERM)
                break
        out, err = proc.communicate(timeout=LAUNCH_TIMEOUT_S)
    finally:
        proc.kill()
    assert proc.returncode == 0, err
    assert "steps 0->3" in out
    assert ckpt.list_steps(tmp_path) == [2, 3]
    again = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=LAUNCH_TIMEOUT_S)
    assert again.returncode == 0, again.stderr
    assert "steps 3->6" in again.stdout
    assert ckpt.list_steps(tmp_path) == [3, 4, 6]


# ---------------------------------------------------------------------------
# A failed restore writes nothing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fault_kind", ["missing", "corrupt", "shape"])
def test_failed_restore_leaves_the_target_untouched(tmp_path, fault_kind):
    """A leaf missing under ``strict``, a hash mismatch in the last leaf
    and a leaf of another shape each raise before any target tensor is
    written, though every earlier leaf was readable."""
    saved = init_state()
    target = init_state(seed=1)
    if fault_kind == "missing":
        ckpt.save_checkpoint(tmp_path, 2, saved._replace(plans=()))
        raises = pytest.raises(KeyError, match="restore_state")
    elif fault_kind == "corrupt":
        _corrupt_last_leaf(ckpt.save_checkpoint(tmp_path, 2, saved))
        raises = pytest.raises(IOError, match=r"corruption at \.plans\.sig")
    else:
        ckpt.save_checkpoint(tmp_path, 2, saved._replace(plans=()))
        target = target._replace(plans=(),
                                 step=torch.zeros(1, dtype=torch.int32))
        raises = pytest.raises(ValueError, match=r"\.step")
    before = _snapshot(target)
    with raises:
        ckpt.restore_checkpoint(tmp_path, target)
    assert all(torch.equal(a, b) for a, b in zip(before, _leaves(target)))


# ---------------------------------------------------------------------------
# The plans-aware restore (test_restore.py's cases on the port)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_fixture_restore():
    """JAX's ``restore_state`` of the checked-in fixture, and the JAX
    target's tree."""
    target = prepr3.init_fixture_state()
    restored, step = jstate_lib.restore_state(prepr3.FIXTURE_DIR, target,
                                              prepr3.tiny_cfg())
    return target, restored, step


def _plans_equal_but_the_fault(port_plans, jax_plans):
    """Bitwise equal plans but ``row_group[..., M-1]`` and
    ``col_group[..., N-1]``, which the reference's ``make_plan`` fault
    (ROADMAP Queue 3) writes wrong; ids int64 in the port, int32 in JAX."""
    got = store.tree_paths(port_plans.plans)
    want = jax.tree_util.tree_flatten_with_path(jax_plans.plans)[0]
    assert [p for p, _ in got] == [jax.tree_util.keystr(k) for k, _ in want]
    for (path, a), (_, b) in zip(got, want):
        a, b = a.numpy().astype(np.int64), np.asarray(b).astype(np.int64)
        if path.endswith((".row_group", ".col_group")):
            a, b = a[..., :-1], b[..., :-1]
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_checked_in_pre_plans_fixture_restores_as_in_jax(jax_fixture_restore):
    """The pre-plans grouped fixture restores through the port's
    ``restore_state`` to bitwise the params, moments and step JAX's gives,
    with plans freshly encoded from them (JAX's but the reference
    fault's entries), over the same leaf paths."""
    jtarget, jrestored, jstep = jax_fixture_restore
    cfg = tiny_cfg()
    target = init_state(seed=1)
    assert [p for p, _ in store.tree_paths(target)] == _jax_paths(jtarget)
    restored, step = state_lib.restore_state(prepr3.FIXTURE_DIR, target, cfg)
    assert step == jstep == prepr3.FIXTURE_STEP
    assert not any(".plans" in p
                   for p in ckpt.manifest_paths(prepr3.FIXTURE_DIR))
    assert isinstance(restored.plans, encoder.PlanState)
    assert _tree_equal(restored.plans,
                       encoder.encode_plans(restored.params, FL))
    want = store.tree_paths(jrestored._replace(plans=()))
    got = store.tree_paths(restored._replace(plans=()))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        b = np.asarray(b)
        assert str(a.numpy().dtype) == str(b.dtype), path
        np.testing.assert_array_equal(a.numpy(), b, err_msg=path)
    _plans_equal_but_the_fault(restored.plans, jrestored.plans)


def test_strict_restore_of_pre_plans_manifest_raises_with_guidance():
    with pytest.raises(KeyError, match="restore_state"):
        ckpt.restore_checkpoint(prepr3.FIXTURE_DIR, init_state())


def test_non_strict_restore_keeps_unrecorded_target_leaves():
    target = init_state()
    target = target._replace(step=torch.full((), 42, dtype=torch.int32))
    plans = _snapshot(target.plans)
    got, step = ckpt.restore_checkpoint(prepr3.FIXTURE_DIR, target,
                                        strict=False)
    assert step == prepr3.FIXTURE_STEP
    assert all(torch.equal(a, b) for a, b in zip(plans, _leaves(got.plans)))
    assert int(got.step) == prepr3.FIXTURE_STEP


def test_pre_plans_roundtrip_migrates(tmp_path):
    cfg = tiny_cfg()
    state = init_state()
    ckpt.save_checkpoint(tmp_path, 4, state._replace(plans=()))
    restored, step = state_lib.restore_state(tmp_path, init_state(seed=1),
                                             cfg)
    assert step == 4
    assert _tree_equal(restored.params, state.params)
    assert _tree_equal(restored.plans,
                       encoder.encode_plans(restored.params, FL))


def test_restore_reencodes_stale_checkpointed_plans(tmp_path):
    cfg = tiny_cfg()
    state = init_state()
    poisoned = state._replace(plans=encoder.PlanState(
        _map_plans(torch.zeros_like, state.plans.plans),
        torch.zeros((), dtype=torch.int64)))
    ckpt.save_checkpoint(tmp_path, 6, poisoned)
    restored, _ = state_lib.restore_state(tmp_path, init_state(seed=1), cfg)
    assert _tree_equal(restored.plans,
                       encoder.encode_plans(restored.params, FL))


@pytest.mark.parametrize("refresh", ["on_change", "period"])
def test_post_restore_step_bitwise_matches_uninterrupted(tmp_path, refresh):
    """Checkpoint at step 2, restore into a fresh state, step once: the
    state is bitwise the uninterrupted run's, for change-driven and
    periodic refresh (the restore lands mid-period). The port's step
    consumes its state, so the two runs start from two initial states."""
    cfg = tiny_cfg()
    sched = SparsitySchedule(groups=4, refresh_every=2, refresh=refresh)
    step_fn = step_lib.make_train_step(cfg, optimizer="rmsprop", lr=1e-2,
                                       schedule=sched)
    state = init_state()
    for t in range(2):
        state, _ = step_fn(state, _batch(cfg, t))
    ckpt.save_checkpoint(tmp_path, 2, state)
    cont, _ = step_fn(state, _batch(cfg, 2))           # never interrupted

    restored, start = state_lib.restore_state(tmp_path, init_state(seed=1),
                                              cfg)
    assert start == 2
    resumed, _ = step_fn(restored, _batch(cfg, 2))

    assert _tree_equal(cont.params, resumed.params)
    assert _tree_equal(cont.opt, resumed.opt)
    assert _tree_equal(cont.plans, resumed.plans)
    assert int(cont.step) == int(resumed.step) == 3


# ---------------------------------------------------------------------------
# Checkpoints cross between the packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_bf16_state():
    """A JAX AdamW TrainState with bf16 params, f32 moments and int32
    count and step, after a made-up update (so no leaf is its init)."""
    jcfg = JModelConfig(
        name="cross", family="dense", n_layers=2, d_model=32, n_heads=2,
        n_kv_heads=2, head_dim=16, d_ff=64, vocab=64, dtype=jnp.bfloat16)
    s = jstate_lib.init_state(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(0)
    bump = (lambda x: x + jnp.asarray(rng.standard_normal(x.shape), x.dtype))
    return s._replace(opt=s.opt._replace(mu=jax.tree.map(bump, s.opt.mu),
                                         nu=jax.tree.map(bump, s.opt.nu),
                                         count=jnp.int32(5)),
                      step=jnp.int32(5))


def _port_target():
    cfg = tiny_cfg(flgw_groups=1, flgw_path="masked", flgw_targets=("mlp",),
                   dtype=torch.bfloat16, name="cross")
    return init_state(seed=4, cfg=cfg, optimizer="adamw")


def test_jax_checkpoint_restores_in_the_port(tmp_path, jax_bf16_state):
    jckpt.save_checkpoint(tmp_path, 5, jax_bf16_state)
    got, step = ckpt.restore_checkpoint(tmp_path, _port_target())
    want = interop.train_state_from_numpy(
        jax.tree.map(np.asarray, jax_bf16_state))
    assert step == 5
    assert {leaf.dtype for leaf in _leaves(got)} == \
        {torch.bfloat16, torch.float32, torch.int32}
    assert _tree_equal(got, want)


def test_port_checkpoint_manifest_is_jax_s(tmp_path, jax_bf16_state):
    jckpt.save_checkpoint(tmp_path / "jax", 5, jax_bf16_state)
    state = interop.train_state_from_numpy(
        jax.tree.map(np.asarray, jax_bf16_state))
    ckpt.save_checkpoint(tmp_path / "port", 5, state)
    read = (lambda d: json.loads(
        (tmp_path / d / "step_00000005" / "manifest.json").read_text()))
    assert read("port") == read("jax")
    assert {e["dtype"] for e in read("port")["leaves"]} == \
        {"bfloat16", "float32", "int32"}


def test_port_checkpoint_restores_in_jax(tmp_path, jax_bf16_state):
    state = interop.train_state_from_numpy(
        jax.tree.map(np.asarray, jax_bf16_state))
    ckpt.save_checkpoint(tmp_path, 5, state)
    target = jax.tree.map(jnp.zeros_like, jax_bf16_state)
    got, step = jckpt.restore_checkpoint(tmp_path, target)
    assert step == 5
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jax_bf16_state)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
