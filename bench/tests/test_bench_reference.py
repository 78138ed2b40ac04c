"""Each plain reference against the port's CPU path at small sizes, the
run's comparison with the timed path broken underneath (each fault must
read not correct), and the lower-precision control against sound runs.
"""
import importlib.util

import pytest
import torch

from bench_small import BENCH, SEED, run_small, small
import repro_torch.marl.train as marl_train  # noqa: E402  (after bench_small)
import repro_torch.train.step as lm_step  # noqa: E402

IC3 = ("ic3net_pp_medium.learn_g4", "ic3net_pp_medium.learn_dense")
LM = ("mixtral_8x22b_l1.train_g4", "mixtral_8x22b_l1.train_dense")


@pytest.mark.parametrize("workload", IC3)
def test_the_ic3net_reference_follows_the_port_on_the_cpu(workload):
    # float32 on both sides: plain products against the port's plain
    # kernels, to rounding; every decision the reference's own
    line = run_small(workload)
    got = {k: v["value"] for k, v in line["compared"].items()}
    assert line["correct"] is True
    assert got["action_gap"] == 0.0 and got["gate_gap"] == 0.0
    assert max(got.values()) < 1e-5, got


@pytest.mark.parametrize("workload", LM)
def test_the_lm_reference_follows_the_port_on_the_cpu(workload):
    # bf16 against float32: the loss to ~1e-4, the worst leaf's norms to
    # a few % (the small widths' weights sit near bf16's resolution for
    # AdamW's steps of 3e-4)
    line = run_small(workload)
    got = {k: v["value"] for k, v in line["compared"].items()}
    got.update(line["detail"]["uncompared"])
    assert got["loss_gap"] < 1e-3 and got["first_loss_gap"] < 1e-3, got
    assert got["grad_gap"] < 0.05, got
    assert got["change_gap"] < 0.15, got


def _no_update(params, grads, state, **kw):
    return params, state


def _halve_a2c(orig):
    def half(rew, logp, val, ent, gate_logp, gates, succ, tcfg, shard=None):
        k = rew.shape[0] // 2
        return orig(rew[:k], logp[:k], val[:k], ent[:k], gate_logp[:k],
                    gates[:k], succ[:k], tcfg, shard)
    return half


def _halve_ce(orig):
    def half(hidden, embedding, targets, **kw):
        k = hidden.shape[0] // 2
        return orig(hidden[:k], embedding, targets[:k], **kw)
    return half


FAULTS = [
    ("ic3net_pp_medium.learn_g4", marl_train, "rmsprop", lambda o: _no_update),
    ("ic3net_pp_medium.learn_g4", marl_train, "a2c_terms", _halve_a2c),
    ("ic3net_pp_medium.learn_dense", marl_train, "rmsprop", lambda o: _no_update),
    ("ic3net_pp_medium.learn_dense", marl_train, "a2c_terms", _halve_a2c),
    ("mixtral_8x22b_l1.train_g4", lm_step, "adamw", lambda o: _no_update),
    ("mixtral_8x22b_l1.train_g4", lm_step, "chunked_cross_entropy",
     _halve_ce),
    ("mixtral_8x22b_l1.train_dense", lm_step, "adamw", lambda o: _no_update),
    ("mixtral_8x22b_l1.train_dense", lm_step, "chunked_cross_entropy",
     _halve_ce),
]


@pytest.mark.parametrize("workload,module,name,fault", FAULTS,
                         ids=[f"{w}-{n}" for w, _, n, _ in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, module,
                                            name, fault):
    # a step that returns its state unchanged; half of the batch left out
    # and the mean taken over the rest
    monkeypatch.setattr(module, name, fault(getattr(module, name)))
    line = run_small(workload, seconds=0.2)
    assert line["correct"] is False, line["compared"]


def _calibrate():
    spec = importlib.util.spec_from_file_location(
        "bench_calibrate", BENCH / "calibrate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("workload", ["ic3net_pp_medium.learn_g4",
                                      "mixtral_8x22b_l1.train_g4"])
def test_the_control_reads_over_three_times_the_sound_runs(workload):
    # the reference in the configuration's lower precision put in the
    # program's place must fail one number that sound runs pass
    cfg, traffic = small(workload)
    got = _calibrate().readings(workload, [SEED, SEED + 1], [SEED + 2],
                                torch.device("cpu"), config=cfg,
                                traffic=traffic)
    lower = {k: max(r[k] for r in got["program"].values())
             for k in ("loss_gap", "first_loss_gap", "grad_gap",
                       "change_gap")}
    control = next(iter(got["control_runs"].values()))
    assert any(control[k] >= 3 * lower[k] for k in lower), (lower, control)
    half = next(iter(got["half_batch"].values()))
    assert any(half[k] >= 10 * lower[k] for k in lower), (lower, half)
