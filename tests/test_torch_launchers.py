"""The port's entry points of the main path: ``core.flgw.init_grouping``,
the ``marl/env.py`` back-compat shim, the sync IC3Net launcher
(``launch/marl_ic3net.py``, over the runs the reference's CI gives
``examples/marl_ic3net.py``) and ``launch/quickstart.py``, on the CPU."""
import functools
import importlib
import os
import socket
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite's workers share the host's cores

from repro_torch.core import flgw  # noqa: E402
from repro_torch.core.schedule import SparsitySchedule  # noqa: E402
from repro_torch.launch import marl_ic3net, quickstart  # noqa: E402
from repro_torch.marl import envs, ic3net, train  # noqa: E402
from repro_torch.marl.envs import predator_prey  # noqa: E402
from repro_torch.models.layers import dense_init  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the reference CI's single-device runs of examples/marl_ic3net.py
CI_ENVS = ("predator_prey", "traffic_junction", "traffic_junction_4way",
           "traffic_junction_hard", "spread")
CI_SMALL = ["--iterations", "5", "--batch", "4", "--hidden", "32",
            "--agents", "3", "--device", "cpu"]
CI_GROUPED = ["--env", "predator_prey", "--path", "grouped", "--groups", "4",
              "--iterations", "6", "--batch", "2", "--hidden", "32",
              "--agents", "2", "--size", "3", "--device", "cpu"]
_METRICS = ("success", "return", "loss", "mask_sparsity")


# ---------------------------------------------------------------------------
# init_grouping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lead", [(), (3,)])
def test_init_grouping_shapes_dtype_device_and_seed(lead):
    g = flgw.init_grouping(torch.Generator().manual_seed(5), 24, 40, 4,
                           lead=lead)
    assert set(g) == {"ig", "og"}
    assert g["ig"].shape == (*lead, 24, 4) and g["og"].shape == (*lead, 4, 40)
    for t in g.values():
        assert t.dtype == torch.float32 and t.device == torch.device("cpu")
    again = flgw.init_grouping(torch.Generator().manual_seed(5), 24, 40, 4,
                               lead=lead)
    assert all(torch.equal(g[k], again[k]) for k in g)
    other = flgw.init_grouping(torch.Generator().manual_seed(6), 24, 40, 4,
                               lead=lead)
    assert not torch.equal(g["ig"], other["ig"])
    # standard-normal draws: IG first, then OG from the same stream
    gen = torch.Generator().manual_seed(5)
    assert torch.equal(g["ig"], torch.randn((*lead, 24, 4), generator=gen))
    assert torch.equal(g["og"], torch.randn((*lead, 4, 40), generator=gen))


def test_init_grouping_draws_standard_normals():
    g = flgw.init_grouping(torch.Generator().manual_seed(0), 512, 512, 8)
    vals = torch.cat([g["ig"].flatten(), g["og"].flatten()])
    assert abs(float(vals.mean())) < 0.05
    assert abs(float(vals.std()) - 1.0) < 0.05
    ig_idx, og_idx = flgw.grouping_indices(g["ig"], g["og"])
    assert abs(float(flgw.mask_sparsity(ig_idx, og_idx, 8)) - 7 / 8) < 0.02


@pytest.mark.parametrize("lead,dtype", [((), torch.float32),
                                        ((2,), torch.bfloat16)])
def test_dense_init_draws_as_before(lead, dtype):
    """``dense_init`` calls ``init_grouping`` and draws w, ig, og in the
    order of the inline draw it replaced, so every fixture and parity
    test keeps its numbers."""
    def inline(gen, m, n, groups):               # the earlier dense_init
        w = torch.randn((*lead, m, n), generator=gen) / m ** 0.5
        return {"w": w.to(dtype),
                "ig": torch.randn((*lead, m, groups), generator=gen),
                "og": torch.randn((*lead, groups, n), generator=gen)}

    got = dense_init(torch.Generator().manual_seed(3), 16, 24,
                     flgw=flgw.FLGWConfig(groups=4), dtype=dtype, lead=lead)
    want = inline(torch.Generator().manual_seed(3), 16, 24, 4)
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    dense = dense_init(torch.Generator().manual_seed(3), 16, 24, lead=lead)
    assert set(dense) == {"w"}


# ---------------------------------------------------------------------------
# marl/env.py
# ---------------------------------------------------------------------------

def test_env_shim_warns_and_reexports_predator_prey():
    sys.modules.pop("repro_torch.marl.env", None)
    with pytest.warns(DeprecationWarning, match="back-compat shim"):
        shim = importlib.import_module("repro_torch.marl.env")
    names = ("_MOVES", "N_ACTIONS", "EnvConfig", "EnvState", "n_actions",
             "obs_dim", "observe", "reset", "step", "success")
    for name in names:
        assert getattr(shim, name) is getattr(predator_prey, name), name
    assert envs.get("predator_prey").step is shim.step


def test_move_table_is_what_step_does():
    cfg = predator_prey.EnvConfig(n_agents=5, size=9)
    state = predator_prey.EnvState(
        pos=torch.full((1, 5, 2), 4), prey=torch.zeros((1, 2),
                                                       dtype=torch.int64),
        arrived=torch.zeros((1, 5), dtype=torch.bool),
        t=torch.zeros(1, dtype=torch.int64))
    nxt, _, _ = predator_prey.step(state, torch.arange(5)[None], cfg)
    assert (nxt.pos[0] - 4).tolist() == [list(m) for m in
                                         predator_prey._MOVES]
    assert len(predator_prey._MOVES) == predator_prey.N_ACTIONS


# ---------------------------------------------------------------------------
# launch/marl_ic3net.py
# ---------------------------------------------------------------------------

def _expect_lines(out: str):
    """The reference's success, throughput and learned-sparsity lines,
    each layer's sparsity near G = 4's 75 %."""
    assert "success: first-" in out and "last-" in out
    assert "throughput:" in out and "iters/s" in out \
        and "env-steps/s" in out and "sparse" in out and "GFLOPS" in out
    assert "learned per-layer sparsity:" in out
    rows = [ln.split() for ln in out.splitlines()
            if ln.startswith("  ") and ln.rstrip().endswith("%")]
    assert [r[0] for r in rows] == ["enc", "lstm_x", "lstm_h", "comm",
                                    "policy"]
    for _, pct in rows:
        assert abs(float(pct[:-1]) - 75.0) < 15


@pytest.mark.parametrize("env", CI_ENVS)
def test_marl_ic3net_runs_each_environment(env, capsys):
    model, hist = marl_ic3net.main(["--env", env, *CI_SMALL])
    out = capsys.readouterr().out
    assert f"IC3Net on {env} A=3 hidden=32 FLGW G=4 (masked)" in out
    assert "device cpu" in out
    _expect_lines(out)
    assert len(hist) == 5 and model.device == torch.device("cpu")
    assert all(np.isfinite(h["loss"]) for h in hist)


@pytest.mark.parametrize("extra", [["--refresh", "4"],
                                   ["--refresh-mode", "on_change"],
                                   ["--warmup", "2", "--host-loop",
                                    "--log-every", "3"]])
def test_marl_ic3net_grouped_history_is_train(extra, capsys):
    """The grouped path (plan cache refreshed every 4 iterations, on a
    change of layout, or after a dense warmup) gives exactly the history
    of ``train`` called with the same arguments."""
    model, hist = marl_ic3net.main([*CI_GROUPED, *extra])
    out = capsys.readouterr().out
    _expect_lines(out)
    refresh = int(extra[1]) if extra[0] == "--refresh" else 1
    mode = extra[1] if extra[0] == "--refresh-mode" else "period"
    warmup = int(extra[1]) if extra[0] == "--warmup" else 0
    env, ecfg = envs.make("predator_prey", n_agents=2, size=3, max_steps=9)
    _, want = train.train(
        ic3net.IC3NetConfig(hidden=32, flgw_groups=4, flgw_path="grouped"),
        ecfg, train.TrainConfig(batch=2), 6, seed=0, env=env,
        schedule=SparsitySchedule(groups=4, warmup_steps=warmup,
                                  refresh_every=refresh, refresh=mode),
        device="cpu")
    assert [[h[k] for k in _METRICS] for h in hist] == \
        [[h[k] for k in _METRICS] for h in want]
    if warmup:
        assert out.count("iter ") == 2          # iterations 0 and 3
        assert [h["mask_sparsity"] for h in hist[:warmup]] == [0.0] * warmup


@pytest.mark.parametrize("flag", [["--mesh", "2,2"], ["--parallel"],
                                  ["--mesh", "1,1"]])
def test_marl_ic3net_refuses_sharding(flag, capsys):
    """Without a process group: ``--mesh 2,2`` exits with the reference's
    "needs 4 devices" message; ``--parallel`` warns and trains; ``--mesh
    1,1`` prints the mesh and trains. Both runs are ``train``'s."""
    if flag == ["--mesh", "2,2"]:
        with pytest.raises(SystemExit) as e:
            marl_ic3net.main([*CI_GROUPED, *flag])
        assert e.value.code != 0
        assert "marl mesh (2, 2) needs 4 devices, only 1 available" in \
            capsys.readouterr().err
        return
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        _, hist = marl_ic3net.main([*CI_GROUPED, *flag])
    deprecated = [w for w in seen if w.category is DeprecationWarning
                  and "TrainConfig.parallel is deprecated" in str(w.message)]
    assert len(deprecated) == (flag == ["--parallel"])
    out = capsys.readouterr().out
    assert ("marl mesh (1x1): axes (env, agent) over 1 device(s)" in out) \
        == (flag == ["--mesh", "1,1"])
    _expect_lines(out)
    assert [[h[k] for k in _METRICS] for h in hist] == _grouped_history()


@functools.lru_cache(maxsize=None)
def _grouped_history() -> list:
    """``train``'s metrics for CI_GROUPED's run, computed once."""
    env, ecfg = envs.make("predator_prey", n_agents=2, size=3, max_steps=9)
    _, want = train.train(
        ic3net.IC3NetConfig(hidden=32, flgw_groups=4, flgw_path="grouped"),
        ecfg, train.TrainConfig(batch=2), 6, seed=0, env=env, device="cpu")
    return [[h[k] for k in _METRICS] for h in want]


def test_marl_ic3net_rejects_a_malformed_mesh(capsys):
    with pytest.raises(SystemExit) as e:
        marl_ic3net.main([*CI_GROUPED, "--mesh", "2x2"])
    assert e.value.code != 0
    assert "--mesh expects ENV,AGENT" in capsys.readouterr().err


def test_marl_ic3net_as_a_process():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.marl_ic3net"]
    ok = subprocess.run([*cmd, *CI_GROUPED, "--refresh", "4"], env=env,
                        capture_output=True, text=True, timeout=300)
    assert ok.returncode == 0, ok.stderr
    _expect_lines(ok.stdout)
    bad = subprocess.run([*cmd, *CI_GROUPED, "--mesh", "2,2"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert bad.returncode != 0
    assert "marl mesh (2, 2) needs 4 devices, only 1 available" in bad.stderr


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_marl_ic3net_under_torchrun_trains_on_a_process_mesh():
    """torchrun starts 2 processes; each joins the gloo group through
    ``init_distributed``, prints the (2x1) mesh and trains its shard; the
    two print the same metrics.

    The rendezvous is pinned to 127.0.0.1 on a free port. ``--standalone``
    hands the workers ``socket.getfqdn()`` as their master address, and
    on a host whose own name does not resolve the workers wait for it
    until the time limit (an unresolvable ``--local-addr`` reproduces the
    hang), so the test depended on the host's name service."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
         "--rdzv-backend", "c10d",
         "--rdzv-endpoint", f"127.0.0.1:{_free_port()}",
         "--local-addr", "127.0.0.1",
         "--nproc-per-node", "2", "--tee", "3", "-m",
         "repro_torch.launch.marl_ic3net", *CI_GROUPED, "--mesh", "2,1"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, (
        f"torchrun exited {out.returncode}\n--- stdout (tail) ---\n"
        f"{out.stdout[-3000:]}\n--- stderr (tail) ---\n{out.stderr[-3000:]}")
    ranks = {r: [ln.split("]:", 1)[1] for ln in out.stdout.splitlines()
                 if ln.startswith(f"[default{r}]:")] for r in (0, 1)}
    for lines in ranks.values():
        text = "\n".join(lines)
        assert "marl mesh (2x1): axes (env, agent) over 2 device(s)" in text
        assert "rollout batch    2 -> 1 envs/shard" in text
        _expect_lines(text)
    success = [[ln for ln in lines if ln.startswith("success:")]
               for lines in ranks.values()]
    assert success[0] == success[1] and len(success[0]) == 1


# ---------------------------------------------------------------------------
# launch/quickstart.py
# ---------------------------------------------------------------------------

def test_quickstart_runs_on_the_cpu(capsys):
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # no warning on the way
        res = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "FLGW G=4: actual sparsity" in out and "OSEL: 4 cached" in out
    assert "step  200 loss" in out and "mask is learned" in out
    assert abs(res["sparsity"] - 0.75) < 0.02
    assert int(res["workloads"].sum()) == quickstart.N
    assert res["masked_vs_grouped"] < 1e-5
    assert res["losses"][-1] < res["losses"][0] and res["ig_moved"] > 0
