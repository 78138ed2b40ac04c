"""The IC3Net learner on an ("env", "agent") process mesh.

``TrainConfig(mesh=(1, 1))`` trains bitwise as ``train()`` without a
mesh (the JAX package's three-way parity, ``tests/test_marl.py``), the
deprecated ``parallel`` alias warns and routes as JAX's does; (2, 1),
(1, 2) and (2, 2) meshes of spawned gloo ranks train the one-process run
up to the order of f32 sums, with the replicated state and plans bitwise
equal across ranks; a batch the env axis does not divide is replicated;
and on a rollout JAX recorded, each rank replays its shard and the
gradients summed over the ranks equal JAX's whole-batch ``_loss_grads``
(the reference's fault entries excluded, ROADMAP Queue 3)."""
import dataclasses
import functools
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite's workers share the host's cores
jax = pytest.importorskip("jax")

import torch.distributed as dist  # noqa: E402
from repro.kernels import use_reference_impl  # noqa: E402
from repro.marl import envs as jenvs  # noqa: E402
from repro.marl import ic3net as jic3net  # noqa: E402
from repro.marl import train as jtrain  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.schedule import SparsitySchedule  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.marl import envs as tenvs  # noqa: E402
from repro_torch.marl import ic3net as tic3net  # noqa: E402
from repro_torch.marl import train as ttrain  # noqa: E402
from repro_torch.marl.envs import predator_prey as tpp  # noqa: E402

ENV = dict(n_agents=4, size=3, max_steps=6)
B, HIDDEN, ITERS = 4, 16, 5
PARAM_ATOL, LOSS_RTOL = 1e-5, 1e-4
GRAD_REL, METRIC_RTOL = 1e-4, 1e-5
SHAPES = ((2, 1), (1, 2), (2, 2))
RAGGED_B = 3                   # does not divide the 2-wide env axis


def _train(shape=None, groups=4, path="grouped", batch=B, parallel=False):
    env, ecfg = tenvs.make("predator_prey", **ENV)
    cfg = tic3net.IC3NetConfig(hidden=HIDDEN, flgw_groups=groups,
                               flgw_path=path)
    sched = SparsitySchedule(groups=groups, refresh_every=3) \
        if groups > 1 else None
    return ttrain.train(cfg, ecfg, ttrain.TrainConfig(
        batch=batch, mesh=shape, parallel=parallel), ITERS, env=env,
        schedule=sched, device="cpu")


def _params(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _metrics(hist) -> list:
    return [[h[k] for k in ttrain._METRICS] for h in hist]


@functools.lru_cache(maxsize=None)
def _one_process(groups=4, path="grouped", batch=B):
    """``train()`` without a mesh: (parameters, metrics), computed once a
    module."""
    model, hist = _train(None, groups, path, batch)
    return _params(model), _metrics(hist)


@pytest.mark.parametrize("groups,path", [(1, "masked"), (4, "grouped")])
def test_mesh_1x1_trains_bitwise_as_train(groups, path):
    """One process, no group: the (1, 1) mesh is the run without a mesh,
    parameters and every metric bitwise (grouped: a refresh at it = 3)."""
    p0, h0 = _one_process(groups, path)
    m1, h1 = _train((1, 1), groups, path)
    p1 = _params(m1)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert h0 == _metrics(h1)


def test_parallel_alias_warns_and_routes():
    """``parallel=True`` warns as JAX's does and becomes (world_size, 1) =
    (1, 1) here, bitwise the run without a mesh; an explicit ``mesh``
    wins over it."""
    p0, h0 = _one_process()
    with pytest.warns(DeprecationWarning) as seen:
        m1, h1 = _train(parallel=True)
    msg = str(seen[0].message)
    with pytest.warns(DeprecationWarning) as jseen:
        jtrain._resolve_mesh(jtrain.TrainConfig(parallel=True))
    jmsg = str(jseen[0].message)
    for phrase in ("TrainConfig.parallel is deprecated",
                   "routes to a 1-D env-only mesh",
                   "where ``batch`` is the GLOBAL env batch",
                   "set TrainConfig.mesh=(env, agent) explicitly."):
        assert phrase in msg and phrase in jmsg
    p1 = _params(m1)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert h0 == _metrics(h1)
    with pytest.warns(DeprecationWarning,
                      match=r"explicit TrainConfig.mesh=\(1, 1\) wins"):
        _, h2 = _train((1, 1), parallel=True)
    with pytest.warns(DeprecationWarning,
                      match=r"explicit TrainConfig.mesh=\(1, 1\) wins"):
        jtrain._resolve_mesh(jtrain.TrainConfig(mesh=(1, 1), parallel=True))
    assert _metrics(h2) == h0


# -- a rollout JAX recorded, for the ranks to replay ---------------------------

def _jax_case():
    """JAX's grouped G=2 params, a whole-batch rollout it recorded (reset
    states, actions, gates), its plans and its ``_loss_grads`` on it; its
    Pallas kernels through their plain reference (``use_reference_impl``,
    as the JAX package's own multi-device mesh path runs them)."""
    with use_reference_impl():
        return _jax_case_ref()


def _jax_case_ref():
    env, ecfg = jenvs.make("predator_prey", **ENV)
    # jtrain._init, its init jitted
    jcfg = dataclasses.replace(
        jic3net.IC3NetConfig(hidden=HIDDEN, flgw_groups=2,
                             flgw_path="grouped"),
        obs_dim=env.obs_dim(ecfg), n_agents=ecfg.n_agents,
        n_actions=env.n_actions(ecfg))
    kinit, _ = jax.random.split(jax.random.PRNGKey(0))
    params = jax.jit(lambda k: jic3net.init(k, jcfg)[0])(kinit)
    plans = jax.jit(jic3net.encode_plans, static_argnames=("cfg",))(
        params, cfg=jcfg)
    key = jax.random.PRNGKey(7)
    keys = jax.random.split(key, B)
    outs = jax.jit(jax.vmap(lambda k: jtrain.rollout(
        params, k, jcfg, ecfg, env, plans, collect=True)))(keys)
    start = jax.jit(jax.vmap(
        lambda k: env.reset(jax.random.split(k)[0], ecfg)))(keys)
    metrics, grads = jax.jit(
        jtrain._loss_grads,
        static_argnames=("cfg", "ecfg", "tcfg", "env", "schedule"))(
        params, key, 0, cfg=jcfg, ecfg=ecfg,
        tcfg=jtrain.TrainConfig(batch=B), env=env, schedule=None,
        plans=plans)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(cfg=dataclasses.asdict(jcfg), params=to_np(params),
                start=[np.asarray(v) for v in start],
                actions=np.asarray(outs[7]), gates=np.asarray(outs[5]),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=to_np(grads))


def _replay(case, shape):
    """This rank's shard of JAX's rollout through the port's mesh
    ``_loss_grads``: the summed gradients and metrics."""
    model, _ = interop.ic3net_from_numpy(
        tic3net.IC3NetConfig(**case["cfg"]), case["params"], device="cpu")
    env, ecfg = tenvs.make("predator_prey", **ENV)
    mesh = mesh_lib.make_marl_mesh(env=shape[0], agent=shape[1])
    shard = ttrain.shard_for(mesh, B, ENV["n_agents"])
    state = tpp.EnvState(*(torch.from_numpy(v) for v in case["start"]))
    state = shard.take_rows(state._replace(
        pos=state.pos.long(), prey=state.prey.long(), t=state.t.long()))
    # (B, T, A) -> the shard's rows and agents
    actions, gates = (shard.take(torch.from_numpy(x).transpose(1, 2))
                      .transpose(1, 2) for x in (case["actions"],
                                                 case["gates"]))
    actions = actions.long()
    with torch.no_grad():
        plans = model.encode_plans()
    metrics, grads = ttrain._loss_grads(
        model, env, ecfg, ttrain.TrainConfig(batch=B), state,
        lambda t, lg, gl: (actions[:, t], gates[:, t]), 0, None, plans,
        shard=shard)
    return dict(grads=interop.tree_to_numpy(grads),
                metrics={k: float(v) for k, v in metrics.items()},
                local=tuple(actions.shape))


def _rank_runs(shapes, case):
    """Everything a spawned rank of ``shapes``' world runs: each mesh's
    5-iteration grouped run (with its plans' signature and the shard's
    rollout shape), the replay of JAX's rollout, on a 2-wide env axis a
    batch of RAGGED_B, and on 2 ranks the async launcher."""
    out = {}
    for shape in shapes:
        model, hist = _train(shape)
        env, ecfg = tenvs.make("predator_prey", **ENV)
        mesh = mesh_lib.make_marl_mesh(env=shape[0], agent=shape[1])
        shard = ttrain.shard_for(mesh, B, ENV["n_agents"])
        gen = ttrain.make_generator(1, "cpu")
        with torch.no_grad():
            plans = model.encode_plans()
            r = ttrain.run_episode(
                model, env, ecfg, shard.take_rows(env.reset(gen, ecfg, B)),
                ttrain.sampler(gen, shard), plans, shard=shard)
        out[shape] = dict(params=_params(model), metrics=_metrics(hist),
                          sig=int(plans.sig), rollout=tuple(r.reward.shape),
                          replay=_replay(case, shape))
        if shape == (2, 1):
            m, h = _train(shape, batch=RAGGED_B)
            out["ragged"] = dict(params=_params(m), metrics=_metrics(h))
    if dist.get_world_size() == 2:
        out["async"] = _async_rank()
    return out


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The one-process references, JAX's recorded rollout, and one spawn
    of 2 gloo ranks ((2, 1), (1, 2), the async launcher) and one of 4
    ((2, 2))."""
    case = _jax_case()
    worlds = ((2, SHAPES[:2]), (4, SHAPES[2:]))

    def run(world, shapes):
        d = tmp_path_factory.mktemp(f"mesh{world}")
        return mesh_lib.spawn(_rank_runs, world, shapes, case,
                              backend="gloo", init_file=str(d / "rdv"),
                              timeout_s=150, torch_threads=1)
    with ThreadPoolExecutor(len(worlds)) as pool:    # both groups at once
        spawned = list(pool.map(lambda w: run(*w), worlds))
    ranks = {}
    for (world, shapes), outs in zip(worlds, spawned):
        for shape in shapes:
            ranks[shape] = [o[shape] for o in outs]
        for extra in ("ragged", "async"):
            if extra in outs[0]:
                ranks[extra] = [o[extra] for o in outs]
    return dict(case=case, ref=_one_process(),
                ragged=_one_process(batch=RAGGED_B), ranks=ranks)


@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_trains_the_one_process_run(mesh_runs, shape):
    """Parameters within 1e-5 and losses within rtol 1e-4 of ``train()``
    with the same global batch; success, return and sparsity too."""
    ref_p, ref_m = mesh_runs["ref"]
    got = mesh_runs["ranks"][shape][0]
    for k, want in ref_p.items():
        np.testing.assert_allclose(got["params"][k], want.numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
    np.testing.assert_allclose(np.array(got["metrics"]), np.array(ref_m),
                               rtol=LOSS_RTOL, atol=1e-7)


@pytest.mark.parametrize("shape", SHAPES)
def test_replicated_state_is_bitwise_across_ranks(mesh_runs, shape):
    """Every rank ends with rank 0's parameters and metrics bitwise, and
    encodes the same plans; each rank's rollout tensors are its shard,
    (B/env, T, A/agent)."""
    ranks = mesh_runs["ranks"][shape]
    r0 = ranks[0]
    for r in ranks:
        assert all(np.array_equal(r["params"][k], r0["params"][k])
                   for k in r0["params"])
        assert r["metrics"] == r0["metrics"] and r["sig"] == r0["sig"]
        assert r["rollout"] == (B // shape[0], ENV["max_steps"],
                                ENV["n_agents"] // shape[1])


def test_a_non_dividing_batch_is_replicated(mesh_runs):
    """B=3 on a 2-wide env axis: the axis drops to replication, every rank
    rolls out the whole batch and sums over its 1-wide agent axis, which
    is the one-process run bitwise."""
    ref_p, ref_m = mesh_runs["ragged"]
    for r in mesh_runs["ranks"]["ragged"]:
        assert all(np.array_equal(r["params"][k], ref_p[k].numpy())
                   for k in ref_p)
        assert r["metrics"] == ref_m


def _fault(leaf, shape):
    """The reference make_plan fault's entries (ROADMAP Queue 3)."""
    mask = np.zeros(shape, bool)
    if leaf == "ig":
        mask[-1, :] = True
    if leaf == "og":
        mask[:, -1] = True
    return mask


def _flat(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("shape", SHAPES)
def test_summed_gradients_of_a_jax_rollout_match_jax(mesh_runs, shape):
    """Each rank replays its shard of JAX's recorded rollout; the
    gradients summed over the mesh equal JAX's whole-batch ``_loss_grads``
    within 1e-4 relative norm a leaf (the fault's entries excluded), the
    gate head exactly 0 in both, and the metrics within 1e-5."""
    case = mesh_runs["case"]
    want = dict(_flat(case["grads"]))
    for r in mesh_runs["ranks"][shape]:
        rep = r["replay"]
        assert rep["local"] == (B // shape[0], ENV["max_steps"],
                                ENV["n_agents"] // shape[1])
        got = dict(_flat(rep["grads"]))
        assert got.keys() == want.keys()
        for path, w in want.items():
            keep = ~_fault(path[-1], w.shape)
            if not w[keep].any():
                assert not got[path][keep].any(), path
                continue
            rel = np.linalg.norm(got[path][keep] - w[keep]) / \
                np.linalg.norm(w[keep])
            assert rel <= GRAD_REL, (path, rel)
        assert not got[("gate", "w")].any() and not want[("gate", "w")].any()
        for k in ("success", "return", "loss", "mask_sparsity"):
            np.testing.assert_allclose(rep["metrics"][k],
                                       case["metrics"][k],
                                       rtol=METRIC_RTOL, atol=1e-7,
                                       err_msg=k)


def test_no_process_group_is_left_behind(monkeypatch):
    for var in ("JAX_COORDINATOR", "COORDINATOR_ADDRESS", "MASTER_ADDR",
                "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert mesh_lib.init_distributed(backend="gloo")["process_count"] \
            == 1


_ASYNC = ["--device", "cpu", "--updates", "3", "--agents", "2", "--size",
          "3", "--hidden", "16", "--groups", "4", "--path", "grouped"]


def _async_rank():
    """The async launcher with ``--distributed`` on this rank's group:
    its parameters, losses and the collectives it called."""
    from repro_torch.launch import marl_async
    from repro_torch.sharding import collectives
    before = collectives.CALLS.copy()
    model, hist = marl_async.main([*_ASYNC, "--batch", "4", "--distributed"])
    return (_params(model), [h["loss"] for h in hist],
            dict(collectives.CALLS - before))


def test_async_processes_do_not_exchange_gradients(mesh_runs):
    """The JAX package's async hosts never exchange gradients (no
    collective in ``repro.marl.async_train``), and the port mirrors it
    (ROADMAP Queue 3): each of 2 processes trains its host-local batch of
    2 alone, bitwise a one-process run of batch 2, with no collective."""
    import inspect
    from repro.marl import async_train as jasync
    from repro_torch.launch import marl_async
    src = inspect.getsource(jasync)
    assert not any(c in src for c in ("psum", "pmean", "all_reduce",
                                      "process_allgather"))
    model, hist = marl_async.main([*_ASYNC, "--batch", "2"])
    want = _params(model)
    for params, losses, calls in mesh_runs["ranks"]["async"]:
        assert calls == {}
        assert losses == [h["loss"] for h in hist]
        assert all(np.array_equal(params[k], want[k].numpy()) for k in want)
