"""The LM trained on a ``(data, model)`` process mesh, against the JAX
package's single-device step.

gloo ranks on the CPU through ``launch.mesh.spawn``: a module fixture
spawns each mesh shape once. From one state (the port's init, carried to
JAX and, sharded, to every rank by ``interop.train_state_from_numpy``),
(2, 1), (1, 2) and (2, 2) meshes train gemma2-2b's grouped f32 smoke
config as JAX's ``make_train_step`` does on the whole batch, within
``test_torch_train.py``'s tolerances (the reference's STE fault entries
excluded, ROADMAP Queue 3); (2, 2) at this batch holds one row a data
rank, shared by its model ranks, so its compact products split their
columns over ``model``; each rank holds only its shards; a MoE config
on (2, 1) gives JAX's loss, its capacity and load-balancing aux from the
global batch, and in two microbatches JAX's microbatched step (each rank
holds its rows of every global microbatch); a (2, 2) checkpoint restores onto (2, 1) bitwise, its
manifest that of a one-process save; ``remesh_state`` moves a sharded
state between shapes bitwise; ``train_lm`` runs on (2, 1). In one
process, a one-rank group's mesh step is bitwise the step without one.
"""
import collections
import contextlib
import functools
import io
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite's workers share the host's cores
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import torch.distributed as dist  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.core import encoder as jencoder  # noqa: E402
from repro.core import grouped as jgrouped  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.sharding import partition as jpart  # noqa: E402
from repro.train import state as jstate_lib  # noqa: E402
from repro.train import step as jstep_lib  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import grouped  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels.flgw_matmul import ops as kops  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.runtime import remesh_state  # noqa: E402
from repro_torch.sharding import collectives, partition  # noqa: E402
from repro_torch.train import state as state_lib  # noqa: E402
from repro_torch.train import step as step_lib  # noqa: E402

STEPS, BATCH, SEQ = 3, 2, 32
LR = 3e-4
CHUNKS = dict(q_chunk=16, ce_chunk=16)
# test_torch_train.py's f32 tolerances
F32_LOSS_RTOL, F32_GNORM_RTOL = 1e-5, 1e-4
PARAM_ATOL = LR / 15
SHAPES = ((2, 1), (1, 2), (2, 2))
MOE_STEPS = 2
# the microbatched MoE run: 2 microbatches of a 4-row global batch, so
# each of the (2, 1) mesh's ranks holds one row of each
MB, MB_BATCH = 2, 4
RANK_TIMEOUT_S = 120


def _gemma():
    kw = dict(flgw_groups=4, flgw_path="grouped", dtype=jnp.float32)
    jcfg = jregistry.get_smoke_config("gemma2_2b", **kw)
    tcfg = registry.get_smoke_config("gemma2_2b",
                                     **dict(kw, dtype=torch.float32))
    return jcfg, tcfg


def _moe():
    """mixtral's smoke config in f32, at its own capacity factor (1.25),
    which drops tokens at this batch: each rank keeps the assignments
    that the global batch's capacity keeps."""
    return (jregistry.get_smoke_config("mixtral_8x22b", dtype=jnp.float32),
            registry.get_smoke_config("mixtral_8x22b", dtype=torch.float32))


def _jax_state(state):
    """The port's initial TrainState as the JAX package's."""
    def tree(t):
        if isinstance(t, dict):
            return {k: tree(v) for k, v in t.items()}
        return jnp.asarray(interop.tree_to_numpy(t))

    def plan(p):
        if isinstance(p, dict):
            return {k: plan(v) for k, v in p.items()}
        return jgrouped.GroupPlan(*(
            jnp.asarray(t.numpy() if t.dtype == torch.bool
                        else t.numpy().astype(np.int32)) for t in p[:6]))
    params = tree(state.params)
    plans = state.plans
    if plans:
        plans = jencoder.PlanState(plan(plans.plans),
                                   jnp.uint32(int(plans.sig)))
    else:
        plans = ()
    return jstate_lib.TrainState(params=params, opt=jopt.adamw_init(params),
                                 step=jnp.zeros((), jnp.int32), plans=plans)


def _reference(cfgs, steps, batch=BATCH, microbatches=1):
    """JAX's single-device run from the port's init: (the initial state
    as numpy, per-step metrics, the final params)."""
    jcfg, tcfg = cfgs
    state = state_lib.init_state(torch.Generator().manual_seed(0), tcfg)
    jstate = _jax_state(state)
    init = jax.tree.map(np.asarray, jstate)
    jstep = jax.jit(jstep_lib.make_train_step(
        jcfg, microbatches=microbatches, **CHUNKS))
    ds = pipeline.SyntheticTokens(tcfg.vocab, batch, SEQ, seed=0)
    metrics = []
    for i in range(steps):
        jstate, m = jstep(jstate, {k: jnp.asarray(v)
                                   for k, v in ds.batch_at(i).items()})
        metrics.append(jax.tree.map(float, m))
    return init, metrics, jax.tree.map(np.asarray, jstate.params), \
        interop.tree_to_numpy(state.params)


def _train_on_mesh(mesh, cfg, init, steps, batch=BATCH, microbatches=1):
    """``steps`` mesh steps from the carried ``init``: (the sharded
    state, per-step metrics)."""
    state = interop.train_state_from_numpy(init, "cpu", mesh=mesh, cfg=cfg)
    step = step_lib.make_train_step(cfg, mesh=mesh, global_batch=batch,
                                    microbatches=microbatches, **CHUNKS)
    ds = pipeline.SyntheticTokens(cfg.vocab, batch, SEQ, seed=0)
    rows = partition.step_rows(mesh, batch, microbatches)[0]
    metrics = []
    for i in range(steps):
        state, m = step(state, {k: v[rows]
                                for k, v in ds.tensors_at(i).items()})
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:      # the first step's collectives, by operation
            _train_on_mesh.first = {
                op: (n, collectives.BYTES[(op, be)])
                for (op, be), n in collectives.CALLS.items()}
            _train_on_mesh.split = dict(
                tally=dict(_SPLIT), widths=[list(w) for w in _SPLIT_WIDTHS])
        _SPLIT.clear()
        _SPLIT_WIDTHS[:] = [[], []]
    return state, metrics


# what the compact products ran in the current step of a spawned rank
# (``_count_split``): their calls and the collectives each ran, by
# "fwd"/"bwd"; each forward's (capN, columns computed)
_SPLIT = collections.Counter()
_SPLIT_WIDTHS = [[], []]


def _count_split():
    """Wrap the compact product's forward, its backward and
    ``grouped_bmm`` in this rank so that :data:`_SPLIT` tallies them and
    the collectives they run, and :data:`_SPLIT_WIDTHS` each forward's
    capN beside the columns its launch took."""
    def tallied(fn, kind):
        def run(*args, **kw):
            if kind == "fwd":
                _SPLIT_WIDTHS[0].append(args[2].col_ids.shape[-1])
            before = collections.Counter(collectives.CALLS)
            out = fn(*args, **kw)
            _SPLIT[kind] += 1
            for (op, _), n in (collectives.CALLS - before).items():
                _SPLIT[f"{kind} {op}"] += n
            return out
        return run

    def bmm(xg, wc, real=kops.grouped_bmm):
        _SPLIT_WIDTHS[1].append(wc.shape[-1])
        return real(xg, wc)
    grouped._core_matmul = tallied(grouped._core_matmul, "fwd")
    grouped._grouped_bwd = tallied(grouped._grouped_bwd, "bwd")
    kops.grouped_bmm = bmm


def _rank(shape, init, moe_init, moe_mb_init, ckpt, role):
    """Everything one spawned rank of a ``shape`` mesh runs."""
    mesh = mesh_lib.make_mesh_from_devices(model=shape[1])
    _, cfg = _gemma()
    _count_split()
    collectives.CALLS.clear()
    state, metrics = _train_on_mesh(mesh, cfg, init, STEPS)
    out = {"metrics": metrics, "calls": dict(collectives.CALLS),
           "step1": _train_on_mesh.first, "split": _train_on_mesh.split,
           "params": interop.tree_to_numpy(partition.gather(state.params)),
           "bytes": partition.state_bytes(state),
           "local_shapes": [tuple(x.to_local().shape) for x in
                            partition.leaves(state.params)]}
    rank = dist.get_rank()
    if role == "save":
        store.save_checkpoint(f"{ckpt}/mesh", STEPS, state)
        whole = partition.gather(state)
        if rank == 0:
            store.save_checkpoint(f"{ckpt}/whole", STEPS, whole)
        dist.barrier()
        specs = state_lib.param_specs(cfg)
        before = partition.gather(state.params)
        moved, m2 = remesh_state(state.params, specs, model=4)
        back, m3 = remesh_state(moved, specs, model=2)
        out["remesh"] = {
            "shapes": [tuple(m2.shape), tuple(m3.shape)],
            "equal": all(torch.equal(a, b) for a, b in zip(
                partition.leaves(before),
                partition.leaves(partition.gather(back)))),
            "moved_sharded": any(p.is_shard() for x in partition.leaves(moved)
                                 for p in x.placements)}
    if role == "restore":
        target = interop.train_state_from_numpy(init, "cpu", mesh=mesh,
                                                cfg=cfg)
        shardings = partition.shardings_of(target)
        restored, step = state_lib.restore_state(f"{ckpt}/mesh", target, cfg,
                                                 shardings=shardings)
        d = f"{ckpt}/mesh/step_{STEPS:08d}"
        files = {e["path"]: e["file"] for e in json.load(
            open(f"{d}/manifest.json"))["leaves"]}
        same = []
        for path, leaf in store.tree_paths(restored._replace(plans=())):
            want = torch.from_numpy(np.load(f"{d}/{files[path]}"))
            same.append(torch.equal(
                leaf.to_local(), partition.shard_of(want, leaf.placements,
                                                    mesh)))
        out["restore"] = {"step": step, "leaves": len(same),
                          "all_equal": all(same),
                          "sharded": sum(any(p.is_shard() for p in
                                             x.placements) for x in
                                         partition.leaves(restored))}
        _, mcfg = _moe()
        _, mm = _train_on_mesh(mesh, mcfg, moe_init, MOE_STEPS)
        out["moe"] = mm
        mstate, mm = _train_on_mesh(mesh, mcfg, moe_mb_init, MOE_STEPS,
                                    batch=MB_BATCH, microbatches=MB)
        out["moe_mb"] = {"metrics": mm, "params": interop.tree_to_numpy(
            partition.gather(mstate.params))}
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            launch.train_lm("gemma2_2b", steps=1, batch=BATCH, seq=16,
                            flgw_groups=4, flgw_path="grouped", log_every=1,
                            device="cpu", model=1)
        out["train_lm"] = buf.getvalue()
    return out


@functools.lru_cache(maxsize=None)
def _references():
    return {"gemma": _reference(_gemma(), STEPS),
            "moe": _reference(_moe(), MOE_STEPS),
            "moe_mb": _reference(_moe(), MOE_STEPS, MB_BATCH, MB)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each shape spawned once: (2, 2) (saves) beside (1, 2), then (2, 1)
    (restores (2, 2)'s checkpoint, the MoE run and ``train_lm``)."""
    ref = _references()
    d = tmp_path_factory.mktemp("lm_mesh")
    init, moe_init = ref["gemma"][0], ref["moe"][0]

    def go(shape, role):
        return mesh_lib.spawn(
            _rank, shape[0] * shape[1], shape, init, moe_init,
            ref["moe_mb"][0], str(d), role,
            backend="gloo", init_file=str(d / f"rdv_{shape[0]}{shape[1]}"),
            timeout_s=RANK_TIMEOUT_S, torch_threads=1)

    with ThreadPoolExecutor(2) as ex:
        first = {(2, 2): ex.submit(go, (2, 2), "save"),
                 (1, 2): ex.submit(go, (1, 2), None)}
        out = {k: f.result() for k, f in first.items()}
    out[(2, 1)] = go((2, 1), "restore")
    return ref, out


def _fault_free(params):
    """{path tuple: keep mask} of every FLGW layer's ig/og, False at the
    entries the reference's ``make_plan`` fault moves (ROADMAP Queue 3)."""
    keep = {}
    for path, p in grouped.iter_flgw_layers(params):
        ig = np.ones(p["ig"].shape, bool)
        og = np.ones(p["og"].shape, bool)
        ig[..., -1, :] = False
        og[..., :, -1] = False
        keep[(*path, "ig")], keep[(*path, "og")] = ig, og
    return keep


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_trains_as_jax_single_device_step(runs, shape):
    ref, out = runs
    _, jmetrics, jparams, params0 = ref["gemma"]
    keep = _fault_free({k: v for k, v in params0.items()})
    for r in out[shape]:
        assert r["metrics"] == out[shape][0]["metrics"]
        for t, j in zip(r["metrics"], jmetrics):
            np.testing.assert_allclose(t["loss"], j["loss"],
                                       rtol=F32_LOSS_RTOL)
            np.testing.assert_allclose(t["grad_norm"], j["grad_norm"],
                                       rtol=F32_GNORM_RTOL)
        flat = jax.tree_util.tree_flatten_with_path(r["params"])[0]
        for (kp, a), b in zip(flat, jax.tree.leaves(jparams)):
            path = tuple(k.key for k in kp)
            m = keep.get(path, np.ones(a.shape, bool))
            np.testing.assert_allclose(a[m], np.asarray(b)[m], rtol=0,
                                       atol=PARAM_ATOL, err_msg=str(path))
        ops = {op for op, _ in r["calls"]}
        assert {"all_gather", "reduce_scatter", "all_reduce"} <= ops


def _fake_mesh(shape):
    class FakeMesh:
        axis_names = ("data", "model")

        class devices:
            pass
    FakeMesh.devices.shape = shape
    return FakeMesh()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_each_rank_holds_only_its_shards(runs, shape):
    """A rank's state bytes are each leaf's whole bytes over the widths
    of the mesh axes its ``constrained_pspec`` splits it over (a
    replicated leaf whole), and its params' local shapes are the whole
    shapes so cut, by the reference's ``constrained_pspec``."""
    _, out = runs
    jcfg, cfg = _gemma()
    mesh = _fake_mesh(shape)
    sizes = dict(zip(mesh.axis_names, shape))
    spec_of = {jax.tree_util.keystr(p): s for p, s in
               jax.tree_util.tree_flatten_with_path(
                   jstate_lib.state_specs(jcfg), is_leaf=jpart._is_spec)[0]}
    want_bytes, want_shapes = 0, []
    for path, t in store.tree_paths(state_lib.abstract_state(cfg)):
        shp = list(t.shape)
        pspec = jpart.constrained_pspec(spec_of[path], t.shape, mesh)
        for d, e in enumerate(pspec):
            for x in (e if isinstance(e, tuple) else (e,)):
                if x:
                    shp[d] //= sizes[x]
        want_bytes += int(np.prod(shp, dtype=np.int64)) * t.element_size()
        if path.startswith(".params"):
            want_shapes.append(tuple(shp))
    for r in out[shape]:
        local, whole = r["bytes"]
        assert local == want_bytes < whole
        assert r["local_shapes"] == want_shapes


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_dry_run_predicts_each_rank_collectives_and_state_bytes(runs, shape):
    """``launch.dryrun`` of the same step on ``meta`` over a fake group of
    the same shape predicts every rank's collectives of a step (calls and
    bytes by operation) and its state bytes, as the spawned gloo run
    counted them."""
    from repro_torch.launch import dryrun
    _, out = runs
    _, cfg = _gemma()
    res = dryrun.run_cell("gemma2_2b", "train_4k", flgw_groups=4,
                          flgw_path="grouped", save=False, cfg=cfg, seq=SEQ,
                          batch=BATCH, mesh_shape=shape, step_kw=CHUNKS)
    got = {op: (c["calls"], c["bytes"]) for op, c in
           res["collectives"].items()}
    for r in out[shape]:
        assert r["step1"] == got
        assert r["bytes"][0] == res["state_bytes_per_chip"]
        assert r["bytes"][1] == res["state_bytes_whole"]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_model_ranks_sharing_rows_split_the_compact_products(runs, shape):
    """(2, 2) at a global batch of 2 holds one row a data rank, which its
    model ranks share: every compact product of a step computes capN/2
    columns, its forward all-gathers the outputs over the model group and
    its backward all-reduces once, and those are among the collectives
    the dry run predicts (``test_dry_run_predicts_...``). (1, 2) spreads
    its rows over ``model`` and (2, 1) has no model ranks: whole tiles,
    no collective inside a product."""
    _, out = runs
    split = shape == (2, 2)
    for r in out[shape]:
        s = r["split"]
        caps, cols = s["widths"]
        t = s["tally"]
        assert t["fwd"] == len(caps) == len(cols) > 0 and t["bwd"] > 0
        assert list(cols) == [c // 2 if split else c for c in caps]
        want = {"fwd all_gather": t["fwd"],
                "bwd all_reduce": t["bwd"]} if split else {}
        assert {k: v for k, v in t.items() if " " in k} == want
        if split:
            step1 = r["step1"]
            assert step1["all_gather"][0] >= t["fwd"]
            assert step1["all_reduce"][0] >= t["bwd"]


def test_moe_on_a_mesh_matches_jax_loss_with_a_global_aux(runs):
    ref, out = runs
    jm = ref["moe"][1]
    for r in out[(2, 1)]:
        for t, j in zip(r["moe"], jm):
            assert t["aux"] > 0
            np.testing.assert_allclose(t["aux"], j["aux"], rtol=F32_LOSS_RTOL)
            np.testing.assert_allclose(t["loss"], j["loss"],
                                       rtol=F32_LOSS_RTOL)
            np.testing.assert_allclose(t["grad_norm"], j["grad_norm"],
                                       rtol=F32_GNORM_RTOL)


def test_moe_microbatches_on_a_mesh_match_jax_microbatched_step(runs):
    """mixtral's smoke config at its capacity factor 1.25 (which drops
    tokens), 2 microbatches of a 4-row batch on (2, 1): each rank holds
    its row of each global microbatch, so the capacity counts over the
    global microbatch, and loss, aux, gradient norm and the updated
    params are JAX's microbatched step's."""
    ref, out = runs
    _, jm, jparams, _ = ref["moe_mb"]
    for r in out[(2, 1)]:
        got = r["moe_mb"]
        assert got["metrics"] == out[(2, 1)][0]["moe_mb"]["metrics"]
        for t, j in zip(got["metrics"], jm):
            np.testing.assert_allclose(t["aux"], j["aux"], rtol=F32_LOSS_RTOL)
            np.testing.assert_allclose(t["loss"], j["loss"],
                                       rtol=F32_LOSS_RTOL)
            np.testing.assert_allclose(t["grad_norm"], j["grad_norm"],
                                       rtol=F32_GNORM_RTOL)
        flat = jax.tree_util.tree_flatten_with_path(got["params"])[0]
        for (kp, a), b in zip(flat, jax.tree.leaves(jparams)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                       atol=PARAM_ATOL, err_msg=str(kp))


def test_mesh_checkpoint_restores_onto_another_shape_bitwise(runs):
    _, out = runs
    for r in out[(2, 1)]:
        res = r["restore"]
        assert res["step"] == STEPS and res["all_equal"]
        assert res["leaves"] > 0 and res["sharded"] > 0


def test_mesh_manifest_is_the_one_process_layout(runs, tmp_path_factory):
    _, out = runs
    base = None
    for d in tmp_path_factory.getbasetemp().glob("lm_mesh*"):
        if (d / "mesh").exists():
            base = d
    mesh = store.read_manifest(base / "mesh")["leaves"]
    whole = store.read_manifest(base / "whole")["leaves"]
    key = [(e["path"], e["shape"], e["dtype"], e["hash"]) for e in mesh]
    assert key == [(e["path"], e["shape"], e["dtype"], e["hash"])
                   for e in whole]


def test_remesh_state_moves_a_sharded_state_bitwise(runs):
    _, out = runs
    for r in out[(2, 2)]:
        rm = r["remesh"]
        assert rm["shapes"] == [(1, 4), (2, 2)]
        assert rm["equal"] and rm["moved_sharded"]


def test_train_lm_runs_on_a_two_rank_mesh_and_prints_its_mesh_line(runs):
    _, out = runs
    for rank, r in enumerate(out[(2, 1)]):
        text = r["train_lm"]
        assert "lm mesh (2x1): axes (data, model) over 2 device(s); " \
               f"rows {rank}:{rank + 1} of {BATCH}" in text
        assert "step 1: loss=" in text and "steps 0->1" in text


@pytest.mark.parametrize("microbatches", [1, 2])
def test_one_rank_group_step_is_bitwise_the_step_without_one(tmp_path,
                                                            microbatches):
    """The same init and batches through the step without a group and
    through the mesh step on a one-rank gloo group, whole and in two
    microbatches."""
    _, cfg = _gemma()
    batches = [pipeline.SyntheticTokens(cfg.vocab, BATCH, SEQ, seed=0)
               .tensors_at(i) for i in range(2)]

    def run(mesh):
        state = state_lib.init_state(torch.Generator().manual_seed(0), cfg)
        if mesh is not None:
            state = partition.distribute(state, partition.constrained_shardings(
                state_lib.state_specs(cfg), state, mesh), mesh)
        step = step_lib.make_train_step(cfg, mesh=mesh, global_batch=BATCH,
                                        microbatches=microbatches, **CHUNKS)
        hist = []
        for b in batches:
            state, m = step(state, b)
            hist.append({k: float(v) for k, v in m.items()})
        return interop.tree_to_numpy(partition.gather(state)), hist

    plain = run(None)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        meshed = run(mesh_lib.make_mesh_from_devices())
    finally:
        dist.destroy_process_group()
    assert meshed[1] == plain[1]
    got, want = jax.tree.leaves(meshed[0]), jax.tree.leaves(plain[0])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
