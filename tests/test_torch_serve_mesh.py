"""Serving on a ``(data, model)`` process mesh against the JAX package's
one-device steps.

(a) For every registry arch at full width, lockstep and per-slot, the
decode cache's placements (``transformer.cache_shardings``) are the
reference's ``constrained_pspec`` of ``cache_specs`` on (2, 2) and
(16, 16) meshes (the JAX side reads only a stand-in mesh's
``axis_names`` and ``devices`` shape). (b) gloo ranks spawned through
``launch.mesh.spawn`` at (1, 2), (2, 1) and (2, 2) serve four smoke
configs in float32 from the port's seed-0 init: gemma2-2b on the FLGW
grouped path (its window-16 ring split over the model ranks wraps from
the last rank to rank 0), mixtral (dropless dispatch on each rank's
rows), jamba (SSM state by heads, conv ring by channel) and whisper
(``encoder_out`` over ``data``). The prefill's last logits, the cache
fill's and every decode step's logits (within 1e-4) and greedy tokens
(equal) are the reference's on the same params (carried across by
``interop``, the plans with them): its ``make_prefill_step``, and the
``lm_apply`` with a cache that its ``make_decode_step`` takes the argmax
of; each rank's
cache shards are the matching slices of the reference's cache. A
per-slot cache on the mesh decodes as one process does. (c) The
column-split compact product (its plain version) equals the whole
product, where m divides capN and where it does not, with an expert
axis too. (d) The dry run of the same serve steps on a fake group
predicts every rank's collectives and state-plus-cache bytes. In one
process, a one-rank group's mesh steps are bitwise the steps without
one."""
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite's workers share the host's cores
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402
from repro import kernels as jkernels  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.core import encoder as jencoder  # noqa: E402
from repro.core import grouped as jgrouped  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serving import steps as jsteps  # noqa: E402
from repro.sharding import partition as jpart  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import grouped  # noqa: E402
from repro_torch.kernels.flgw_matmul import ops as kops  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serving import steps  # noqa: E402
from repro_torch.sharding import collectives, partition  # noqa: E402
from repro_torch.train import state as state_lib  # noqa: E402

SHAPES = ((1, 2), (2, 1), (2, 2))
B = 4
# name -> (arch, overrides, prompt, max_seq, decode steps)
CONFIGS = {
    "gemma2": ("gemma2_2b", dict(flgw_groups=4, flgw_path="grouped",
                                 flgw_targets=("mlp", "attn")), 12, 32, 6),
    "mixtral": ("mixtral_8x22b", {}, 12, 32, 4),
    "jamba": ("jamba_1_5_large", {}, 6, 16, 3),
    "whisper": ("whisper_large_v3", {}, 8, 16, 3),
}
TOL = dict(rtol=1e-4, atol=1e-4)
RANK_TIMEOUT_S = 150
# per-slot rows start at these stream offsets (their rings' slots lie on
# either model rank)
SLOT_OFFSETS = (0, 5, 11, 14)
SLOT_STEPS = 6


def _config(name, port=True):
    arch, kw, *_ = CONFIGS[name]
    if port:
        return registry.get_smoke_config(arch, dtype=torch.float32, **kw)
    return jregistry.get_smoke_config(arch, dtype=jnp.float32, **kw)


def _has_ssm(cfg) -> bool:
    return any(slot.mixer == "ssm" for slot in cfg.pattern)


def _inputs(name, cfg):
    _, _, p, _, k = CONFIGS[name]
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (B, p + k)).astype(np.int32)
    pos = np.ascontiguousarray(np.broadcast_to(
        np.arange(p + k, dtype=np.int32), (B, p + k)))
    frames = (rng.standard_normal((B, cfg.num_frames, cfg.d_model))
              .astype(np.float32) if cfg.encoder_layers else None)
    return toks, pos, frames


def _params(cfg):
    return transformer.lm_init(torch.Generator().manual_seed(0), cfg)


def _calls():
    return {op: (n, collectives.BYTES[(op, be)])
            for (op, be), n in collectives.CALLS.items()}


def _slices(x):
    """This rank's shard of one cache leaf, and for each mesh dimension
    (its width, this rank's coordinate, the tensor dim it splits)."""
    if not isinstance(x, DTensor):
        return x.numpy(), ()
    mesh = x.device_mesh
    return x.to_local().numpy(), tuple(
        (n, c, p.dim if p.is_shard() else None)
        for n, c, p in zip(tuple(mesh.shape), partition.mesh_coords(mesh),
                           x.placements))


def _serve(name, mesh=None):
    """The prefill, the cache fill (the prompt in one lockstep step, or
    token by token on an SSM model) and the decode steps of ``name``,
    teacher-forced with its fixed tokens, on ``mesh`` (None: one
    process): logits, greedy tokens, the cache's shards, collectives."""
    cfg = _config(name)
    _, _, p, t, k = CONFIGS[name]
    toks, pos, frames = (torch.from_numpy(a) if a is not None else None
                         for a in _inputs(name, cfg))
    params = _params(cfg)
    lo, hi, kw = 0, B, {}
    if mesh is not None:
        params = partition.distribute(params, partition.constrained_shardings(
            state_lib.param_specs(cfg), params, mesh), mesh)
        lo, hi, _ = partition.batch_rows(mesh, B, spread=False)
        kw = dict(mesh=mesh, global_batch=B)
    cache = transformer.init_cache(cfg, B, t, params=params, mesh=mesh,
                                   device="cpu")
    plans = cache["plans"] or None
    batch = {"tokens": toks[lo:hi, :p], "positions": pos[lo:hi, :p]}
    if frames is not None:
        batch["frames"] = frames[lo:hi]
    out = {"prefill": steps.make_prefill_step(cfg, **kw)(params, batch,
                                                         plans)}
    collectives.clear()
    trusted = steps.make_prefill_step(cfg, plan_policy="trust", **kw)(
        params, batch, plans)
    out["calls"] = {"prefill": _calls()}
    out["trust_equal"] = bool(torch.equal(trusted, out["prefill"]))
    decode = steps.make_decode_step(cfg, return_logits=True, **kw)
    spans = [(i, i + 1) for i in range(p)] if _has_ssm(cfg) else [(0, p)]
    spans += [(i, i + 1) for i in range(p, p + k)]
    logits, tokens = [], []
    for a, b in spans:
        collectives.clear()
        tok, cache, lg = decode(params, cache, toks[lo:hi, a:b],
                                pos[lo:hi, a:b])
        out["calls"][f"decode_{b - a}"] = _calls()
        if b >= p:
            logits.append(lg[:, 0].numpy())
            tokens.append(tok[:, 0].numpy())
    out.update(logits=np.stack(logits), tokens=np.stack(tokens),
               rows=(lo, hi))
    out["cache"] = {f"{slot}/{leaf}": _slices(x)
                    for slot, c in cache["blocks"].items()
                    for leaf, x in c.items()}
    if "encoder_out" in cache:
        out["cache"]["encoder_out"] = _slices(cache["encoder_out"])
    out["bytes"] = sum(partition.state_bytes(x)[0] for x in (params, cache))
    return out


def _serve_per_slot(mesh=None):
    """gemma2's config on a per-slot cache, its rows at SLOT_OFFSETS:
    SLOT_STEPS single-token steps' logits."""
    name = "gemma2"
    cfg = _config(name)
    t = CONFIGS[name][3]
    params = _params(cfg)
    lo, hi, kw = 0, B, {}
    if mesh is not None:
        params = partition.distribute(params, partition.constrained_shardings(
            state_lib.param_specs(cfg), params, mesh), mesh)
        lo, hi, _ = partition.batch_rows(mesh, B, spread=False)
        kw = dict(mesh=mesh, global_batch=B)
    cache = transformer.init_cache(cfg, B, t, params=params, mesh=mesh,
                                   per_slot=True, device="cpu")
    offsets = torch.tensor(SLOT_OFFSETS)[lo:hi]
    partition.local(cache)["pos"].copy_(offsets)
    toks = torch.from_numpy(_inputs(name, cfg)[0][lo:hi])
    decode = steps.make_decode_step(cfg, return_logits=True, **kw)
    out = []
    for i in range(SLOT_STEPS):
        _, cache, lg = decode(params, cache, toks[:, i:i + 1],
                              (offsets + i)[:, None])
        out.append(lg[:, 0].numpy())
    return np.stack(out)


# (c): (x rows, M, N, G, experts) of the compact products; N = 28 over
# G = 4 gives capN 7, which m = 2 does not divide
COMPACT = ((3, 20, 24, 4, 0), (3, 20, 28, 4, 0), (5, 16, 32, 4, 2))


def _compact_products(split: bool):
    """Each COMPACT case's product on the fused path; ``split``: under
    the constraint mesh of the calling rank's group, each with whether
    its columns were split."""
    gen = torch.Generator().manual_seed(3)
    out = []
    for b, m, n, g, e in COMPACT:
        lead = (e,) if e else ()
        x = torch.randn((*lead, b, m), generator=gen)
        w = torch.randn((*lead, m, n), generator=gen)
        plan = grouped.make_plan(torch.randn((*lead, m, g), generator=gen),
                                 torch.randn((*lead, g, n), generator=gen))
        plan = plan._replace(wc=kops.compact_weights(
            w, plan.row_ids, plan.col_ids, plan.row_valid, plan.col_valid))
        cap = plan.wc.shape[-1]
        group = partition.constraint_group("flgw_cap", cap)
        out.append((grouped._core_matmul(x, w, plan, group).numpy(),
                    group is not None))
    return out


def _rank(shape):
    """Everything one spawned rank of a ``shape`` mesh runs."""
    mesh = mesh_lib.make_mesh_from_devices(model=shape[1])
    out = {name: _serve(name, mesh) for name in CONFIGS}
    out["per_slot"] = _serve_per_slot(mesh)
    with partition.use_constraints(mesh):
        out["compact"] = _compact_products(True)
    out["describe"] = mesh_lib.describe_lm_mesh(
        mesh, batch=B, cache=transformer.init_cache(
            _config("gemma2"), B, 32, mesh=mesh, device="cpu"))
    return out


def _jax_plans(state):
    """The port's serving PlanState (compact weights attached) as the
    reference's: ids int32, the signature uint32. Both packages encode
    the same layout bitwise (``tests/test_torch_plan_encode.py``); the
    carry spares the reference an eager encode here."""
    def plan(p):
        if isinstance(p, dict):
            return {k: plan(v) for k, v in p.items()}
        return jgrouped.GroupPlan(*(
            jnp.asarray(t.numpy().astype(np.int32) if t.dtype == torch.int64
                        else t.numpy()) for t in p))
    return jencoder.PlanState(plan(state.plans), jnp.uint32(int(state.sig)))


def _jax_reference(name):
    """The reference on the port's seed-0 params and plans: its
    ``make_prefill_step``'s last logits, then the fill and decode steps'
    last logits through ``lm_apply`` with its cache
    (``make_decode_step``'s body, whose argmax is its token), and the
    final cache."""
    cfg, jcfg = _config(name), _config(name, port=False)
    _, _, p, t, k = CONFIGS[name]
    toks, pos, frames = _inputs(name, cfg)
    params = _params(cfg)
    jparams = jax.tree.map(jnp.asarray, interop.tree_to_numpy(params))
    plans = transformer.serve_plans(params, cfg)
    plans = _jax_plans(plans) if plans else None
    with jkernels.use_reference_impl():
        batch = {"tokens": jnp.asarray(toks[:, :p]),
                 "positions": jnp.asarray(pos[:, :p])}
        if frames is not None:
            batch["frames"] = jnp.asarray(frames)
        pre = jax.jit(jsteps.make_prefill_step(jcfg, plan_policy="trust"))(
            jparams, batch, plans)
        cache = dict(jtransformer.init_cache(jcfg, B, t), plans=plans or ())
        apply = jax.jit(lambda prm, tk, ps, c: jtransformer.lm_apply(
            prm, jcfg, tk, ps, cache=c, remat=False))
        spans = [(i, i + 1) for i in range(p)] if _has_ssm(cfg) \
            else [(0, p)]
        spans += [(i, i + 1) for i in range(p, p + k)]
        logits = []
        for a, b in spans:
            lg, _, cache = apply(jparams, jnp.asarray(toks[:, a:b]),
                                 jnp.asarray(pos[:, a:b]), cache)
            if b >= p:
                logits.append(np.asarray(lg[:, -1]))
    blocks = {f"{slot}/{leaf}": np.asarray(x)
              for slot, c in cache["blocks"].items() for leaf, x in c.items()}
    if "encoder_out" in cache:
        blocks["encoder_out"] = np.asarray(cache["encoder_out"])
    return {"prefill": np.asarray(pre)[:, 0], "logits": np.stack(logits),
            "cache": blocks}


@functools.lru_cache(maxsize=None)
def _one_process():
    """The port without a mesh: the per-slot run and the whole compact
    products."""
    return {"per_slot": _serve_per_slot(), "compact": _compact_products(False)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each mesh shape spawned once, the three at once; the references
    computed in this process meanwhile."""
    d = tmp_path_factory.mktemp("serve_mesh")

    def go(shape):
        return mesh_lib.spawn(
            _rank, shape[0] * shape[1], shape, backend="gloo",
            init_file=str(d / f"rdv_{shape[0]}{shape[1]}"),
            timeout_s=RANK_TIMEOUT_S, torch_threads=1)

    with ThreadPoolExecutor(len(SHAPES)) as ex:
        futures = {s: ex.submit(go, s) for s in SHAPES}
        ref = {name: _jax_reference(name) for name in CONFIGS}
        ref.update(_one_process())
        out = {s: f.result() for s, f in futures.items()}
    return ref, out


def _cut(whole, info):
    """The slice of ``whole`` a rank's shard holds (``_slices``' info)."""
    for n, c, dim in info:
        if dim is not None:
            whole = np.split(whole, n, axis=dim)[c]
    return whole


IDS = [f"{s[0]}x{s[1]}" for s in SHAPES]


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_mesh_serving_matches_jax_single_device_steps(runs, name, shape):
    ref, out = runs
    want = ref[name]
    for r in out[shape]:
        got = r[name]
        lo, hi = got["rows"]
        assert hi - lo == B // shape[0]
        np.testing.assert_allclose(got["prefill"][:, 0],
                                   want["prefill"][lo:hi], **TOL)
        assert got["trust_equal"]
        np.testing.assert_allclose(got["logits"], want["logits"][:, lo:hi],
                                   **TOL)
        np.testing.assert_array_equal(
            got["tokens"], want["logits"][:, lo:hi].argmax(-1))
        sharded = 0
        for key, (local, info) in got["cache"].items():
            np.testing.assert_allclose(local, _cut(want["cache"][key], info),
                                       **TOL, err_msg=key)
            sharded += local.size < want["cache"][key].size
        assert sharded > 0
        if shape[1] > 1:
            # the model ranks split the KV sequence or the SSM state
            assert any(dim == 2 and n > 1 for k, (_, info) in
                       got["cache"].items() for n, _, dim in info)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_per_slot_cache_on_a_mesh_decodes_as_one_process(runs, shape):
    ref, out = runs
    for rank, r in enumerate(out[shape]):
        lo = (rank // shape[1]) * (B // shape[0])
        np.testing.assert_allclose(
            r["per_slot"], ref["per_slot"][:, lo:lo + B // shape[0]], **TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_column_split_compact_product_is_the_whole_product(runs, shape):
    """Where m divides capN the columns split (capN 6 and 8 over 2);
    capN 7 stays whole on every rank; the result is the whole product's
    either way."""
    ref, out = runs
    for r in out[shape]:
        for (got, split), (want, _), case in zip(r["compact"],
                                                 ref["compact"], COMPACT):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                       err_msg=str(case))
            cap = -(-case[2] // case[3])
            assert split == (shape[1] > 1 and cap % shape[1] == 0)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_dry_run_predicts_the_serving_ranks_collectives(runs, shape):
    """``launch.dryrun`` of gemma2's prefill (under ``trust``), its cache
    fill and a decode step on ``meta`` over a fake group of the same
    shape: each call's collectives (calls and bytes by operation) and
    the state-plus-cache bytes every spawned rank counted."""
    from repro_torch.launch import dryrun
    _, out = runs
    cfg = _config("gemma2")
    _, _, p, t, _ = CONFIGS["gemma2"]
    kw = dict(cfg=cfg, batch=B, mesh_shape=shape, save=False, flgw_groups=4,
              flgw_path="grouped")
    cells = {"prefill": dryrun.run_cell("gemma2_2b", "prefill_32k", seq=p,
                                        **kw),
             f"decode_{p}": dryrun.run_cell("gemma2_2b", "decode_32k",
                                            seq=t, new_tokens=p, **kw),
             "decode_1": dryrun.run_cell("gemma2_2b", "decode_32k", seq=t,
                                         **kw)}
    for call, res in cells.items():
        pred = {op: (c["calls"], c["bytes"])
                for op, c in res["collectives"].items()}
        assert pred and all(n > 0 for n, _ in pred.values())
        for r in out[shape]:
            assert r["gemma2"]["calls"][call] == pred, call
    for r in out[shape]:
        assert r["gemma2"]["bytes"] == cells["decode_1"][
            "state_bytes_per_chip"]
        assert r["gemma2"]["bytes"] < cells["decode_1"]["state_bytes_whole"]


def test_describe_lm_mesh_gives_serving_rows_and_cache_bytes(runs):
    _, out = runs
    for rank, r in enumerate(out[(1, 2)]):
        assert r["describe"].startswith(
            "lm mesh (1x2): axes (data, model) over 2 device(s); rows 0:4 "
            "of 4 (split over data)")
        assert "; cache " in r["describe"] and " bytes on this rank" in \
            r["describe"]
    for rank, r in enumerate(out[(2, 2)]):
        lo = (rank // 2) * 2
        assert f"rows {lo}:{lo + 2} of 4 (split over data)" in r["describe"]


class _FakeMesh:
    """What ``constrained_pspec`` reads of a mesh, in both packages."""

    axis_names = ("data", "model")

    def __init__(self, shape):
        self.devices = np.empty(shape)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_cache_placements_are_the_references(arch):
    """Each leaf of a decode cache at the arch's decode cells (and
    ``long_500k``'s batch of 1 where it has one), lockstep and per-slot,
    resolved on (2, 2) and (16, 16) meshes: the reference's
    ``constrained_pspec`` of its ``cache_specs`` on the same shapes, and
    the placements the port builds its DTensors with."""
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    cells = [registry.SHAPES[s][:2] for s in registry.cells(arch)
             if registry.SHAPES[s][2] == "decode"]
    for seq, batch in cells:
        for per_slot in (False, True):
            cache = transformer.init_cache(cfg, batch, seq, device="meta",
                                           per_slot=per_slot)
            jcache = jax.eval_shape(lambda: jtransformer.init_cache(
                jcfg, batch, seq, per_slot=per_slot))
            jspecs = jtransformer.cache_specs(jcfg, per_slot=per_slot)
            for shape in ((2, 2), (16, 16)):
                mesh = _FakeMesh(shape)
                placed = transformer.cache_shardings(cfg, cache, mesh,
                                                     per_slot=per_slot)
                for path, spec, leaf, jleaf, pl in _walk(
                        jspecs, cache, jcache, placed):
                    assert tuple(leaf.shape) == tuple(jleaf.shape), path
                    want = jpart.constrained_pspec(spec, jleaf.shape, mesh)
                    got = partition.constrained_pspec(spec, leaf.shape, mesh)
                    assert tuple(got) == tuple(want), (path, shape)
                    assert pl == partition.placements(got, mesh), path


def _walk(specs, cache, jcache, placed, path=""):
    """(path, spec, port leaf, JAX leaf, placements) of every tensor leaf
    of a cache (its empty plans off the grouped path hold none)."""
    if isinstance(specs, dict):
        for k in specs:
            yield from _walk(specs[k], cache[k], jcache[k], placed[k],
                             f"{path}/{k}")
    elif hasattr(cache, "shape"):
        yield path, specs, cache, jcache, placed


def test_serve_rows_split_over_data_only_and_drop_what_does_not_divide():
    mesh = _FakeMesh((2, 2))
    mesh.get_coordinate = lambda: (1, 1)
    assert partition.batch_rows(mesh, 4, spread=False) == (2, 4, ("data",))
    assert partition.batch_rows(mesh, 4) == (3, 4, ("data", "model"))
    assert partition.batch_rows(mesh, 1, spread=False) == (0, 1, ())
    with pytest.raises(ValueError, match="does not divide"):
        partition.batch_rows(mesh, 1)


def test_one_rank_group_serving_is_bitwise_the_steps_without_one(tmp_path):
    """gemma2's prefill, fill and decode steps through the mesh steps on
    a one-rank gloo group and without one: every logit, token and cache
    leaf equal."""
    plain = _serve("gemma2")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        meshed = _serve("gemma2", mesh_lib.make_mesh_from_devices())
    finally:
        dist.destroy_process_group()
    for key in ("prefill", "logits", "tokens"):
        np.testing.assert_array_equal(np.asarray(meshed[key]),
                                      np.asarray(plain[key]))
    for key, (local, _) in plain["cache"].items():
        np.testing.assert_array_equal(meshed["cache"][key][0], local)


def test_compact_widths_name_the_columns_that_fall_to_wmma():
    """``dryrun.compact_widths``: each projection's capN is its plan's
    (the smoke config's encode), and at full width gemma2-2b's column
    shards are multiples of 8 on 2 model ranks but its MLP's (180 of
    2,880) and k/v's (20 of 320) are not on 16; mamba2's in projection
    (2,660, not a multiple of 8) splits on 2 and stays whole on 16."""
    from repro_torch.launch import dryrun
    cfg = _config("gemma2")
    plans = transformer.serve_plans(_params(cfg), cfg)
    for w in dryrun.compact_widths(cfg, 2):
        node = plans.plans
        for k in w["path"].split("/"):
            node = node[k]
        assert node.wc.shape[-1] == w["cap_n"], w
    full = registry.get_config("gemma2_2b", flgw_groups=4,
                               flgw_path="grouped",
                               flgw_targets=("mlp", "attn"))
    two = {w["path"]: w for w in dryrun.compact_widths(full, 2)}
    assert all(w["split"] and w["wgmma_or_streaming"] for w in two.values())
    assert two["blocks/slot0/ffn/up"]["cols"] == 1440
    sixteen = {w["path"]: w for w in dryrun.compact_widths(full, 16)}
    assert sixteen["blocks/slot0/mixer/q"]["cols"] == 40
    assert sixteen["blocks/slot0/mixer/q"]["wgmma_or_streaming"]
    for path, cols in (("ffn/up", 180), ("mixer/k", 20)):
        w = sixteen[f"blocks/slot0/{path}"]
        assert w["cols"] == cols and not w["wgmma_or_streaming"]
    mamba = registry.get_config("mamba2_1_3b", flgw_groups=4,
                                flgw_path="grouped", flgw_targets=("ssm",))
    w2, w16 = (next(w for w in dryrun.compact_widths(mamba, m)
                    if w["path"].endswith("mixer/in")) for m in (2, 16))
    assert (w2["cols"], w2["split"], w2["wgmma_or_streaming"]) == \
        (1330, True, False)
    assert (w16["cols"], w16["split"]) == (2660, False)
