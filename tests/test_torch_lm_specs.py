"""The LM's sharding spec trees against the JAX package's, in one process.

For every architecture of the registry, at its smoke config, dense and
grouped (FLGW on every target the model has): ``param_specs``,
``state_specs`` (AdamW and RMSprop), ``plan_specs`` (with and without
the compact weights) and ``cache_specs`` (a shared and a per-slot
position) equal the reference's exactly, leaf path by leaf path;
``abstract_state``'s shapes and dtypes equal ``jax.eval_shape``'s (the
plans' index leaves are int64 in the port where JAX's are int32 and
uint32, by design, ROADMAP Queue 3); and every state leaf's
``constrained_pspec`` equals the reference's on five meshes."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite's workers share the host's cores
jax = pytest.importorskip("jax")

from repro import kernels as jkernels  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.sharding import partition as jpart  # noqa: E402
from repro.train import state as jstate  # noqa: E402
from repro_torch.checkpoint.store import tree_paths  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.sharding import partition  # noqa: E402
from repro_torch.train import state as state_lib  # noqa: E402

ARCHS = registry.ARCH_IDS
VARIANTS = ("dense", "grouped")
CASES = [(a, v) for a in ARCHS for v in VARIANTS]
IDS = [f"{a}-{v}" for a, v in CASES]
MESHES = ((1, 1), (2, 1), (1, 2), (2, 2), (16, 16))
# every FLGW target; a model uses those its slots have
GROUPED = dict(flgw_groups=4, flgw_path="grouped",
               flgw_targets=("mlp", "attn", "moe", "ssm"))


def _configs(arch, variant):
    kw = GROUPED if variant == "grouped" else {}
    return (jregistry.get_smoke_config(arch, **kw),
            registry.get_smoke_config(arch, **kw))


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _spec_paths(tree, prefix=""):
    """``(keystr path, spec)`` of a port spec tree, a spec tuple a leaf,
    in JAX's flatten order."""
    if tree is None:
        return []
    if _is_spec(tree):
        return [(prefix, tree)]
    if hasattr(tree, "_fields"):
        return [pl for f in tree._fields
                for pl in _spec_paths(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _spec_paths(tree[k], f"{prefix}[{k!r}]")]
    return [pl for i, v in enumerate(tree)
            for pl in _spec_paths(v, f"{prefix}[{i}]")]


def _jax_spec_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=_is_spec)
    return [(jax.tree_util.keystr(p), s) for p, s in flat]


def _assert_same_specs(got, want):
    got, want = _spec_paths(got), _jax_spec_paths(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        assert tuple(a) == tuple(b), p


@functools.lru_cache(maxsize=None)
def _jax(arch, variant) -> dict:
    """The reference's trees of one case, computed once: each spec tree
    and the eval_shape state as (path, shape, dtype). The plan encode
    traces through its plain reference (the same shapes and dtypes as the
    Pallas kernels', in a fraction of the tracing time)."""
    jcfg, _ = _configs(arch, variant)
    with jkernels.use_reference_impl():     # shapes only: skip the Pallas
        return _jax_trees(jcfg)


def _jax_trees(jcfg) -> dict:
    jab = jstate.abstract_state(jcfg)
    return {
        "params": jstate.param_specs(jcfg),
        "adamw": jstate.state_specs(jcfg, optimizer="adamw"),
        "rmsprop": jstate.state_specs(jcfg, optimizer="rmsprop"),
        "plans": jstate.plan_specs(jcfg),
        "plans_compact": jtransformer.plan_specs(jcfg, compact=True),
        "cache": jtransformer.cache_specs(jcfg),
        "cache_per_slot": jtransformer.cache_specs(jcfg, per_slot=True),
        "abstract": [(jax.tree_util.keystr(p), tuple(a.shape),
                      np.dtype(a.dtype)) for p, a in
                     jax.tree_util.tree_flatten_with_path(jab)[0]]}


@pytest.mark.parametrize("arch,variant", CASES, ids=IDS)
def test_param_and_state_specs_match_jax(arch, variant):
    _, tcfg = _configs(arch, variant)
    want = _jax(arch, variant)
    _assert_same_specs(state_lib.param_specs(tcfg), want["params"])
    for opt in ("adamw", "rmsprop"):
        _assert_same_specs(state_lib.state_specs(tcfg, optimizer=opt),
                           want[opt])


@pytest.mark.parametrize("arch,variant", CASES, ids=IDS)
def test_plan_and_cache_specs_match_jax(arch, variant):
    _, tcfg = _configs(arch, variant)
    want = _jax(arch, variant)
    _assert_same_specs(transformer.plan_specs(tcfg), want["plans"])
    _assert_same_specs(transformer.plan_specs(tcfg, compact=True),
                       want["plans_compact"])
    _assert_same_specs(state_lib.plan_specs(tcfg), want["plans"])
    _assert_same_specs(transformer.cache_specs(tcfg), want["cache"])
    _assert_same_specs(transformer.cache_specs(tcfg, per_slot=True),
                       want["cache_per_slot"])


# the plans' index leaves: int64 in the port (ROADMAP Queue 3, by design)
_PLAN_DTYPES = {np.dtype(np.int32): torch.int64,
                np.dtype(np.uint32): torch.int64}
_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.int32): torch.int32, np.dtype(bool): torch.bool}


@pytest.mark.parametrize("arch,variant", CASES, ids=IDS)
def test_abstract_state_matches_eval_shape(arch, variant):
    jflat = _jax(arch, variant)["abstract"]
    got = tree_paths(state_lib.abstract_state(_configs(arch, variant)[1]))
    assert [p for p, _ in got] == [p for p, _, _ in jflat]
    for (path, t), (_, shape, dtype) in zip(got, jflat):
        assert t.device.type == "meta", path
        assert tuple(t.shape) == shape, path
        if path.startswith(".plans"):
            want = _PLAN_DTYPES.get(dtype, _DTYPES.get(dtype))
        elif dtype.name == "bfloat16":
            want = torch.bfloat16
        else:
            want = _DTYPES[dtype]
        assert t.dtype == want, path


def _fake_mesh(shape):
    class FakeMesh:
        axis_names = ("data", "model")

        class devices:
            pass
    FakeMesh.devices.shape = shape
    return FakeMesh()


@pytest.mark.parametrize("arch,variant", CASES, ids=IDS)
def test_constrained_pspecs_of_every_state_leaf_match_jax(arch, variant):
    want = _jax(arch, variant)
    spec_of = dict(_spec_paths(state_lib.state_specs(
        _configs(arch, variant)[1])))
    assert spec_of == dict(_jax_spec_paths(want["adamw"]))
    jflat = want["abstract"]
    for shape in MESHES:
        mesh = _fake_mesh(shape)
        for path, leaf_shape, _ in jflat:
            got = partition.constrained_pspec(spec_of[path], leaf_shape, mesh)
            want = jpart.constrained_pspec(spec_of[path], leaf_shape, mesh)
            assert tuple(got) == tuple(want), (shape, path)


def test_reference_constrained_shardings_fault_off_the_grouped_path():
    """Off the grouped path the state's plans are ``()`` in both trees;
    the reference's ``constrained_shardings`` takes the spec ``()`` for a
    leaf and reads its ``.shape`` from the empty tuple, so its launcher
    raises at every non-grouped config (ROADMAP Queue 3). The port keeps
    the empty plans empty."""
    jcfg, tcfg = _configs("gemma2_2b", "dense")
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    with pytest.raises(AttributeError, match="shape"):
        jpart.constrained_shardings(jstate.state_specs(jcfg),
                                    jstate.abstract_state(jcfg), jmesh)
    mesh = _fake_mesh((2, 2))
    shardings = partition.constrained_shardings(
        state_lib.state_specs(tcfg), state_lib.abstract_state(tcfg), mesh)
    assert shardings.plans == ()
    assert shardings.params["embed"]["embedding"] == \
        partition.placements(partition.P("model", "data"), mesh)
