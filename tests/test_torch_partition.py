"""The port's ``sharding/partition.py`` against the JAX package's: the
``tests/test_substrate.py`` sharding cases, a seeded sweep of logical
specs and shapes on fake meshes, the DTensor placements the port gives
where JAX builds a ``NamedSharding``, and ``runtime/elastic.py``'s
``remesh_state`` round trip in one process and on 2 gloo ranks."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite's workers share the host's cores
jax = pytest.importorskip("jax")

import torch.distributed as dist  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from repro.sharding import partition as jpart  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.runtime import remesh_state  # noqa: E402
from repro_torch.sharding import partition  # noqa: E402
from repro_torch.sharding.partition import P  # noqa: E402
from torch.distributed.device_mesh import DeviceMesh  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402


def _fake(axes, shape):
    """A mesh of only names and a shape, as the reference's tests use."""
    class FakeMesh:
        axis_names = axes

        class devices:
            pass
    FakeMesh.devices.shape = shape
    return FakeMesh()


def _device_mesh(axes, shape):
    n = int(np.prod(shape))
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=axes, _init_backend=False, _rank=0)


def _mesh2():
    """The reference's one-device (data, model) mesh and the port's."""
    jm = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    return jm, _device_mesh(("data", "model"), (1, 1))


def test_constrained_pspec_drops_nondivisible_axes():
    jm, tm = _mesh2()
    # 1-wide axes always divide: spec survives
    got = partition.constrained_pspec(("batch", None), (8, 4), tm)
    assert got == P("data") == ("data",)
    assert tuple(got) == tuple(jpart.constrained_pspec(("batch", None),
                                                       (8, 4), jm))
    # unknown names replicate
    assert partition.constrained_pspec(("nope",), (8,), tm) == P() == ()


def test_constrained_pspec_divisibility_on_fake_mesh():
    fm = _fake(("data", "model"), (16, 16))
    # kv_heads = 8 on a 16-wide model axis -> dropped
    assert partition.constrained_pspec(
        ("layers", "batch", "seq_kv", "kv_heads"), (4, 128, 4096, 8),
        fm) == P(None, "data", "model")
    # batch=1 cannot shard
    assert partition.constrained_pspec(("batch",), (1,), fm) == P()
    # two-axis batch: (pod, data) with pod missing -> data only
    assert partition.constrained_pspec(("batch",), (256,), fm) == P("data")


def test_logical_rules_one_axis_per_tensor():
    fm = _fake(("data", "model"), (16, 16))
    # "ffn" then "heads" both want model: second one must drop
    got = partition.constrained_pspec(("ffn", "heads"), (256, 256), fm)
    assert got == P("model")


def test_rules_table_and_trailing_none_trim_match_jax():
    assert partition.LOGICAL_RULES == jpart.LOGICAL_RULES
    assert P("data", None, None) == ("data",)
    assert P(None, ("pod", "data"), None) == (None, ("pod", "data"))


_NAMES = [None, "nope", *sorted(jpart.LOGICAL_RULES)]
_DIMS = (1, 2, 3, 4, 6, 8, 12, 16, 32, 48, 128, 256)
_MESHES = [(("data", "model"), (16, 16)),
           (("pod", "data", "model"), (2, 16, 16)),
           (("data", "model"), (2, 2)), (("env", "agent"), (2, 2))]


@pytest.mark.parametrize("axes,shape", _MESHES)
def test_seeded_spec_sweep_matches_jax(axes, shape):
    """400 seeded (spec, shape) pairs a mesh: ``logical_to_pspec``,
    ``constrained_pspec``, ``batch_pspec`` and ``activation_rules`` equal
    JAX's, on the fake mesh and on a DeviceMesh of the same shape."""
    rng = np.random.default_rng(sum(shape))
    meshes = (_fake(axes, shape), _device_mesh(axes, shape))
    jm = _fake(axes, shape)
    for _ in range(400):
        n = int(rng.integers(1, 5))
        spec = tuple(_NAMES[i] for i in rng.integers(0, len(_NAMES), n))
        dims = tuple(int(_DIMS[i]) for i in rng.integers(0, len(_DIMS), n))
        want_l = tuple(jpart.logical_to_pspec(spec, jm))
        want_c = tuple(jpart.constrained_pspec(spec, dims, jm))
        for m in meshes:
            assert tuple(partition.logical_to_pspec(spec, m)) == want_l, spec
            assert tuple(partition.constrained_pspec(spec, dims, m)) \
                == want_c, (spec, dims)
    for m in meshes:
        for ndim in (1, 2, 3):
            assert tuple(partition.batch_pspec(m, ndim)) == tuple(
                jpart.batch_pspec(jm, ndim))
        assert {k: tuple(v) for k, v in
                partition.activation_rules(m).items()} == {
            k: tuple(v) for k, v in jpart.activation_rules(jm).items()}


def test_placements_follow_the_pspec():
    m = _device_mesh(("pod", "data", "model"), (2, 2, 2))
    assert partition.placements(P(("pod", "data"), "model"), m) == (
        Shard(0), Shard(0), Shard(1))
    assert partition.placements(P(None, "model"), m) == (
        Replicate(), Replicate(), Shard(1))
    assert partition.batch_sharding(m, 3) == (Shard(0), Shard(0),
                                              Replicate())
    specs = {"w": ("embed", "ffn"), "b": ("ffn",), "n": {"s": ()},
             "l": [("vocab", "embed")]}
    got = partition.shardings_for(specs, m)
    assert got == partition.param_shardings(specs, m)
    assert got == {"w": (Replicate(), Shard(0), Shard(1)),
                   "b": (Replicate(), Replicate(), Shard(0)),
                   "n": {"s": (Replicate(),) * 3},
                   "l": [(Replicate(), Shard(1), Shard(0))]}
    shaped = {"w": torch.zeros(6, 8), "b": torch.zeros(3), "n": {
        "s": torch.zeros(())}, "l": [torch.zeros(8, 6)]}
    # 6 % 2 == 0 keeps data on w's embed dim; 3 % 2 drops model on b
    assert partition.constrained_shardings(specs, shaped, m) == {
        "w": (Replicate(), Shard(0), Shard(1)),
        "b": (Replicate(),) * 3, "n": {"s": (Replicate(),) * 3},
        "l": [(Replicate(), Shard(1), Shard(0))]}


def test_constrain_is_the_identity_inside_use_constraints():
    m = _device_mesh(("data", "model"), (2, 2))
    x = torch.arange(8.0).reshape(4, 2)
    assert partition.constrain(x, ("batch", None)) is x
    with partition.use_constraints(m):
        assert partition._CONSTRAINT_MESH[-1] is m
        assert partition.constrain(x, ("batch", "ffn")) is x
    assert partition._CONSTRAINT_MESH == []


_STATE_SPECS = {"w": ("embed", "ffn"), "b": ("ffn",), "e": ("vocab", None),
                "opt": {"mu": ("embed", "ffn")}}


def _state():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(8, 6, generator=g),
            "b": torch.randn(3, generator=g),
            "e": torch.randn(10, 4, generator=g),
            "opt": {"mu": torch.randn(8, 6, generator=g)}}


def _remesh_round_trip():
    """remesh_state on this group; each leaf's placements, local shape and
    ``full_tensor()``."""
    state = _state()
    new, mesh = remesh_state(state, _STATE_SPECS)
    out = {"mesh": (tuple(mesh.shape), mesh.mesh_dim_names)}
    for k, leaf in [("w", new["w"]), ("b", new["b"]), ("e", new["e"]),
                    ("mu", new["opt"]["mu"])]:
        full = leaf.full_tensor()
        want = state["opt"]["mu"] if k == "mu" else state[k]
        out[k] = (tuple(p.dim if p.is_shard() else None
                        for p in leaf.placements),
                  tuple(leaf.to_local().shape), bool(torch.equal(full, want)))
    return out


def test_remesh_state_round_trips_in_one_process(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        out = _remesh_round_trip()
    finally:
        dist.destroy_process_group()
    assert out["mesh"] == ((1, 1), ("data", "model"))
    for k in ("w", "b", "e", "mu"):
        assert out[k][2], k


def test_remesh_state_round_trips_on_two_ranks(tmp_path):
    """Two ranks: model_width(2) = 2, so (data=1, model=2); "ffn" splits
    w's 6 columns, b's 3 do not divide and replicate, "vocab" splits e's
    10 rows."""
    ranks = mesh_lib.spawn(_remesh_round_trip, 2, backend="gloo",
                           init_file=str(tmp_path / "rdv"), timeout_s=90,
                           torch_threads=1)
    for r in ranks:
        assert r["mesh"] == ((1, 2), ("data", "model"))
        # each mesh dim's Shard dim, None for Replicate
        assert r["w"] == ((0, 1), (8, 3), True)
        assert r["b"] == ((None, None), (3,), True)
        assert r["e"] == ((None, 0), (5, 4), True)
        assert r["mu"] == r["w"]
