"""The port's ``launch/mesh.py`` against the JAX package's: the bring-up
and host-local batch cases of ``tests/test_async.py``, the MARL mesh's
parser, constructor and description messages, the elastic mesh's width
rule, and the spawn helper every multi-process test runs on."""
import socket
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite's workers share the host's cores
jax = pytest.importorskip("jax")

from jax.sharding import Mesh  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from torch.distributed.device_mesh import DeviceMesh  # noqa: E402

_DIST_VARS = ("JAX_COORDINATOR", "COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
              "RANK", "LOCAL_RANK")


def _no_dist_env(monkeypatch):
    for var in _DIST_VARS:
        monkeypatch.delenv(var, raising=False)


def _dead_port() -> int:
    """A localhost port nothing listens on."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _fake_mesh(shape):
    """An ("env", "agent") DeviceMesh of ``shape`` built without a group
    (only its names and shape are read) and JAX's over one device."""
    n = shape[0] * shape[1]
    tm = DeviceMesh("cpu", torch.arange(n).reshape(shape),
                    mesh_dim_names=("env", "agent"), _init_backend=False,
                    _rank=0)
    jm = Mesh(np.array([jax.devices()[0]] * n).reshape(shape),
              ("env", "agent"))
    return tm, jm


def test_init_distributed_falls_back_to_single_process(monkeypatch):
    _no_dist_env(monkeypatch)
    info = mesh_lib.init_distributed(backend="gloo")
    assert set(info) == set(jmesh.init_distributed())
    assert info["distributed"] is False
    assert info["process_count"] == 1 and info["process_index"] == 0
    assert info["global_devices"] >= info["local_devices"] >= 1
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_init_distributed_binds_a_torchrun_rank_to_its_card(monkeypatch,
                                                            backend):
    """torchrun's rank 1 of 2 on a host of several cards (``LOCAL_RANK``
    1): on NCCL it takes card 1 before the group comes up, so the
    launcher's default device (``resolve_device``, the current card) is
    its own; gloo leaves the current card alone. The card and the group
    are faked: only the calls are recorded."""
    _no_dist_env(monkeypatch)
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_dead_port()),
                     WORLD_SIZE="2", RANK="1", LOCAL_RANK="1").items():
        monkeypatch.setenv(k, v)
    calls, card = [], [0]

    def set_device(i):
        calls.append(("set_device", i))
        card[0] = i

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: card[0])
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda b, **kw: calls.append(
                            ("init", b, kw["rank"], kw["world_size"])))
    mesh_lib.init_distributed(strict=True, backend=backend)
    bound = [("set_device", 1)] if backend == "nccl" else []
    assert calls == [*bound, ("init", backend, 1, 2)]
    assert resolve_device() == torch.device(
        "cuda", 1 if backend == "nccl" else 0)


def test_host_local_batch_slices_evenly(monkeypatch):
    local, offset = mesh_lib.host_local_batch(16)
    assert (local, offset) == (16, 0)      # single process owns everything
    # a simulated 4-process topology: process 2 owns rows [8, 12)
    monkeypatch.setattr(mesh_lib, "process_count", lambda: 4)
    monkeypatch.setattr(mesh_lib, "process_index", lambda: 2)
    assert mesh_lib.host_local_batch(16) == (4, 8)
    with pytest.raises(ValueError, match="does not divide"):
        mesh_lib.host_local_batch(17)


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("source", ["args", "torchrun"])
def test_init_distributed_with_a_dead_coordinator(monkeypatch, strict,
                                                  source):
    """A coordinator nobody serves: ``strict`` raises, the default warns
    and continues as one process; the address comes from the arguments or
    from torchrun's variables."""
    _no_dist_env(monkeypatch)
    monkeypatch.setattr(mesh_lib, "RENDEZVOUS_TIMEOUT_S", 1.0)
    port = _dead_port()
    if source == "args":
        args = (f"127.0.0.1:{port}", 2, 1)
    else:
        args = ()
        for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                         WORLD_SIZE="2", RANK="1").items():
            monkeypatch.setenv(k, v)
    if strict:
        with pytest.raises(Exception):
            mesh_lib.init_distributed(*args, strict=True, backend="gloo")
    else:
        with pytest.warns(RuntimeWarning, match="continuing single-process"):
            info = mesh_lib.init_distributed(*args, backend="gloo")
        assert info["distributed"] is False and info["process_count"] == 1
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("spec", ["2,2", "1,1", "4,1", "2x2", "1,2,3",
                                  "a,b", "", "2,"])
def test_parse_marl_mesh_matches_jax(spec):
    try:
        want = jmesh.parse_marl_mesh(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh_lib.parse_marl_mesh(spec)
        assert str(got.value) == str(e)
    else:
        assert mesh_lib.parse_marl_mesh(spec) == want


@pytest.mark.parametrize("kw", [dict(env=2, agent=2), dict(env=0, agent=2),
                                dict(env=1, agent=1), dict(env=0, agent=1),
                                dict(env=-1, agent=0), dict(env=3, agent=1)])
def test_make_marl_mesh_matches_jax_in_one_process(monkeypatch, kw):
    """One process is the JAX package's one CPU device: the same meshes
    and the same messages ("needs N devices, only M available")."""
    _no_dist_env(monkeypatch)
    assert len(jax.devices()) == 1
    try:
        want = jmesh.make_marl_mesh(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh_lib.make_marl_mesh(**kw)
        assert str(got.value) == str(e)
    else:
        got = mesh_lib.make_marl_mesh(**kw)
        assert got.mesh_dim_names == tuple(want.axis_names)
        assert tuple(got.shape) == want.devices.shape
        assert list(got.get_coordinate()) == [0, 0]


def test_make_marl_mesh_refuses_ranks_it_leaves_idle(monkeypatch):
    """JAX leaves devices past env * agent idle; the port refuses a mesh
    that leaves a process without a shard (ROADMAP Queue 3)."""
    monkeypatch.setattr(mesh_lib, "process_count", lambda: 4)
    with pytest.raises(ValueError, match="covers 2 of the 4 processes"):
        mesh_lib.make_marl_mesh(env=2, agent=1)
    with pytest.raises(ValueError, match="needs 8 devices, only 4"):
        mesh_lib.make_marl_mesh(env=4, agent=2)


@pytest.mark.parametrize("shape,batch,agents", [
    ((1, 1), 16, 8), ((2, 2), 16, 8), ((2, 4), 16, 8), ((4, 4), 6, 8),
    ((3, 2), 16, 3), ((8, 1), 4, 2)])
def test_describe_marl_mesh_matches_jax(shape, batch, agents):
    tm, jm = _fake_mesh(shape)
    want = jmesh.describe_marl_mesh(jm, batch=batch, n_agents=agents)
    assert mesh_lib.describe_marl_mesh(tm, batch=batch,
                                       n_agents=agents) == want


def test_describe_marl_mesh_of_a_built_mesh_matches_jax(monkeypatch):
    _no_dist_env(monkeypatch)
    want = jmesh.describe_marl_mesh(jmesh.make_marl_mesh(env=1, agent=1),
                                    batch=16, n_agents=8)
    got = mesh_lib.describe_marl_mesh(mesh_lib.make_marl_mesh(env=1,
                                                              agent=1),
                                      batch=16, n_agents=8)
    assert got == want and "replicated" in got


def test_make_mesh_from_devices_width_rule_matches_jax():
    """The (data, model) shape for every device count 1..512, and a
    forced model width."""
    dev = jax.devices()[0]
    for n in range(1, 513):
        want = jmesh.make_mesh_from_devices([dev] * n).devices.shape
        assert (n // mesh_lib.model_width(n), mesh_lib.model_width(n)) \
            == want, n
    got = mesh_lib.make_mesh_from_devices(list(range(12)), model=3)
    want = jmesh.make_mesh_from_devices([dev] * 12, model=3)
    assert tuple(got.shape) == want.devices.shape
    assert got.mesh_dim_names == tuple(want.axis_names)


def test_make_production_mesh_needs_its_devices(monkeypatch):
    _no_dist_env(monkeypatch)
    with pytest.raises(ValueError, match="needs 256 devices"):
        mesh_lib.make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 devices"):
        mesh_lib.make_production_mesh(multi_pod=True)


def _rank_info():
    return (torch.distributed.get_rank(),
            mesh_lib.init_distributed(backend="gloo"),
            mesh_lib.host_local_batch(8))


def _rank_fails():
    if torch.distributed.get_rank() == 1:
        raise ValueError("rank 1 breaks")
    return 0


def _rank_hangs():
    if torch.distributed.get_rank() == 1:
        import time
        time.sleep(60)
    return 0


def test_spawn_joins_a_group_and_reports_in_rank_order(tmp_path):
    out = mesh_lib.spawn(_rank_info, 2, backend="gloo",
                         init_file=str(tmp_path / "rdv"), timeout_s=60,
                         torch_threads=1)
    for rank, (r, info, local) in enumerate(out):
        assert r == rank and info["distributed"] is True
        assert info["process_count"] == 2 and info["process_index"] == rank
        assert local == (4, 4 * rank)


def test_spawn_fails_a_failing_rank_and_times_out_a_hung_one(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 breaks"):
        mesh_lib.spawn(_rank_fails, 2, backend="gloo",
                       init_file=str(tmp_path / "a"), timeout_s=60,
                       torch_threads=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(TimeoutError, match="did not report within"):
            mesh_lib.spawn(_rank_hangs, 2, backend="gloo",
                           init_file=str(tmp_path / "b"), timeout_s=5,
                           torch_threads=1)
