"""Process meshes on ``torch.distributed``.

Port of ``repro.launch.mesh``. Where the JAX package reshapes
``jax.devices()`` into one global program's mesh, the port runs one
process per mesh shard: a mesh is a ``DeviceMesh`` over the ranks of the
process group, each rank holds one shard and launches its own kernels on
it, and the collectives of ``repro_torch.sharding.collectives`` stitch
the shards together. "Devices" in the messages below are those ranks.

Nothing here touches ``torch.distributed`` at import: the group comes up
in :func:`init_distributed` (or in the caller's own
``init_process_group``), and the meshes are built by functions.
"""
from __future__ import annotations

import datetime
import faulthandler
import math
import multiprocessing as mp
import os
import queue
import time
import traceback
import warnings
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.sharding import partition

# seconds a rendezvous may wait for the other processes (JAX's
# coordinator waits 300 s by default)
RENDEZVOUS_TIMEOUT_S = 300.0


def default_backend() -> str:
    """``nccl`` where a CUDA card is visible, ``gloo`` on the CPU."""
    return "nccl" if torch.cuda.is_available() else "gloo"


def process_count() -> int:
    """The processes of the group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def _local_devices() -> int:
    return max(torch.cuda.device_count(), 1) if torch.cuda.is_available() \
        else 1


def _info() -> dict:
    n = process_count()
    return {"distributed": dist.is_initialized() and n > 1,
            "process_index": process_index(), "process_count": n,
            "local_devices": _local_devices(),
            "global_devices": n * _local_devices()}


def _init_method(coordinator: str) -> str:
    """``host:port`` -> ``tcp://host:port``; a URL (``tcp://``,
    ``file://``, ``env://``) passes through."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     strict: bool = False,
                     backend: Optional[str] = None) -> dict:
    """Join the process group of a multi-process mesh, with a fallback.

    * The arguments default to the JAX package's variables
      (``JAX_COORDINATOR`` / ``COORDINATOR_ADDRESS``,
      ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``), then to torchrun's
      (``MASTER_ADDR`` and ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
      ``coordinator`` is ``host:port`` or an init URL.
    * ``backend`` is the caller's: :func:`default_backend` when None
      (``nccl`` with a card, ``gloo`` without). A failed ``nccl`` never
      turns into ``gloo``.
    * Idempotent: with a group already up (this call's or the caller's
      own ``init_process_group``) it returns the recorded topology.
    * Non-strict (default): a failed bring-up warns and continues as one
      process; ``strict=True`` re-raises.

    Returns ``{"distributed", "process_index", "process_count",
    "local_devices", "global_devices"}``; ``global_devices`` counts every
    process's visible devices, as ``jax.device_count()`` does.
    """
    env = os.environ
    if coordinator is None:
        coordinator = env.get("JAX_COORDINATOR") or env.get(
            "COORDINATOR_ADDRESS")
        if coordinator is None and env.get("MASTER_ADDR") \
                and env.get("MASTER_PORT"):
            coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        n = env.get("JAX_NUM_PROCESSES") or env.get("WORLD_SIZE")
        num_processes = int(n) if n else None
    if process_id is None:
        r = env.get("JAX_PROCESS_ID") or env.get("RANK")
        process_id = int(r) if r else None

    if not dist.is_initialized() and coordinator \
            and num_processes and num_processes > 1:
        backend = backend or default_backend()
        try:
            if backend == "nccl" and env.get("LOCAL_RANK"):
                # torchrun's rank on a host of several cards: its own card
                # (NCCL refuses two ranks on one)
                torch.cuda.set_device(int(env["LOCAL_RANK"]))
            dist.init_process_group(
                backend,
                init_method=_init_method(coordinator),
                world_size=num_processes, rank=process_id or 0,
                timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S))
        except Exception as e:                      # noqa: BLE001
            if strict:
                raise
            warnings.warn(
                f"torch.distributed bring-up failed ({e!r}); continuing "
                "single-process", RuntimeWarning, stacklevel=2)
    return _info()


def host_local_batch(global_batch: int) -> tuple[int, int]:
    """This process's slice of a global env batch: ``(local_batch,
    offset)``; process ``i`` owns rows ``[offset, offset + local)``. The
    global batch must divide evenly over the processes."""
    n = process_count()
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} does not divide over {n} "
            "processes; pick a multiple")
    local = global_batch // n
    return local, process_index() * local


def _mesh(shape: tuple, names: tuple, ranks=None,
          device_type: Optional[str] = None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``names`` over ``ranks`` (the
    group's, in order, by default). Without a process group a one-rank
    mesh is built without one; its collectives are the identity.

    ``device_type``: where the mesh's DTensors live; by default ``cuda``
    on an NCCL group and ``cpu`` on gloo (the MARL mesh's replicated
    state). ``cuda`` on a gloo group keeps an LM's shards on the card
    while several ranks share it: its dimension groups are gloo groups
    (``backend_override``), which take CUDA tensors."""
    n = len(ranks) if ranks is not None else process_count()
    ranks = list(range(n)) if ranks is None else list(ranks)
    grid = torch.tensor(ranks, dtype=torch.int).reshape(shape)
    if not dist.is_initialized():
        return DeviceMesh(device_type or "cpu", grid, mesh_dim_names=names,
                          _init_backend=False, _rank=0)
    backend = dist.get_backend()
    if device_type is None:
        device_type = "cuda" if backend == "nccl" else "cpu"
    if device_type == "cuda":
        # the process's card is the current one (the mesh picks none)
        torch.cuda.init()
    kw = {}
    if device_type == "cuda" and backend == "gloo":
        # gloo for the card's tensors, whatever a cuda mesh would pick
        kw["backend_override"] = (("gloo", None),) * len(shape)
    return DeviceMesh(device_type, grid, mesh_dim_names=names, **kw)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The TPU pod's (data=16, model=16) mesh, or (pod=2, data, model),
    over as many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    if process_count() != need:
        raise ValueError(f"production mesh {shape} needs {need} devices, "
                         f"the group has {process_count()}")
    return _mesh(shape, axes)


def parse_marl_mesh(spec: str) -> tuple:
    """``"ENV,AGENT"`` CLI spec -> (env, agent) shard counts.

    Raises ``ValueError`` with a usage-style message on anything that is
    not exactly two comma-separated ints, so that a malformed spec
    becomes an argparse error.
    """
    parts = spec.split(",")
    try:
        shape = tuple(int(x) for x in parts)
    except ValueError:
        shape = ()
    if len(shape) != 2:
        raise ValueError(
            f"--mesh expects ENV,AGENT (two comma-separated ints, e.g. "
            f"2,2), got {spec!r}")
    return shape


def make_marl_mesh(*, env: int = 0, agent: int = 1) -> DeviceMesh:
    """2-D ``("env", "agent")`` mesh of the MARL learner over the group.

    ``env`` splits the rollout batch, ``agent`` each environment's agents;
    IC3Net's weights are shared by the agents, so the learner state is
    replicated. ``env <= 0`` takes every rank the agent axis leaves. A
    ``(1, 1)`` mesh works in one process without a group.

    The JAX package leaves devices past ``env * agent`` idle. A process
    that holds no shard has no part in the program, so the port refuses
    a mesh that does not cover every rank.
    """
    n = process_count()
    agent = max(agent, 1)
    if env <= 0:
        if n % agent:
            raise ValueError(
                f"agent axis width {agent} does not divide {n} devices")
        env = n // agent
    if env * agent > n:
        raise ValueError(f"marl mesh ({env}, {agent}) needs "
                         f"{env * agent} devices, only {n} available")
    if env * agent < n:
        raise ValueError(
            f"marl mesh ({env}, {agent}) covers {env * agent} of the "
            f"{n} processes: every process must hold a shard (start "
            f"{env * agent} processes, or widen the mesh)")
    return _mesh((env, agent), ("env", "agent"))


def describe_marl_mesh(mesh, *, batch: int, n_agents: int) -> str:
    """What shards where on a MARL mesh: one line per mesh axis with the
    dimension it splits and each shard's part (an axis that does not
    divide its dimension is replicated, the rule of
    ``sharding.partition.constrained_pspec``)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    e, a = sizes["env"], sizes["agent"]

    def per(total: int, width: int, what: str) -> str:
        if total % width == 0:
            return f"{total // width} {what}/shard"
        return f"replicated ({total} % {width} != 0)"

    return "\n".join([
        f"marl mesh ({e}x{a}): axes (env, agent) over {e * a} device(s)",
        f"  env   [{e}]: rollout batch {batch:>4} -> "
        f"{per(batch, e, 'envs')}",
        f"  agent [{a}]: agent axis    {n_agents:>4} -> "
        f"{per(n_agents, a, 'agents')}",
        "  learner state (params/opt/plans): replicated "
        "(IC3Net weights are agent-shared)",
    ])


def model_width(n: int, model: int = 0) -> int:
    """The model axis of an elastic ``(data, model)`` mesh over ``n``
    devices: ``model`` when given, else the largest power of two <= 16
    that divides ``n``."""
    if model <= 0:
        model = 1
        while model < 16 and n % (model * 2) == 0:
            model *= 2
    assert n % model == 0, (n, model)
    return model


def make_mesh_from_devices(ranks=None, *, model: int = 0,
                           device_type: Optional[str] = None) -> DeviceMesh:
    """Elastic mesh: ``(data, model)`` over the live ranks (the group's
    by default), ``model`` wide by :func:`model_width`'s rule; the LM
    launcher's mesh. ``runtime.elastic.remesh_state`` rebuilds its mesh
    with it after the group shrinks. ``device_type``: see :func:`_mesh`."""
    n = len(ranks) if ranks is not None else process_count()
    model = model_width(n, model)
    return _mesh((n // model, model), ("data", "model"), ranks, device_type)


def describe_lm_mesh(mesh, *, batch: int, state=None, cache=None) -> str:
    """The LM mesh's line: its shape and axes, this rank's rows of the
    global batch, on a model axis wider than 1 whether the compact
    products split their capN columns over it (its ranks share their
    rows, ``partition.constraint_group``; each product splits where m
    divides its capN) or compute whole tiles (the rows spread over it)
    and, given a sharded ``state``, its bytes on this rank against the
    whole state's. Given a decode ``cache``
    (``transformer.init_cache(mesh=)``), the rows are a serving step's
    (split over ``data`` only, ``partition.batch_rows(spread=False)``)
    and the line adds the cache's bytes on this rank against the whole
    cache's."""
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    d, m = sizes["data"], sizes["model"]
    lo, hi, split = partition.batch_rows(mesh, batch, spread=cache is None)
    line = (f"lm mesh ({d}x{m}): axes (data, model) over {d * m} "
            f"device(s); rows {lo}:{hi} of {batch} (split over "
            f"{', '.join(split) or 'none'})")
    if m > 1:
        line += ("; compact columns whole (rows spread over model)"
                 if "model" in split else
                 "; compact columns split over model (rows shared)")
    if state is not None:
        local, whole = partition.state_bytes(state)
        line += f"; state {local} of {whole} bytes on this rank"
    if cache is not None:
        local, whole = partition.state_bytes(cache)
        line += f"; cache {local} of {whole} bytes on this rank"
    return line


def _to_host(tree):
    """Tensors in nested dicts, lists and tuples -> numpy arrays (a
    spawned rank's result must outlive the rank)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _rank_main(rank, world, backend, init_method, timeout_s, threads, fn,
               args, kwargs, results):
    # a rank still running a few seconds before the parent kills it
    # prints every thread's stack to stderr (where a collective hangs)
    faulthandler.dump_traceback_later(max(timeout_s - 5, 1), exit=False)
    try:
        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = _to_host(fn(*args, **kwargs))
        finally:
            dist.destroy_process_group()
        results.put((rank, None, out))
    except Exception:                               # noqa: BLE001
        # the parent raises it with this rank's traceback
        results.put((rank, traceback.format_exc(), None))


def spawn(fn, world: int, *args, backend: str, init_file: str,
          timeout_s: float = 120.0, torch_threads: Optional[int] = None,
          **kwargs) -> list:
    """``fn(*args, **kwargs)`` in ``world`` processes started with the
    ``spawn`` method, joined in one ``backend`` group through the file
    rendezvous ``init_file`` (a path that does not exist yet).

    Returns each rank's result, tensors as numpy arrays, in rank order.
    Raises with the rank's traceback when a rank fails, and
    ``TimeoutError`` when the ranks have not all reported within
    ``timeout_s`` (a hung rendezvous or collective); every process is
    joined or killed before it returns. ``fn`` must be importable by the
    children (a module-level function). ``torch_threads`` caps each
    rank's intra-op threads (ranks sharing a host's cores otherwise
    oversubscribe them).
    """
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(r, world, backend, f"file://{init_file}", timeout_s,
              torch_threads, fn, args, kwargs, results))
        for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            try:
                rank, err, out = results.get(timeout=max(left, 0.01))
            except queue.Empty:
                raise TimeoutError(
                    f"ranks {sorted(set(range(world)) - set(got))} of "
                    f"{world} did not report within {timeout_s} s") from None
            if err is not None:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{err}")
            got[rank] = out
    finally:
        # ranks that all reported exit on their own; after a failure the
        # others may wait in a collective forever
        for p in procs:
            if len(got) == world:
                p.join(timeout=30)
            if p.is_alive():
                p.kill()
            p.join()
    return [got[r] for r in range(world)]
