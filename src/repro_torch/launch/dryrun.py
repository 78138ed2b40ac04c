"""Dry run: drive every (arch x shape) cell on the ``meta`` device over a
fake process group, and derive its roofline on the H100.

Port of ``repro.launch.dryrun``. The reference fakes 512 host devices,
lowers and compiles each jitted step against abstract inputs, and reads
flops, bytes and collectives from XLA's cost analysis and HLO. Here:

* **The mesh.** ``torch.distributed`` runs on PyTorch's ``fake`` backend
  (``init_process_group("fake", store=FakeStore())``): this process is
  rank 0 of a world of 256 (the production ``(data=16, model=16)`` mesh
  of ``launch.mesh.make_production_mesh``), every collective returns at
  once with its output's shape, and nothing leaves the process.
* **The state and inputs.** Rank 0's shards of ``train.state``'s
  ``abstract_state`` under ``partition.constrained_shardings`` of its
  ``state_specs`` (what ``init_sharded_state`` places), and this rank's
  rows of ``configs.registry.input_specs``: all ``meta`` tensors, so
  nothing is allocated and every kernel wrapper takes its plain version
  by shape (``kernels.on_cpu``).
* **The step.** The port's own ``train.step.make_train_step(mesh=)``,
  run once at **full depth**: eager PyTorch runs every layer, so the
  reference's cost variants (scan-free copies compiled at 1 and 2
  blocks, extrapolated in depth) have no counterpart.
* **The counts.** A ``TorchDispatchMode`` (:class:`CostMode`) counts
  every op this rank runs, the backward's included: flops by
  ``torch.utils.flop_counter``'s formulas, bytes as each op's tensor
  inputs plus outputs (the unfused upper bound; views move nothing and
  are skipped); the collectives, their bytes and their ring link bytes
  are counted where they run, by ``sharding.collectives``.
* **The roofline.** ``launch.roofline.roofline_terms`` with the H100's
  numbers, the model's useful flops (``roofline.model_flops``, divided
  by G on the FLGW grouped path, as the reference does).
* **``--flash``** runs the fused attention core (``use_flash``) and
  accounts it with ``roofline.flash_attention_cost`` in place of its
  plain version's counted cost, as the reference's ``attn_identity``
  variant does.
* **Prefill and decode cells** run on one rank with the whole model
  (``"mesh": "1"``): the port has no sharded serving step.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2_2b \\
        --shape train_4k [--flgw-groups 4 --flgw-path grouped] [--flash]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Results go to ``build/dryrun/`` (gitignored). Runs on the CPU, no card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import registry
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline
from repro_torch.sharding import collectives, partition

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "dryrun"


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class CostMode(TorchDispatchMode):
    """Counts the flops and bytes of every op run inside it. ``paused``
    stops the count (a core accounted analytically instead). Ops on
    DTensors are the mesh's bookkeeping (their compute runs on the local
    shards, which are counted) and the collectives are counted by
    ``sharding.collectives``: neither is counted here."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), torch._C.DispatchKey.CompositeImplicitAutograd):
            # under inference mode a composite (matmul) reaches the mode
            # whole: count the ops it decomposes into
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if self.paused or func.namespace in ("c10d", "_c10d_functional"):
            return out
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return out
        self.ops += 1
        count = self._flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if not func.is_view:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out

    @contextlib.contextmanager
    def pause(self):
        was, self.paused = self.paused, True
        try:
            yield
        finally:
            self.paused = was


@contextlib.contextmanager
def fake_world(world: int):
    """This process as rank 0 of a ``fake`` process group of ``world``
    ranks (torch's testing backend: every collective returns at once,
    its output shaped as on a real group)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process without a group")
    dist.init_process_group("fake", rank=0, world_size=world,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _flash_accounted(mode: CostMode):
    """The fused core's plain version runs uncounted (its cost is added
    analytically)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    real = fa_ops.flash_fwd, fa_ops.flash_bwd

    def fwd(*a, **kw):
        with mode.pause():
            return real[0](*a, **kw)

    def bwd(*a, **kw):
        with mode.pause():
            return real[1](*a, **kw)
    fa_ops.flash_fwd, fa_ops.flash_bwd = fwd, bwd
    try:
        yield
    finally:
        fa_ops.flash_fwd, fa_ops.flash_bwd = real


def make_cfg(arch: str, *, flgw_groups: int = 1, flgw_path: str = "masked",
             flash: bool = False, extra: Optional[dict] = None):
    """The cell's config: the registry's, with the FLGW and flash
    switches and ``extra`` overrides."""
    overrides = dict(extra or {})
    if flgw_groups > 1:
        overrides.update(flgw_groups=flgw_groups, flgw_path=flgw_path)
    if flash:
        overrides["use_flash"] = True
    return registry.get_config(arch, **overrides)


def _rows(tree: dict, lo: int, hi: int) -> dict:
    return {k: v[lo:hi] for k, v in tree.items()}


def measure_train(cfg, mesh, *, seq: int, batch: int,
                  optimizer: str = "adamw", banded: bool = False,
                  rules=None, step_kw: Optional[dict] = None) -> dict:
    """One mesh train step of ``cfg`` on rank 0's shards and rows, all on
    ``meta``: {state bytes a rank, flops, bytes, op count, collectives
    (calls, bytes and link bytes by operation)}. Needs a (fake) process
    group over ``mesh``."""
    from repro_torch.train import state as state_lib
    from repro_torch.train import step as step_lib
    abstract = state_lib.abstract_state(cfg, optimizer=optimizer)
    shardings = partition.constrained_shardings(
        state_lib.state_specs(cfg, optimizer=optimizer), abstract, mesh,
        rules)
    state = partition.distribute(abstract, shardings, mesh)
    local, whole = partition.state_bytes(state)
    inputs = _input_specs(cfg, seq, batch, "train")
    lo, hi, _ = partition.batch_rows(mesh, batch, rules)
    step = step_lib.make_train_step(cfg, optimizer=optimizer, banded=banded,
                                    mesh=mesh, global_batch=batch,
                                    **(step_kw or {}))
    return _run_counted(cfg, lambda: step(state, _rows(inputs, lo, hi)),
                        state_bytes=local, whole_state_bytes=whole)


def _input_specs(cfg, seq: int, batch: int, kind: str) -> dict:
    """``registry.input_specs`` at any (seq, batch)."""
    name = "_dryrun_cell"
    registry.SHAPES[name] = (seq, batch, kind)
    try:
        return registry.input_specs(cfg, name)
    finally:
        del registry.SHAPES[name]


def _run_counted(cfg, fn, **extra) -> dict:
    mode = CostMode()
    collectives.clear()
    flash = cfg.use_flash
    with contextlib.ExitStack() as stack:
        stack.enter_context(mode)
        if flash:
            stack.enter_context(_flash_accounted(mode))
        t0 = time.time()
        fn()
        run_s = time.time() - t0
    coll = {}
    for (op, _), n in collectives.CALLS.items():
        c = coll.setdefault(op, {"calls": 0, "bytes": 0, "link_bytes": 0.0})
        c["calls"] += n
    for (op, _), n in collectives.BYTES.items():
        coll[op]["bytes"] += n
    for (op, _), n in collectives.LINK_BYTES.items():
        coll[op]["link_bytes"] += n
    return {"flops": mode.flops, "bytes": mode.bytes, "ops": mode.ops,
            "collectives": coll,
            "collective_link_bytes": sum(c["link_bytes"]
                                         for c in coll.values()),
            "run_s": round(run_s, 2), **extra}


def measure_serve(cfg, *, seq: int, batch: int, kind: str,
                  banded: bool = False) -> dict:
    """One prefill or one decode step of ``cfg`` with the whole model on
    one rank, on ``meta`` (the port has no sharded serving step)."""
    from repro_torch.models import transformer
    from repro_torch.serving import steps as serving_steps
    from repro_torch.train import state as state_lib
    params = state_lib.abstract_state(cfg).params
    pbytes = _nbytes(params)
    inputs = _input_specs(cfg, seq, batch, kind)
    if kind == "prefill":
        step = serving_steps.make_prefill_step(cfg, banded=banded)
        return _run_counted(cfg, lambda: step(params, inputs),
                            state_bytes=pbytes, whole_state_bytes=pbytes)
    cache = transformer.init_cache(cfg, batch, seq, params=params)
    cbytes = _nbytes(cache)
    step = serving_steps.make_decode_step(cfg, banded=banded)
    return _run_counted(
        cfg, lambda: step(params, cache, inputs["tokens"],
                          inputs["positions"]),
        state_bytes=pbytes + cbytes, whole_state_bytes=pbytes + cbytes)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             flgw_groups: int = 1, flgw_path: str = "masked",
             banded: bool = False, flash: bool = False, save: bool = True,
             tag: str = "", rules=None, extra: Optional[dict] = None,
             optimizer: str = "adamw", mesh_shape: Optional[tuple] = None,
             cfg=None, seq: Optional[int] = None,
             batch: Optional[int] = None,
             step_kw: Optional[dict] = None) -> dict:
    """Dry-run one cell: a train cell on rank 0 of the production mesh
    (a fake group of 256 ranks, 512 with ``multi_pod``) or of a
    ``(data, model)`` mesh of ``mesh_shape``, a prefill or decode cell on
    one rank. ``cfg``, ``seq`` and ``batch`` override the registry's
    (a cut config), ``step_kw`` goes to ``make_train_step``. Returns (and
    with ``save`` writes under ``build/dryrun/``) its counts and roofline
    terms."""
    cell_seq, cell_batch, kind = registry.SHAPES[shape_name]
    seq, batch = seq or cell_seq, batch or cell_batch
    if cfg is None:
        cfg = make_cfg(arch, flgw_groups=flgw_groups, flgw_path=flgw_path,
                       flash=flash, extra=extra)
    t0 = time.time()
    if kind == "train":
        if mesh_shape is not None:
            world = mesh_shape[0] * mesh_shape[1]
            mesh_name = f"{mesh_shape[0]}x{mesh_shape[1]}"
        else:
            world = 512 if multi_pod else 256
            mesh_name = "2x16x16" if multi_pod else "16x16"
        with fake_world(world):
            mesh = (mesh_lib.make_mesh_from_devices(model=mesh_shape[1])
                    if mesh_shape is not None
                    else mesh_lib.make_production_mesh(multi_pod=multi_pod))
            cost = measure_train(cfg, mesh, seq=seq, batch=batch,
                                 optimizer=optimizer, banded=banded,
                                 rules=rules, step_kw=step_kw)
        chips = world
    else:
        cost = measure_serve(cfg, seq=seq, batch=batch, kind=kind,
                             banded=banded)
        chips, mesh_name = 1, "1"
    if flash and kind in ("train", "prefill"):
        # the fused cores of the whole batch, spread over the chips that
        # split its rows
        fc = roofline.flash_attention_cost(cfg, batch=batch, seq=seq,
                                           kind=kind)
        cost["flops"] += fc["flops"] / chips
        cost["bytes"] += fc["bytes"] / chips
        cost["flash_analytic"] = fc
    n_tokens = batch * seq if kind != "decode" else batch
    mf = roofline.model_flops(cfg, n_tokens,
                              kind="train" if kind == "train" else "serve")
    if flgw_groups > 1 and flgw_path == "grouped":
        mf = mf / flgw_groups      # compact path: useful flops / G
    terms = roofline.roofline_terms(
        flops_per_chip=cost["flops"], bytes_per_chip=cost["bytes"],
        collective_bytes_per_chip=cost["collective_link_bytes"],
        model_flops_total=mf, chips=chips)
    result = {
        "arch": arch, "shape": shape_name, "kind": kind, "mesh": mesh_name,
        "chips": chips, "flgw_groups": flgw_groups,
        "flgw_path": flgw_path if flgw_groups > 1 else "dense",
        "banded": banded, "flash": flash, "seq": seq, "batch": batch,
        "tokens": n_tokens, "wall_s": round(time.time() - t0, 2),
        "state_bytes_per_chip": cost["state_bytes"],
        "state_bytes_whole": cost["whole_state_bytes"],
        "cost": {"flops_per_chip": cost["flops"],
                 "bytes_per_chip": cost["bytes"], "ops": cost["ops"]},
        "collectives": cost["collectives"],
        "roofline": terms,
    }
    if "flash_analytic" in cost:
        result["flash_analytic"] = cost["flash_analytic"]
    if save:
        RESULTS_DIR.mkdir(parents=True, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        name = f"{arch}_{shape_name}_{mesh_name}{suffix}.json"
        (RESULTS_DIR / name).write_text(json.dumps(result, indent=1))
    return result


def _fmt(result: dict) -> str:
    r = result["roofline"]
    coll = result["collectives"]
    cb = sum(c["bytes"] for c in coll.values())
    return (f"{result['arch']:<18} {result['shape']:<12} "
            f"{result['mesh']:<6} state {result['state_bytes_per_chip']:.4g} B"
            f" flops {result['cost']['flops_per_chip']:.4g} "
            f"bytes {result['cost']['bytes_per_chip']:.4g} coll {cb:.4g} B "
            f"c={r['compute_s']:.3e} m={r['memory_s']:.3e} "
            f"x={r['collective_s']:.3e} dom={r['dominant'][:-2]:<10} "
            f"frac={r['roofline_fraction']:.3f} ({result['wall_s']:.0f} s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--flgw-groups", type=int, default=1)
    ap.add_argument("--flgw-path", default="masked",
                    choices=("masked", "grouped"))
    ap.add_argument("--banded", action="store_true")
    ap.add_argument("--flash", action="store_true",
                    help="account the fused attention core analytically")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (int/float/str)")
    ap.add_argument("--pure-dp", action="store_true",
                    help="replicate weights over the data axis (no FSDP)")
    ap.add_argument("--optimizer", default="adamw",
                    choices=("adamw", "rmsprop"))
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    if not args.all and args.arch is None:
        ap.error("give --arch (and --shape) or --all")

    extra = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            try:
                v = float(v)
            except ValueError:
                pass
        extra[k] = v
    rules = None
    if args.pure_dp:
        rules = dict(partition.LOGICAL_RULES, embed=None)

    cells = (registry.all_cells() if args.all
             else [(args.arch, s) for s in
                   (registry.cells(args.arch) if args.shape is None
                    else [args.shape])])
    torch.set_num_threads(1)
    failures = []
    for arch, shape in cells:
        try:
            res = run_cell(arch, shape, multi_pod=args.multi_pod,
                           flgw_groups=args.flgw_groups,
                           flgw_path=args.flgw_path, banded=args.banded,
                           flash=args.flash, tag=args.tag, rules=rules,
                           extra=extra, optimizer=args.optimizer)
            print(_fmt(res), flush=True)
        except Exception as e:
            failures.append((arch, shape, repr(e)[:200]))
            print(f"FAIL {arch} {shape}: {e!r}"[:300], flush=True)
    if failures:
        print(f"\n{len(failures)} failures")
        return 1
    print(f"\nall {len(cells)} cells passed (train on the "
          f"{'2x16x16' if args.multi_pod else '16x16'} mesh of fake ranks, "
          f"serve on 1)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
