"""LM training launcher: mesh, sharded init, data and the step loop.

Port of ``repro.launch.train`` (the card unless ``--device cpu``):

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2_2b \\
      --full --flgw-groups 4 --flgw-path grouped --steps 3 --batch 4 \\
      --seq 1024

The launcher builds the reference's ``(data, model)`` mesh over the
process group (``launch.mesh.make_mesh_from_devices``). Without a group
it is a ``(1, 1)`` mesh in one process and the state is plain tensors.
With one (``init_distributed`` joins torchrun's: ``torchrun
--nproc-per-node N -m repro_torch.launch.train ...``) every rank draws
the same initial state and keeps its shards of it, by the placements of
``partition.constrained_shardings(state_specs, abstract_state)``, takes
its rows of each global batch and runs the mesh step
(``train.step.make_train_step(mesh=)``); several ranks on one card run
on gloo (NCCL takes one rank a card). With ``--ckpt-dir`` the loop runs under
``repro_torch.runtime.StepRunner``: it resumes from the directory's
latest checkpoint (plans re-encoded by ``restore_state``), saves every
``--save-every`` steps, and on SIGTERM or SIGINT saves at the next step
boundary and exits 0; run the same command again to resume.
"""
from __future__ import annotations

import argparse
import functools
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.core.schedule import SparsitySchedule
from repro_torch.data.pipeline import SyntheticTokens, make_batch_iterator
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer
from repro_torch.runtime.fault import StepRunner
from repro_torch.sharding import partition
from repro_torch.train import state as state_lib
from repro_torch.train import step as step_lib


def train_lm(arch: str, *, smoke: bool = True, steps: int = 20,
             batch: int = 8, seq: int = 256, lr: float = 3e-4,
             flgw_groups: int = 1, flgw_path: str = "masked",
             flgw_targets: Optional[tuple] = None,
             n_layers: Optional[int] = None, refresh_every: int = 1, refresh: str = "period",
             optimizer: str = "adamw", ckpt_dir: str = None,
             save_every: int = 100, log_every: int = 10,
             banded: bool = False, seed: int = 0, device=None,
             model: int = 0):
    """Train ``arch`` up to step ``steps`` on synthetic tokens (from the
    latest checkpoint in ``ckpt_dir``, when there is one).
    ``flgw_targets`` (default the config's) and ``n_layers`` (a depth
    cut, a multiple of the pattern's period) override the config.
    ``model``: the mesh's model axis (``make_mesh_from_devices``; 0 by
    its rule). Returns ``(state, history)``: one metrics dict per step
    run (tensors, plus the step's synchronised wall time ``step_s``); on
    a process group the state's leaves are this rank's DTensors."""
    dev = resolve_device(device)
    get = registry.get_smoke_config if smoke else registry.get_config
    overrides = {}
    if flgw_groups > 1:
        overrides = dict(flgw_groups=flgw_groups, flgw_path=flgw_path)
        if flgw_targets:
            overrides["flgw_targets"] = tuple(flgw_targets)
    if n_layers:
        overrides["n_layers"] = n_layers
    cfg = get(arch, **overrides)
    if transformer.needs_frames(cfg):
        # SyntheticTokens yields tokens only; the reference's launcher
        # trains such a model with a cross layer that sees the future
        raise transformer.no_frames_error(cfg, "train_lm (token batches "
                                          "only)")
    schedule = None
    if flgw_groups > 1 and flgw_path == "grouped" and \
            (refresh_every > 1 or refresh != "period"):
        schedule = SparsitySchedule(groups=flgw_groups,
                                    refresh_every=refresh_every,
                                    refresh=refresh)

    mesh = mesh_lib.make_mesh_from_devices(model=model,
                                           device_type=dev.type)
    sharded = dist.is_initialized()
    gen = torch.Generator(device=dev).manual_seed(seed)
    shardings = None
    if sharded:
        shardings = partition.constrained_shardings(
            state_lib.state_specs(cfg, optimizer=optimizer),
            state_lib.abstract_state(cfg, optimizer=optimizer), mesh)
        state = state_lib.init_sharded_state(gen, cfg, mesh, shardings,
                                             optimizer=optimizer)
    else:
        state = state_lib.init_state(gen, cfg, optimizer=optimizer)
    print(mesh_lib.describe_lm_mesh(mesh, batch=batch,
                                    state=state if sharded else None),
          flush=True)
    train_step = step_lib.make_train_step(
        cfg, optimizer=optimizer, lr=lr, banded=banded, schedule=schedule,
        mesh=mesh if sharded else None, global_batch=batch)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    @functools.wraps(train_step)            # keeps ``mutates_state``
    def step_fn(state, batch):
        sync()
        ts = time.perf_counter()
        state, metrics = train_step(state, batch)
        sync()
        return state, dict(metrics, step_s=time.perf_counter() - ts)

    ds = SyntheticTokens(cfg.vocab, batch, seq, seed=seed)
    runner = None
    start = 0
    if ckpt_dir:
        runner = StepRunner(step_fn, ckpt_dir, save_every=save_every)
    try:
        if runner is not None:
            state, start = runner.restore_or(
                state, shardings=shardings,
                restore_fn=lambda s, sh: state_lib.restore_state(
                    ckpt_dir, s, cfg, shardings=sh))
        batches = make_batch_iterator(ds, start_step=start, device=dev,
                                      sharding=mesh if sharded else None)
        t0 = time.perf_counter()
        try:
            if runner is not None:
                state, end, history = runner.run(
                    state, batches, start_step=start, max_steps=steps,
                    log_every=log_every)
            else:
                history = []
                for end in range(1, steps + 1):
                    state, metrics = step_fn(state, next(batches))
                    history.append(metrics)
                    if log_every and end % log_every == 0:
                        print(f"step {end}: "
                              f"loss={float(metrics['loss']):.4f}",
                              flush=True)
                end = len(history)
        finally:
            batches.close()
        dt = time.perf_counter() - t0
    finally:
        if runner is not None:    # a later SIGTERM must not be swallowed
            runner.guard.restore()

    losses = [float(h["loss"]) for h in history]
    print(f"{arch}: steps {start}->{end} in {dt:.1f}s  "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}"
          if losses else f"{arch}: no steps run")
    return state, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(registry.ARCH_IDS))
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--flgw-groups", type=int, default=1)
    ap.add_argument("--flgw-path", default="masked",
                    choices=("masked", "grouped"))
    ap.add_argument("--flgw-targets", default=None,
                    help="comma-separated FLGW targets (mlp,attn,moe,ssm; "
                         "default the config's)")
    ap.add_argument("--refresh", type=int, default=1,
                    help="re-encode the grouped path's plan cache every k "
                         "steps (1 = every step)")
    ap.add_argument("--refresh-mode", default="period",
                    choices=("period", "on_change", "hybrid"),
                    help="plan-refresh policy (see repro_torch.core.encoder)")
    ap.add_argument("--optimizer", default="adamw",
                    choices=("adamw", "rmsprop"))
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--banded", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch path)")
    a = ap.parse_args(argv)
    # under torchrun: join its group (no-op in one process)
    mesh_lib.init_distributed(strict=True, backend="gloo"
                              if a.device == "cpu" else "nccl")
    train_lm(a.arch, smoke=a.smoke, steps=a.steps, batch=a.batch,
             seq=a.seq, lr=a.lr, flgw_groups=a.flgw_groups,
             flgw_path=a.flgw_path,
             flgw_targets=a.flgw_targets and a.flgw_targets.split(","),
             refresh_every=a.refresh,
             refresh=a.refresh_mode, optimizer=a.optimizer,
             ckpt_dir=a.ckpt_dir, save_every=a.save_every,
             log_every=a.log_every, banded=a.banded, seed=a.seed,
             device=a.device)


if __name__ == "__main__":
    main()
