"""LM training launcher: config, init, data and the step loop.

Port of ``repro.launch.train`` on one device (the card unless
``--device cpu``):

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2_2b \\
      --full --flgw-groups 4 --flgw-path grouped --steps 3 --batch 4 \\
      --seq 1024

There is no mesh. The checkpoint and fault runner (``--ckpt-dir`` and
its ``--save-every``) is a later module of the port (ROADMAP, Queue 1)
and raises here.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.core.schedule import SparsitySchedule
from repro_torch.data.pipeline import SyntheticTokens, make_batch_iterator
from repro_torch.train import state as state_lib
from repro_torch.train import step as step_lib

_NO_CKPT = ("checkpointing (--ckpt-dir, --save-every) is not ported to "
            "repro_torch yet: the checkpoint and fault runner is a later "
            "module (ROADMAP, Queue 1)")


def train_lm(arch: str, *, smoke: bool = True, steps: int = 20,
             batch: int = 8, seq: int = 256, lr: float = 3e-4,
             flgw_groups: int = 1, flgw_path: str = "masked",
             refresh_every: int = 1, refresh: str = "period",
             optimizer: str = "adamw", ckpt_dir: str = None,
             log_every: int = 10,
             banded: bool = False, seed: int = 0, device=None):
    """Train ``arch`` for ``steps`` steps on synthetic tokens. Returns
    ``(state, history)``: one metrics dict per step (tensors, plus the
    step's synchronised wall time ``step_s``)."""
    if ckpt_dir:
        raise NotImplementedError(_NO_CKPT)
    if banded:
        raise NotImplementedError(
            "the banded prefill is not ported to repro_torch yet (ROADMAP, "
            "Queue 1)")
    dev = resolve_device(device)
    get = registry.get_smoke_config if smoke else registry.get_config
    overrides = {}
    if flgw_groups > 1:
        overrides = dict(flgw_groups=flgw_groups, flgw_path=flgw_path)
    cfg = get(arch, **overrides)
    schedule = None
    if flgw_groups > 1 and flgw_path == "grouped" and \
            (refresh_every > 1 or refresh != "period"):
        schedule = SparsitySchedule(groups=flgw_groups,
                                    refresh_every=refresh_every,
                                    refresh=refresh)

    state = state_lib.init_state(torch.Generator(device=dev).manual_seed(seed),
                                 cfg, optimizer=optimizer)
    step_fn = step_lib.make_train_step(cfg, optimizer=optimizer, lr=lr,
                                       schedule=schedule)
    ds = SyntheticTokens(cfg.vocab, batch, seq, seed=seed)
    batches = make_batch_iterator(ds, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    history = []
    t0 = time.perf_counter()
    try:
        for end in range(1, steps + 1):
            sync()
            ts = time.perf_counter()
            state, metrics = step_fn(state, next(batches))
            sync()
            history.append(dict(metrics, step_s=time.perf_counter() - ts))
            if log_every and end % log_every == 0:
                print(f"step {end}: loss={float(metrics['loss']):.4f}",
                      flush=True)
    finally:
        batches.close()
    dt = time.perf_counter() - t0

    losses = [float(h["loss"]) for h in history]
    print(f"{arch}: steps 0->{len(history)} in {dt:.1f}s  "
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
    ap.add_argument("--refresh", type=int, default=1,
                    help="re-encode the grouped path's plan cache every k "
                         "steps (1 = every step)")
    ap.add_argument("--refresh-mode", default="period",
                    choices=("period", "on_change", "hybrid"),
                    help="plan-refresh policy (see repro_torch.core.encoder)")
    ap.add_argument("--optimizer", default="adamw",
                    choices=("adamw", "rmsprop"))
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=None,
                    help="with --ckpt-dir; not ported yet, raises")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--banded", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch path)")
    a = ap.parse_args(argv)
    if a.save_every is not None:
        raise NotImplementedError(_NO_CKPT)
    train_lm(a.arch, smoke=a.smoke, steps=a.steps, batch=a.batch,
             seq=a.seq, lr=a.lr, flgw_groups=a.flgw_groups,
             flgw_path=a.flgw_path, refresh_every=a.refresh,
             refresh=a.refresh_mode, optimizer=a.optimizer,
             ckpt_dir=a.ckpt_dir, log_every=a.log_every, banded=a.banded, seed=a.seed,
             device=a.device)


if __name__ == "__main__":
    main()
