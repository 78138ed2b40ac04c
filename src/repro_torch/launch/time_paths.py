"""Wall times of the port's host-bound paths on the card.

  PYTHONPATH=src python3 -m repro_torch.launch.time_paths [--repeats N]

Each path is timed ``--repeats`` times in one process, after one
untimed run that warms it:

* ``gemma2_2b.decode_step_ms``: the median of 32 lockstep decode
  steps (B=4) of gemma2-2b at full width, FLGW G=4 grouped on the MLP
  and attention with ``use_flash`` (the serving config ``chip_smoke.py``
  serves), compact weights attached (one ``fused_bmm`` launch a
  projection);
* ``gemma2_2b.lockstep_tokens_per_s`` and the same of ``gemma3_12b``:
  tokens/s of a lockstep ``Engine`` run of 4 requests, prompt 64, gen
  32, through a certify ``ServeSession`` (gemma3-12b at full width, 6
  layers);
* ``ic3net.rollout_env_steps_per_s``: env-steps/s of ``train.rollout``
  at B=16 on cached plans (the IC3Net actor, G=4 grouped, predator-prey
  10x10, 8 agents);
* ``ic3net.learner_ms_per_iter``: ms per sparse iteration (the median of
  ``train.train``'s 8 sparse iterations of 10, warmup 2).

Prints one JSON object with every run's number. The script reaches the
port only through entry points it has had since its serving and
learner slices, so run as a file with another checkout's ``src`` on
``PYTHONPATH`` it times that checkout with the same code; alternate the
two checkouts' processes to compare them:

  PYTHONPATH=other/src python3 src/repro_torch/launch/time_paths.py
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import statistics
import time
from pathlib import Path

import numpy as np
import torch

import repro_torch
from repro_torch import resolve_device
from repro_torch.configs import ic3net as ic3net_configs
from repro_torch.configs import registry
from repro_torch.core.schedule import SparsitySchedule
from repro_torch.marl import envs, ic3net, train
from repro_torch.models import transformer
from repro_torch.serving import (Engine, Request, ServeSession, max_seq_for,
                                 plan_cache)

SEED = 0
SERVE_FLGW = dict(flgw_groups=4, flgw_path="grouped",
                  flgw_targets=("mlp", "attn"), use_flash=True)
BATCH, PROMPT, GEN = 4, 64, 32
DECODE_STEPS = 32
ENV = dict(n_agents=8, size=10, vision=1, max_steps=30)
ROLLOUT_BATCH = 16
LEARN_ITERS = 10
LEARN_SCHEDULE = SparsitySchedule(groups=4, warmup_steps=2)


def _wall(fn) -> float:
    """Seconds of one call of ``fn``, the card drained before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _lockstep(session, cfg) -> float:
    prompts = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32)
    reqs = [Request(rid=i, prompt=prompts[i], max_new_tokens=GEN)
            for i in range(BATCH)]
    rep = Engine(session, BATCH, max_seq_for(reqs),
                 admission="lockstep").run(reqs)
    return rep.tokens_per_s


def _decode_step_ms(session, cfg) -> float:
    """Median wall ms of DECODE_STEPS lockstep decode steps."""
    cache = session.new_cache(BATCH, DECODE_STEPS)
    tok = torch.zeros((BATCH, 1), dtype=torch.int64, device=session.device)
    times = []
    with torch.inference_mode():
        for pos in range(DECODE_STEPS):
            def step():
                nonlocal tok, cache
                tok, cache = session.decode(
                    cache, tok, session.greedy_positions(BATCH, pos))
            times.append(_wall(step))
    return statistics.median(times) * 1e3


def serve(arch: str, layers, repeats: int, device, decode: bool) -> dict:
    over = {} if layers is None else dict(n_layers=layers)
    cfg = registry.get_config(arch, **over, **SERVE_FLGW)
    params = transformer.lm_init(
        torch.Generator(device=device).manual_seed(SEED), cfg)
    plan_cache.clear()
    session = ServeSession(cfg, params, plan_policy="certify")
    out = dict(lockstep_tokens_per_s=[])
    _lockstep(session, cfg)
    for _ in range(repeats):
        out["lockstep_tokens_per_s"].append(_lockstep(session, cfg))
    if decode:
        _decode_step_ms(session, cfg)
        out["decode_step_ms"] = [_decode_step_ms(session, cfg)
                                 for _ in range(repeats)]
    del session, params
    plan_cache.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ic3net_paths(repeats: int, device) -> dict:
    env, ecfg = envs.make("predator_prey", **ENV)
    cfg = dataclasses.replace(ic3net_configs.config(), flgw_groups=4,
                              flgw_path="grouped", obs_dim=env.obs_dim(ecfg))
    model = ic3net.IC3Net(cfg, seed=SEED, device=device)
    with torch.inference_mode():
        plans = model.encode_plans()
    steps = []
    for i in range(repeats + 1):
        g = train.make_generator(SEED + 10 + i, model.device)
        s = _wall(lambda: train.rollout(model, env, ecfg, g, ROLLOUT_BATCH,
                                        plans))
        steps.append(ROLLOUT_BATCH * ecfg.max_steps / s)
    learner = []
    # the learner at chip_smoke.py's config: train sizes the actor
    learn_cfg = dataclasses.replace(ic3net_configs.config(), flgw_groups=4,
                                    flgw_path="grouped")
    tcfg = train.TrainConfig(batch=ROLLOUT_BATCH, lr=1e-3)
    for _ in range(repeats):
        _, hist = train.train(learn_cfg, ecfg, tcfg, iterations=LEARN_ITERS,
                              seed=SEED, env=env, schedule=LEARN_SCHEDULE,
                              device=device)
        learner.append(statistics.median(
            1e3 / h["steps_per_s"]
            for h in hist[LEARN_SCHEDULE.warmup_steps:]))
    return dict(rollout_env_steps_per_s=steps[1:],
                learner_ms_per_iter=learner)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    device = resolve_device()
    out = dict(port=str(Path(repro_torch.__file__).parent),
               card=torch.cuda.get_device_name(device))
    out["ic3net"] = ic3net_paths(args.repeats, device)
    out["gemma2_2b"] = serve("gemma2_2b", None, args.repeats, device, True)
    out["gemma3_12b"] = serve("gemma3_12b", 6, args.repeats, device, False)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
