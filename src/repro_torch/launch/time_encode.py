"""Wall time of one whole plan encode on the card.

  PYTHONPATH=src python3 -m repro_torch.launch.time_encode

One encode is every FLGW side's plan and the plan signature:
``IC3Net.encode_plans`` at the IC3Net actor's widths (the registered
``ic3net`` config, FLGW G=4 on the grouped path, predator-prey 10x10
with 8 agents) and ``transformer.encode_plans`` at gemma2-2b's training
config (FLGW G=4 on the launcher's targets, the MLP). Each is timed by
CUDA events over back-to-back encodes; the profiler counts the kernels
one encode puts on the device and their busy time. Prints one JSON
object.

The script reaches the port only through those two entry points and what
builds their inputs, which the port has had since its training slices,
so run as a file with another checkout's ``src`` on ``PYTHONPATH`` it
times that checkout's encode with the same code:

  PYTHONPATH=other/src python3 src/repro_torch/launch/time_encode.py
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch

import repro_torch
from repro_torch import resolve_device
from repro_torch.configs import ic3net as ic3net_configs
from repro_torch.configs import registry
from repro_torch.marl import envs, ic3net
from repro_torch.models import transformer

SEED = 0
ENV = dict(n_agents=8, size=10, vision=1, max_steps=30)
LM_FLGW = dict(flgw_groups=4, flgw_path="grouped")


def _time_ms(fn, iters: int, warmup: int) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_kernels(fn) -> tuple[int, float]:
    """(kernels, busy us) that one call of ``fn`` puts on the device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(evs), sum(e.time_range.elapsed_us() for e in evs)


def measure(device) -> dict:
    """``{"ic3net": ..., "gemma2_2b_train": ...}``, each with the wall
    ``ms`` of one encode, its ``device_events`` and ``device_busy_us``."""
    env, ecfg = envs.make("predator_prey", **ENV)
    cfg = dataclasses.replace(ic3net_configs.config(), flgw_groups=4,
                              flgw_path="grouped", obs_dim=env.obs_dim(ecfg))
    model = ic3net.IC3Net(cfg, seed=SEED, device=device)
    lcfg = registry.get_config("gemma2_2b", **LM_FLGW)
    params = transformer.lm_init(
        torch.Generator(device=device).manual_seed(SEED), lcfg)
    out = {}
    with torch.inference_mode():
        for name, fn, iters in (
                ("ic3net", model.encode_plans, 50),
                ("gemma2_2b_train",
                 lambda: transformer.encode_plans(params, lcfg), 20)):
            events, busy_us = _device_kernels(fn)
            out[name] = dict(ms=_time_ms(fn, iters, 5),
                             device_events=events, device_busy_us=busy_us)
    return out


def main() -> int:
    device = resolve_device()
    print(json.dumps(dict(port=str(Path(repro_torch.__file__).parent),
                          card=torch.cuda.get_device_name(device),
                          encode=measure(device))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
