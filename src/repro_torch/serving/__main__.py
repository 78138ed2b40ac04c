"""Serve a model through the port's serving tier: the counterpart of
``examples/serve.py``, with the same flags plus ``--device``.

  PYTHONPATH=src python -m repro_torch.serving --arch gemma2_2b --batch 4 \
      --prompt-len 64 --gen 32 [--groups 4 --path grouped \
      --targets mlp,attn] [--mode continuous --requests 16 --p-arrive 0.5] \
      [--full] [--flash] [--device cpu]

Runs on the CUDA card unless ``--device`` says otherwise. The smoke
config is the default; ``--full`` serves the registered full-width
config (random weights from seed 0).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.core import encoder, grouped
from repro_torch.models import transformer
from repro_torch.serving import (Engine, Request, ServeSession, max_seq_for,
                                 plan_cache, synthetic_requests)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serving")
    ap.add_argument("--arch", default="gemma2_2b", choices=registry.ARCH_IDS)
    ap.add_argument("--full", action="store_true",
                    help="the full-width config, not the smoke config")
    ap.add_argument("--batch", type=int, default=4,
                    help="engine capacity (decode-batch slots)")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--groups", type=int, default=1)
    ap.add_argument("--path", default="masked",
                    choices=("masked", "grouped"),
                    help="FLGW execution path when --groups > 1")
    ap.add_argument("--targets", default="mlp",
                    help="comma-separated FLGW targets (mlp,attn,moe,ssm)")
    ap.add_argument("--mode", default="lockstep",
                    choices=("lockstep", "continuous"))
    ap.add_argument("--plan-policy", default="certify",
                    choices=("certify", "trust", "off"))
    ap.add_argument("--requests", type=int, default=0,
                    help="continuous mode: open-loop stream size "
                         "(default 4x batch)")
    ap.add_argument("--p-arrive", type=float, default=0.5,
                    help="continuous mode: Geometric arrival probability")
    ap.add_argument("--flash", action="store_true",
                    help="flash-attention prefill core (use_flash)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    overrides = {"use_flash": args.flash}
    if args.groups > 1:
        overrides.update(flgw_groups=args.groups, flgw_path=args.path,
                         flgw_targets=tuple(args.targets.split(",")))
    get = registry.get_config if args.full else registry.get_smoke_config
    cfg = get(args.arch, **overrides)
    if transformer.needs_frames(cfg):
        # the requests carry tokens only: no frames for the encoder
        ap.error(str(transformer.no_frames_error(
            cfg, "python -m repro_torch.serving (token prompts only)")))
    device = resolve_device(args.device)
    params = transformer.lm_init(
        torch.Generator(device=device).manual_seed(0), cfg)

    session = ServeSession(cfg, params, plan_policy=args.plan_policy)
    if isinstance(session.plans, encoder.PlanState):
        n_plans = sum(1 for _ in grouped.iter_flgw_layers(params))
        print(f"serving plan-aware: PlanState with {n_plans} cached "
              f"GroupPlans shared via the process plan cache "
              f"(G={cfg.flgw_groups}, targets={cfg.flgw_targets}, "
              f"plan_policy={args.plan_policy})")

    if args.mode == "lockstep":
        prompts = np.random.default_rng(1).integers(
            0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)
        requests = [Request(rid=i, prompt=prompts[i],
                            max_new_tokens=args.gen, arrival=0)
                    for i in range(args.batch)]
    else:
        n = args.requests or 4 * args.batch
        requests = synthetic_requests(
            1, n, vocab=cfg.vocab, p_arrive=args.p_arrive,
            prompt_len=(max(1, args.prompt_len // 2), args.prompt_len),
            gen_len=(max(1, args.gen // 2), args.gen))

    engine = Engine(session, capacity=args.batch,
                    max_seq=max_seq_for(requests), admission=args.mode)
    report = engine.run(requests)

    s = report.summary()
    print(f"{args.mode} on {device}: {s['requests']} requests, "
          f"{s['generated_tokens']} tokens in {s['wall_s']:.2f}s "
          f"({s['tokens_per_s']:.1f} tok/s, "
          f"{100 * s['slot_utilization']:.0f}% slot utilization, "
          f"{report.steps} steps)")
    if s["p50_s"] is not None:
        print(f"latency: p50 {s['p50_s'] * 1e3:.0f}ms / "
              f"p99 {s['p99_s'] * 1e3:.0f}ms "
              f"(p50 {s['p50_ticks']:.0f} / p99 {s['p99_ticks']:.0f} steps)")
    pc = plan_cache.stats()
    if pc["hits"] or pc["misses"]:
        print(f"plan cache: {pc['encodes']} encode(s), {pc['hits']} hit(s) "
              f"across {s['requests']} requests")
    done = [r for r in report.records if r.completed >= 0]
    if done:
        print(f"sample generated ids (req {done[0].rid}): "
              f"{done[0].tokens[:16]}")


if __name__ == "__main__":
    main()
