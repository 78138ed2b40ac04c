"""End-to-end launcher: IC3Net + FLGW sparse training on any registered env.

Port of ``examples/marl_ic3net.py`` (the card unless ``--device cpu``),
with the same flags and defaults. The paper's own
workload (section IV-A) is Predator-Prey; ``--env`` selects any scenario
of the ``repro_torch.marl.envs`` registry. Prints the success-rate curve,
the throughput and the sparsity the learned grouping matrices realise:

  PYTHONPATH=src python -m repro_torch.launch.marl_ic3net --path grouped \\
      --groups 4 --iterations 200
  PYTHONPATH=src python -m repro_torch.launch.marl_ic3net --device cpu \\
      --env traffic_junction --iterations 5 --batch 4 --hidden 32 --agents 3

Training runs one host loop of ``repro_torch.marl.train.train``, so
``--host-loop`` is accepted and changes nothing, and ``--log-every`` sets
how often a line is printed (the reference's log window).

``--mesh ENV,AGENT`` (or ``auto``, or the deprecated ``--parallel``)
trains on an ``("env", "agent")`` process mesh, one process a shard,
after printing what shards where. Start one process per shard with
torchrun; each joins the group through ``launch.mesh.init_distributed``
on ``--backend`` (``nccl`` on the card, ``gloo`` with ``--device cpu``;
several processes sharing one card need ``gloo``, NCCL refuses them):

  PYTHONPATH=src torchrun --nproc-per-node 4 -m \
      repro_torch.launch.marl_ic3net --device cpu --mesh 2,2 --batch 4
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import flgw
from repro_torch.core.schedule import SparsitySchedule
from repro_torch.launch import mesh as mesh_lib
from repro_torch.marl import envs as envs_mod
from repro_torch.marl import ic3net
from repro_torch.marl import train as train_mod


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.marl_ic3net")
    ap.add_argument("--env", default="predator_prey",
                    choices=envs_mod.names())
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--size", type=int, default=4)
    ap.add_argument("--groups", type=int, default=4)
    ap.add_argument("--path", default="masked",
                    choices=("masked", "grouped"))
    ap.add_argument("--iterations", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--warmup", type=int, default=0,
                    help="train dense for this many iterations before "
                         "enabling the FLGW mask")
    ap.add_argument("--refresh", type=int, default=1,
                    help="re-encode the grouped path's plan cache every k "
                         "iterations (1 = every step)")
    ap.add_argument("--refresh-mode", default="period",
                    choices=("period", "on_change", "hybrid"),
                    help="plan-refresh policy: fixed period, or "
                         "change-driven from the ig/og argmax hash "
                         "(repro_torch.core.encoder)")
    ap.add_argument("--mesh", default=None,
                    help="ENV,AGENT shard counts of the (env, agent) process "
                         "mesh ('auto': every process on the env axis); "
                         "start one process a shard (torchrun)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="process-group backend of a mesh run (default: "
                         "nccl on the card, gloo with --device cpu)")
    ap.add_argument("--parallel", action="store_true",
                    help="DEPRECATED alias of --mesh auto (the retired "
                         "data-parallel path)")
    ap.add_argument("--log-every", type=int, default=0,
                    help="print a line every this many iterations "
                         "(0 = iterations/10)")
    ap.add_argument("--host-loop", action="store_true",
                    help="accepted for the reference's command lines: the "
                         "port always drives one update per host iteration")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch path)")
    args = ap.parse_args(argv)

    mesh_shape = None
    if args.mesh:
        try:
            mesh_shape = ((0, 1) if args.mesh == "auto"
                          else mesh_lib.parse_marl_mesh(args.mesh))
        except ValueError as e:
            ap.error(str(e))
    tcfg = train_mod.TrainConfig(batch=args.batch, parallel=args.parallel,
                                 mesh=mesh_shape)
    if mesh_shape is not None or args.parallel:
        mesh_lib.init_distributed(strict=True, backend=args.backend or (
            "gloo" if args.device == "cpu" else "nccl"))
    if mesh_shape is not None:
        try:
            mesh = mesh_lib.make_marl_mesh(env=mesh_shape[0],
                                           agent=mesh_shape[1])
        except ValueError as e:
            ap.error(str(e))
        print(mesh_lib.describe_marl_mesh(mesh, batch=args.batch,
                                          n_agents=args.agents))
    cfg = ic3net.IC3NetConfig(hidden=args.hidden, flgw_groups=args.groups,
                              flgw_path=args.path)
    env, ecfg = envs_mod.make(args.env, n_agents=args.agents,
                              size=args.size, max_steps=3 * args.size)
    schedule = SparsitySchedule(groups=args.groups,
                                warmup_steps=args.warmup,
                                refresh_every=args.refresh,
                                refresh=args.refresh_mode) \
        if (args.warmup or args.refresh > 1
            or args.refresh_mode != "period") else None
    print(f"IC3Net on {args.env} A={args.agents} hidden={args.hidden} "
          f"FLGW G={args.groups} ({args.path}) "
          f"-> expected sparsity {100 * (1 - 1 / max(args.groups, 1)):.1f}%"
          + (f", dense warmup {args.warmup} iters" if args.warmup else ""))

    model, hist = train_mod.train(
        cfg, ecfg, tcfg, args.iterations, seed=args.seed,
        log_every=args.log_every or max(1, args.iterations // 10), env=env,
        schedule=schedule, device=args.device)
    print(f"device {model.device}")
    succ = np.array([h["success"] for h in hist])
    k = max(1, len(succ) // 10)
    print(f"success: first-{k} {succ[:k].mean():.3f}  "
          f"last-{k} {succ[-k:].mean():.3f}")
    # throughput of the second half (the first iterations build kernels
    # and warm the allocator)
    tail = hist[len(hist) // 2:]
    print(f"throughput: {np.mean([h['steps_per_s'] for h in tail]):.2f} "
          f"iters/s, {np.mean([h['env_steps_per_s'] for h in tail]):.0f} "
          f"env-steps/s, est. sparse "
          f"{np.mean([h['sparse_gflops'] for h in tail]):.3f} GFLOPS")

    if args.groups > 1:
        # realised sparsity of each learned FLGW layer
        print("learned per-layer sparsity:")
        for name, p in model.params.items():
            if isinstance(p, dict) and "ig" in p:
                ig_idx, og_idx = flgw.grouping_indices(p["ig"], p["og"])
                s = float(flgw.mask_sparsity(ig_idx, og_idx,
                                             groups=args.groups))
                print(f"  {name:<8} {100 * s:.1f}%")
    return model, hist


if __name__ == "__main__":
    main()
