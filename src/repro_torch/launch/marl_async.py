"""Async actor/learner driver: decoupled IC3Net + FLGW training.

Port of ``examples/marl_async.py`` (the card unless
``--device cpu``). The actor runs rollouts against the latest published
``(params, PlanState, version)`` bundle and pushes the windows into a
device-resident ring; the learner drains it, applying an off-policy
correction (``--correction vtrace`` by default):

  PYTHONPATH=src python -m repro_torch.launch.marl_async --updates 64 \\
      --cadence 4
  PYTHONPATH=src python -m repro_torch.launch.marl_async --groups 4 \\
      --path grouped --threads

Multi-process bring-up (one process per host; the coordinator address
and process ids may also come from ``JAX_COORDINATOR`` /
``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID`` or torchrun's variables):

  PYTHONPATH=src python -m repro_torch.launch.marl_async --distributed \
      --coordinator host0:1234 --processes 2 --process-id 0 --batch 32

``--batch`` stays the GLOBAL env batch; each process trains on its
``host_local_batch`` slice. As in the JAX package, the processes do not
exchange gradients: each runs its own actor/learner pipeline. A failed
bring-up degrades to one process with a warning unless
``--strict-distributed`` is set.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.launch import mesh as mesh_lib
from repro_torch.marl import async_train as async_mod
from repro_torch.marl import envs as envs_mod
from repro_torch.marl import ic3net
from repro_torch.marl import train as train_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", default="predator_prey",
                    choices=envs_mod.names())
    ap.add_argument("--agents", type=int, default=3)
    ap.add_argument("--size", type=int, default=4)
    ap.add_argument("--groups", type=int, default=1)
    ap.add_argument("--path", default="masked",
                    choices=("masked", "grouped"))
    ap.add_argument("--updates", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cadence", type=int, default=1,
                    help="actor rollout windows generated per learner "
                         "update (AsyncConfig.actors)")
    ap.add_argument("--correction", default="vtrace",
                    choices=async_mod.CORRECTIONS)
    ap.add_argument("--capacity", type=int, default=None,
                    help="trajectory-queue depth (default max(4, cadence))")
    ap.add_argument("--publish-every", type=int, default=1,
                    help="learner updates per params publication")
    ap.add_argument("--max-staleness", type=int, default=None,
                    help="evict queued windows older than this many "
                         "updates (default 2*cadence+2)")
    ap.add_argument("--threads", action="store_true",
                    help="run the actor on its own thread and CUDA stream "
                         "(real overlap, nondeterministic interleaving)")
    ap.add_argument("--check-publication", action="store_true",
                    help="check plan-signature consistency of every "
                         "published bundle")
    ap.add_argument("--log-every", type=int, default=0)
    ap.add_argument("--debug-contracts", action="store_true",
                    help="the JAX package's retrace guard; raises here "
                         "(eager PyTorch has no retrace)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--distributed", action="store_true",
                    help="join a torch.distributed process group for "
                         "multi-process runs")
    ap.add_argument("--coordinator", default=None,
                    help="coordinator host:port (or JAX_COORDINATOR, or "
                         "torchrun's MASTER_ADDR/MASTER_PORT)")
    ap.add_argument("--processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--strict-distributed", action="store_true",
                    help="fail instead of degrading to single-process "
                         "when the bring-up cannot complete")
    args = ap.parse_args(argv)

    batch = args.batch
    if args.distributed:
        info = mesh_lib.init_distributed(
            args.coordinator, args.processes, args.process_id,
            strict=args.strict_distributed,
            backend="gloo" if args.device == "cpu" else "nccl")
        print(f"distributed: {info['distributed']} "
              f"process {info['process_index']}/{info['process_count']} "
              f"local_devices={info['local_devices']}")
        if info["distributed"]:
            batch, offset = mesh_lib.host_local_batch(args.batch)
            print(f"host-local batch {batch} (env offset {offset})")

    cfg = ic3net.IC3NetConfig(hidden=args.hidden, flgw_groups=args.groups,
                              flgw_path=args.path)
    env, ecfg = envs_mod.make(args.env, n_agents=args.agents,
                              size=args.size, max_steps=3 * args.size)
    tcfg = train_mod.TrainConfig(batch=batch)
    acfg = async_mod.AsyncConfig(
        capacity=args.capacity or max(4, args.cadence),
        actors=args.cadence, correction=args.correction,
        publish_every=args.publish_every,
        max_staleness=(args.max_staleness if args.max_staleness is not None
                       else 2 * args.cadence + 2))
    print(f"async IC3Net on {args.env} A={args.agents} hidden={args.hidden} "
          f"FLGW G={args.groups} ({args.path}) | cadence {acfg.actors} "
          f"capacity {acfg.capacity} correction {acfg.correction} "
          f"publish_every {acfg.publish_every} "
          f"max_staleness {acfg.max_staleness}")

    model, hist = async_mod.async_train(
        cfg, ecfg, tcfg, acfg, updates=args.updates, seed=args.seed,
        log_every=args.log_every or max(1, args.updates // 8), env=env,
        threads=args.threads, check_publication=args.check_publication,
        debug_contracts=args.debug_contracts, device=args.device)

    succ = np.array([h["success"] for h in hist])
    stale = np.array([h["staleness"] for h in hist])
    depth = np.array([h["queue_depth"] for h in hist])
    k = max(1, len(succ) // 8)
    print(f"device {model.device}")
    print(f"success: first-{k} {succ[:k].mean():.3f}  "
          f"last-{k} {succ[-k:].mean():.3f}")
    print(f"staleness: mean {stale.mean():.2f} max {stale.max():.0f}  "
          f"queue depth: mean {depth.mean():.2f}")
    print(f"throughput: {hist[-1]['env_steps_per_s']:.0f} env-steps/s "
          f"(actor clock), {hist[-1]['updates_per_s']:.2f} updates/s "
          f"(learner clock)")
    return model, hist


if __name__ == "__main__":
    main()
