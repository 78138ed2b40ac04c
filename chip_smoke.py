#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

The path is IC3Net's actor half at full width: the registered ``ic3net``
config (hidden 128, 8 agents) with FLGW G=4 on the grouped path,
predator-prey 10x10 with 30 steps, B=16 environments, random weights from
a seed. The script

  1. builds the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
     per source, in parallel);
  2. holds every kernel against its plain PyTorch version on the card at
     the shapes the path gives it (plan ids bitwise, grouped_bmm within
     rtol = atol = 1e-5) and times kernel, plain version and, where one
     PyTorch call computes the same function, that call;
  3. encodes the plans on the card and compares them bitwise with a CPU
     encode, then, with every launch count at 0, drives encode + one
     B=16 rollout and checks that each kernel was launched; replays the
     rollout's actions and gates on the CPU through the plain path
     (rewards, observations and success exact; logp, value, entropy and
     gate_logp within 1e-4); times rollouts (env-steps/s); and profiles
     one encode + rollout (device busy share, kernel device times);
  4. prints one ``{"kernels": [...]}`` line, the card's name and power
     limit, and as the last line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
result line. Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import ic3net as configs  # noqa: E402
from repro_torch.core import grouped  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flgw_matmul import ops as fm_ops  # noqa: E402
from repro_torch.kernels.flgw_matmul import ref as fm_ref  # noqa: E402
from repro_torch.kernels.plan_encode import ops as pe_ops  # noqa: E402
from repro_torch.kernels.plan_encode import ref as pe_ref  # noqa: E402
from repro_torch.kernels.tiling import compute_cap  # noqa: E402
from repro_torch.marl import envs, ic3net, train  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
BATCH = 16
SEED = 0
ENV = dict(n_agents=8, size=10, vision=1, max_steps=30)
BMM_TOL = 1e-5
REPLAY_TOL = 1e-4
OUT = ROOT / "chiprun_out"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean ms per call of ``fn`` over back-to-back calls, by CUDA events
    (host enqueue included when it is slower than the device)."""
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


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check_encode_kernels(model, slack: float) -> list[dict]:
    """rank and place against their plain versions at every FLGW layer
    side of the path; the whole assignment against the sort oracle."""
    rows = []
    for path, p in grouped.iter_flgw_layers(model.params):
        for side, scores, axis in (("ig", p["ig"], 1), ("og", p["og"], 0)):
            scores = scores.detach()
            pref, strength, bi = pe_ops.preferences(scores, axis)
            m, g = scores.shape if axis else scores.shape[::-1]
            cap = compute_cap(m, g, slack)
            rk, hist = pe_ops.rank(pref, strength, g, bi)
            rk_ref, hist_ref = pe_ref.ref_rank(pref, strength, g, bi)
            check(torch.equal(rk, rk_ref) and torch.equal(hist, hist_ref),
                  f"plan_rank == plain at {path} {side}")
            slot = pe_ops.place(pref, rk, hist, g, cap)
            slot_ref = pe_ref.ref_place(pref, rk_ref, hist_ref, g, cap)
            check(torch.equal(slot, slot_ref),
                  f"plan_place == plain at {path} {side}")
            oracle = pe_ref.ref_balanced_assign(
                scores if axis else scores.T, slack)
            check(torch.equal(pe_ops.balanced_assign(scores, axis, slack),
                              oracle),
                  f"balanced_assign == sort oracle at {path} {side}")
            l, mp = pref.shape
            n_it = mp // bi
            rank_b, rank_by = bound_ms(4 * (3 * l * mp + l * n_it * g),
                                       l * mp * mp)
            place_b, place_by = bound_ms(4 * (3 * l * mp + l * n_it * g),
                                         l * mp * g)
            rows.append(dict(
                layer=path[-1], side=side, items=m, groups=g, mp=mp,
                tile=bi, cap=cap,
                rank_max_abs_err=max(int((rk - rk_ref).abs().max()),
                                     int((hist - hist_ref).abs().max())),
                place_max_abs_err=int((slot - slot_ref).abs().max()),
                rank_ms=time_ms(lambda: pe_ops.rank(pref, strength, g, bi)),
                rank_plain_ms=time_ms(
                    lambda: pe_ref.ref_rank(pref, strength, g, bi), 50, 5),
                rank_bound_ms=rank_b, rank_bound_by=rank_by,
                place_ms=time_ms(lambda: pe_ops.place(pref, rk, hist, g,
                                                      cap)),
                place_plain_ms=time_ms(
                    lambda: pe_ref.ref_place(pref, rk, hist, g, cap), 50, 5),
                place_bound_ms=place_b, place_bound_by=place_by))
    return rows


def check_bmm_kernel(model, plans, rows_b: int) -> list[dict]:
    """grouped_bmm against its plain version on the compact operands of
    every FLGW layer, with B*A activation rows."""
    gen = torch.Generator(device=model.device).manual_seed(SEED + 1)
    rows = []
    for path, p in grouped.iter_flgw_layers(model.params):
        plan = plans.plans[path[-1]]
        x = torch.randn((rows_b, p["w"].shape[0]), generator=gen,
                        device=model.device)
        xg, wc = fm_ops.gather_operands(x, p["w"].detach(), plan.row_ids,
                                        plan.col_ids, plan.row_valid,
                                        plan.col_valid)
        y = fm_ops.grouped_bmm(xg, wc)
        y_ref = fm_ref.ref_grouped_bmm(xg, wc)
        err = float((y - y_ref).abs().max())
        check(torch.allclose(y, y_ref, rtol=BMM_TOL, atol=BMM_TOL),
              f"grouped_bmm == plain at {path[-1]} (max abs err {err})")
        g, b, k = xg.shape
        n = wc.shape[2]
        bnd, by = bound_ms(4 * (g * b * k + g * k * n + g * b * n),
                           2 * g * b * k * n)
        rows.append(dict(
            layer=path[-1], g=g, b=b, k=k, n=n, max_abs_err=err,
            ms=time_ms(lambda: fm_ops.grouped_bmm(xg, wc)),
            plain_ms=time_ms(lambda: fm_ref.ref_grouped_bmm(xg, wc)),
            library_ms=time_ms(lambda: torch.bmm(xg, wc)),
            bound_ms=bnd, bound_by=by))
    return rows


def same_plans(a, b) -> bool:
    if a.keys() != b.keys():
        return False
    return all(torch.equal(x.cpu(), y.cpu())
               for k in a for x, y in zip(a[k][:6], b[k][:6]))


def run_slice(model, cpu_model, env, ecfg, kernels) -> dict:
    with torch.inference_mode():
        card_plans = model.encode_plans()
        cpu_plans = cpu_model.encode_plans()
    check(same_plans(card_plans.plans, cpu_plans.plans)
          and int(card_plans.sig) == int(cpu_plans.sig),
          "plans encoded on the card == plans encoded on the CPU")

    # The main path, with every launch count at 0: encode, then rollout.
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        plans = model.encode_plans()
    gen = train.make_generator(SEED, model.device)
    r = train.rollout(model, env, ecfg, gen, BATCH, plans, collect=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in kernels}
    for k in kernels:
        check(launches[k.symbol] > 0, f"{k.symbol} launched on the path")

    # Replay the card's episodes on the CPU through the plain path.
    start = env.reset(train.make_generator(SEED, model.device), ecfg, BATCH)
    start = type(start)(*(v.cpu() for v in start))
    actions, gates = r.action.cpu(), r.gate.cpu()
    with torch.inference_mode():
        rep = train.run_episode(
            cpu_model, env, ecfg, start,
            lambda t, logits, gate_logits: (actions[:, t], gates[:, t]),
            cpu_plans, collect=True)
    for name in ("reward", "obs", "success"):
        check(torch.equal(getattr(r, name).cpu(), getattr(rep, name)),
              f"replay {name} exact")
    errs = {}
    for name in ("logp", "value", "entropy", "gate_logp"):
        a, b = getattr(r, name).cpu(), getattr(rep, name)
        errs[name] = float((a - b).abs().max())
        check(bool(torch.isfinite(a).all())
              and torch.allclose(a, b, rtol=REPLAY_TOL, atol=REPLAY_TOL),
              f"replay {name} within {REPLAY_TOL} (max abs err "
              f"{errs[name]})")

    # Steady-state speed of the path (plans cached, as the engine runs).
    times = []
    for i in range(5):
        g = train.make_generator(SEED + 10 + i, model.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train.rollout(model, env, ecfg, g, BATCH, plans)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    rollout_s = statistics.median(times[1:])
    enc_ms = time_ms(model.encode_plans, 20, 3)
    return dict(
        launches=launches, first_encode_and_rollout_s=first_s,
        rollout_s=rollout_s, rollout_s_all=times,
        env_steps_per_s=BATCH * ecfg.max_steps / rollout_s,
        agent_steps_per_s=BATCH * ecfg.max_steps * ecfg.n_agents / rollout_s,
        encode_ms=enc_ms, replay_max_abs_err=errs,
        success_rate=float(r.success.float().mean()))


def profile_path(model, env, ecfg, names) -> dict:
    """torch.profiler over one encode + one B=16 rollout: how many kernels
    the device ran, how much of the wall time it was busy, and each port
    kernel's device time. The profiler's own cost inflates the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    gen = train.make_generator(SEED + 99, model.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.inference_mode():
            plans = model.encode_plans()
        train.rollout(model, env, ecfg, gen, BATCH, plans)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in evs)
    by_name: dict[str, list[float]] = {}
    for e in evs:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    ours = {}
    for sym, key in names.items():
        ds = [d for n, v in by_name.items() if key in n for d in v]
        ours[sym] = dict(launches=len(ds), device_us_total=sum(ds),
                         device_us_mean=sum(ds) / len(ds) if ds else None)
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12]
    return dict(
        wall_us=wall_us, device_events=len(evs), device_busy_us=busy_us,
        device_busy_share=busy_us / wall_us if evs else None, kernels=ours,
        top=[dict(name=n[:100], count=len(v), device_us=sum(v))
             for n, v in top])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    print(f"built {sorted(logs)} in {build_s:.2f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    env, ecfg = envs.make("predator_prey", **ENV)
    cfg = dataclasses.replace(configs.config(), flgw_groups=4,
                              flgw_path="grouped", obs_dim=env.obs_dim(ecfg))
    model = ic3net.IC3Net(cfg, seed=SEED, device=resolve_device())
    cpu_model = ic3net.IC3Net(cfg, seed=SEED, device="cpu")
    check(all(torch.equal(a.cpu(), b) for a, b in
              zip(model.state_dict().values(),
                  cpu_model.state_dict().values())),
          "the seed gives the same weights on the card and the CPU")
    slack = cfg.flgw.capacity_slack
    kernels = (pe_ops.RANK, pe_ops.PLACE, fm_ops.BMM)

    enc_rows = check_encode_kernels(model, slack)
    with torch.inference_mode():
        plans = model.encode_plans()
    bmm_rows = check_bmm_kernel(model, plans, BATCH * cfg.n_agents)
    print("kernels match their plain versions on the card; plan_rank and "
          "plan_place have no single PyTorch call to time as a library "
          "yardstick (library_ms null), grouped_bmm_f32 has torch.bmm",
          flush=True)

    sl = run_slice(model, cpu_model, env, ecfg, kernels)
    print(f"slice: launches {sl['launches']}, encode {sl['encode_ms']:.3f} "
          f"ms, rollout {sl['rollout_s'] * 1e3:.2f} ms, "
          f"{sl['env_steps_per_s']:.1f} env-steps/s, replay max abs err "
          f"{sl['replay_max_abs_err']}", flush=True)
    prof = profile_path(model, env, ecfg, {
        "plan_rank": "rank_kernel", "plan_place": "place_kernel",
        "grouped_bmm_f32": "grouped_bmm_kernel"})
    share = prof["device_busy_share"]
    print(f"profile (encode + rollout): {prof['device_events']} device "
          f"events, busy {prof['device_busy_us']:.0f} of "
          f"{prof['wall_us']:.0f} us (share "
          f"{'not measured' if share is None else f'{share:.4f}'}); "
          + ", ".join(f"{k} {v['launches']}x {v['device_us_mean']} us"
                      for k, v in prof["kernels"].items()), flush=True)

    def total(rows, key):
        return sum(r[key] for r in rows)

    def bound_by(rows, key):
        return max(rows, key=lambda r: r[f"{key}_bound_ms"])[f"{key}_bound_by"]

    per_encode = "one encode: its calls at the path's 10 FLGW layer sides"
    kernels_line = {"kernels": [
        dict(name="plan_rank", route="cuda",
             source="src/repro_torch/csrc/plan_encode.cu",
             replaces="src/repro/kernels/plan_encode/plan_encode.py:50",
             launches=sl["launches"]["plan_rank"],
             max_abs_err=max(r["rank_max_abs_err"] for r in enc_rows),
             ms=total(enc_rows, "rank_ms"),
             plain_ms=total(enc_rows, "rank_plain_ms"),
             bound_ms=total(enc_rows, "rank_bound_ms"),
             bound_by=bound_by(enc_rows, "rank"), library_ms=None,
             timed_over=per_encode),
        dict(name="plan_place", route="cuda",
             source="src/repro_torch/csrc/plan_encode.cu",
             replaces="src/repro/kernels/plan_encode/plan_encode.py:81",
             launches=sl["launches"]["plan_place"],
             max_abs_err=max(r["place_max_abs_err"] for r in enc_rows),
             ms=total(enc_rows, "place_ms"),
             plain_ms=total(enc_rows, "place_plain_ms"),
             bound_ms=total(enc_rows, "place_bound_ms"),
             bound_by=bound_by(enc_rows, "place"), library_ms=None,
             timed_over=per_encode),
        dict(name="grouped_bmm_f32", route="cuda",
             source="src/repro_torch/csrc/flgw_matmul.cu",
             replaces="src/repro/kernels/flgw_matmul/flgw_matmul.py:38",
             launches=sl["launches"]["grouped_bmm_f32"],
             max_abs_err=max(r["max_abs_err"] for r in bmm_rows),
             ms=total(bmm_rows, "ms"), plain_ms=total(bmm_rows, "plain_ms"),
             bound_ms=total(bmm_rows, "bound_ms"),
             bound_by=max(bmm_rows, key=lambda r: r["bound_ms"])["bound_by"],
             library_ms=total(bmm_rows, "library_ms"),
             timed_over="one policy step: its calls at the path's 5 FLGW "
                        "layers"),
    ]}

    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, torch=torch.__version__, cuda=torch.version.cuda,
        build_s=build_s, build_logs=logs, encode_rows=enc_rows,
        bmm_rows=bmm_rows, slice=sl, profile=prof, **kernels_line),
        indent=1))
    print(json.dumps(kernels_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
