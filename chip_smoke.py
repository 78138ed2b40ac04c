#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

The port's paths, each at full width with random weights from a seed:

* IC3Net's actor half: the registered ``ic3net`` config (hidden 128,
  8 agents) with FLGW G=4 on the grouped path, predator-prey 10x10 with
  30 steps, B=16 environments;
* serving gemma2-2b: the registered ``gemma2_2b`` config (26 layers,
  d 2304, vocab 256,000, bf16) with FLGW G=4 on the grouped path for the
  MLP and attention projections and the flash-attention prefill;
* training gemma2-2b: the same config with FLGW G=4 on the grouped path
  for the MLP (the launcher's targets), slack 1.25, AdamW, remat, B=4 x
  S=1024 batches of ``SyntheticTokens(seed=0)``;
* the OSEL encoder (the sparse row memory on the mask-encode kernel) at
  the paper's Fig. 10 shapes;
* training IC3Net (the A2C learner): the actor's config and env, B=16,
  RMSprop lr 1e-3, a dense warmup of 2 iterations, 10 iterations through
  ``train``; and the Fig. 9 learning check (predator-prey 4 agents on
  4x4, 12 steps, B=16, hidden 128, G=4, 800 iterations) on the masked
  and the grouped path.

The script

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
  4. holds ``fused_bmm`` against its plain version at each FLGW projection
     shape of gemma2-2b for 4 and 4096 rows (bf16; one f32 case) and
     ``flash_fwd`` at the prefill's shapes, timing each against its plain
     version and a PyTorch call; then, with every launch count at 0,
     builds a ``certify`` ServeSession, runs a B=4 x S=1024 prefill, one
     lockstep Engine run (4 requests, prompt 64, gen 32) and one
     continuous run (16 synthetic requests), and checks which kernels the
     path launched; replays a 4-layer cut of the same weights on the CPU
     (prefill B=1 x S=256 and 8 greedy decode steps from the card's KV
     cache); and profiles one prefill plus 8 decode steps;
  5. holds ``grouped_bmm_bf16`` against its plain version at the
     training MLP's product shapes and ``flash_bwd_dq``/``flash_bwd_dkv``
     at the attention's (bf16, S=1024 with windows 4096 and 0, S=512 with
     window 128), timing each against its plain version and a PyTorch
     call; then, with every launch count at 0 before each, trains 3 steps
     through ``train_lm`` (the chunked attention core) and 3 through
     ``make_train_step`` with ``use_flash`` from the same init and
     batches, checks which kernels each phase launched and that the two
     agree; replays one step of 2 layers of the trained weights on the CPU
     (B=1 x S=128); and profiles one flash training step;
  6. holds ``osel_encode`` bitwise against its plain version at every
     FLGW side of gemma2-2b, the five IC3Net layers, Fig. 10's grid and
     ragged shapes; with the launch counts at 0, runs the OSEL encoder
     (``encode``/``transpose_encode``) at Fig. 10's 128 x 512 and checks
     its mask against ``flgw.mask_from_indices`` and the IS @ OS
     baseline; times the kernel at 2304 x 9216 against its plain version
     and ``torch.eq``; prints the FPGA cycle and footprint models' table;
  7. with every launch count at 0, trains IC3Net 10 iterations through
     ``train`` (2 dense, 8 grouped) and checks the launches exactly;
     replays one more iteration's sampled actions and gates on the CPU
     (loss within 1e-5, each gradient within 1e-4 relative norm, the gate
     head's gradient exactly 0 on both); profiles one sparse iteration;
     then runs the Fig. 9 learning check on the masked and the grouped
     path against bands around the JAX package's success rates;
  8. prints one ``{"kernels": [...]}`` line, the card's name and power
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

import numpy as np
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
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import encoder as planenc  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serving import (Engine, Request, ServeSession,  # noqa: E402
                                 max_seq_for, plan_cache, synthetic_requests)
from repro_torch.data.pipeline import SyntheticTokens  # noqa: E402
from repro_torch.launch.train import train_lm  # noqa: E402
from repro_torch.optim.optimizers import global_norm, rmsprop_init  # noqa
from repro_torch.train import state as state_lib  # noqa: E402
from repro_torch.train import step as step_lib  # noqa: E402
from repro_torch.core import flgw, osel  # noqa: E402
from repro_torch.core.schedule import SparsitySchedule  # noqa: E402
from repro_torch.kernels.osel_encode import ops as os_ops  # noqa: E402
from repro_torch.kernels.osel_encode import ref as os_ref  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
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


def bound_ms(nbytes: float, ops: float,
             peak: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
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
    """Two nested plan trees hold bitwise the same layouts (``wc`` aside)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_plans(a[k], b[k]) for k in a)
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a[:6], b[:6]))


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
    for name in ("plan_rank", "plan_place", "grouped_bmm_f32"):
        check(launches[name] > 0, f"{name} launched on the IC3Net path")

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


def profile(fn, names) -> dict:
    """torch.profiler over one call of ``fn``: how many kernels the device
    ran, how much of the wall time it was busy, and each port kernel's
    device time (``names``: launch-count symbol -> a substring of its
    CUDA kernel's name). The profiler's own cost inflates the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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


def profile_path(model, env, ecfg, names) -> dict:
    """The profiler over one encode + one B=16 rollout."""
    gen = train.make_generator(SEED + 99, model.device)

    def run():
        with torch.inference_mode():
            plans = model.encode_plans()
        train.rollout(model, env, ecfg, gen, BATCH, plans)
    return profile(run, names)


def print_profile(what: str, prof: dict) -> None:
    share = prof["device_busy_share"]
    print(f"profile ({what}): {prof['device_events']} device events, busy "
          f"{prof['device_busy_us']:.0f} of {prof['wall_us']:.0f} us (share "
          f"{'not measured' if share is None else f'{share:.4f}'}); "
          + ", ".join(f"{k} {v['launches']}x {v['device_us_mean']} us"
                      for k, v in prof["kernels"].items()), flush=True)


# ---------------------------------------------------------------------------
# Serving gemma2-2b
# ---------------------------------------------------------------------------

SERVE_FLGW = dict(flgw_groups=4, flgw_path="grouped",
                  flgw_targets=("mlp", "attn"), use_flash=True)
SERVE_BATCH = 4               # engine capacity (examples/serve.py default)
PROMPT, GEN = 64, 32          # examples/serve.py defaults
PREFILL_SEQ = 1024
FUSED_BF16_TOL = dict(rtol=1e-2, atol=1e-3)   # f32 sums, one bf16 rounding
FUSED_F32_TOL = dict(rtol=1e-5, atol=1e-5)
FLASH_BF16_TOL = dict(rtol=1e-2, atol=1e-2)   # |out| < 4, one bf16 rounding
LSE_TOL = dict(rtol=1e-5, atol=1e-4)
# card vs CPU, both bf16 with f32 sums: 4 layers of activations rounded to
# bf16 at the same places but from sums taken in other orders
REPLAY_BF16_TOL = dict(rtol=5e-2, atol=5e-2)
SERVE_KERNELS = {"plan_rank": "rank_kernel", "plan_place": "place_kernel",
                 "grouped_bmm_f32": "grouped_bmm_kernel",
                 "fused_bmm": "fused_bmm_bf16_kernel",
                 "fused_bmm split-K sum": "reduce_splits_kernel",
                 "flash_fwd": "flash_fwd_kernel"}


def serve_params(cfg, device) -> dict:
    return transformer.lm_init(
        torch.Generator(device=device).manual_seed(SEED), cfg)


def check_fused_kernel(params, cfg) -> list[dict]:
    """fused_bmm against its plain version at each FLGW projection of
    block 0's local slot (the shapes every layer repeats), for a decode
    step's 4 rows and a prefill's 4096, in bf16; one f32 case."""
    with torch.inference_mode():
        state = planenc.attach_compact(transformer.encode_plans(params, cfg),
                                       params)
    blk = transformer._index(state.plans["blocks"], 0)["slot0"]
    blkp = transformer._index(params["blocks"], 0)["slot0"]
    projs = [("mixer", n) for n in "qkvo"] + [("ffn", n)
                                              for n in ("up", "gate", "down")]
    gen = torch.Generator(device=params["embed"]["embedding"].device)
    gen.manual_seed(SEED + 2)
    rows = []
    cases = [(r, torch.bfloat16) for r in (4, 4096)] + [(64, torch.float32)]
    for n_rows, dtype in cases:
        for part, name in projs:
            if dtype == torch.float32 and name != "q":
                continue
            plan = blk[part][name]
            m, n = blkp[part][name]["w"].shape
            dev = plan.wc.device
            x = torch.randn((n_rows, m), generator=gen, device=dev).to(dtype)
            ids = torch.where(plan.row_valid, plan.row_ids, m).to(torch.int32)
            xp = fm_ops.sink_transposed(x)
            wc = plan.wc.to(dtype).contiguous()
            y = fm_ops.fused_bmm(xp, wc, ids)
            y_ref = fm_ref.ref_fused_bmm(xp, wc, ids)
            err = float((y.float() - y_ref.float()).abs().max())
            tol = FUSED_F32_TOL if dtype == torch.float32 else FUSED_BF16_TOL
            check(torch.allclose(y.float(), y_ref.float(), **tol),
                  f"fused_bmm == plain at {name}, {n_rows} rows, {dtype} "
                  f"(max abs err {err})")
            g, k, nc = wc.shape
            xg = xp[ids.long()].transpose(1, 2).contiguous()
            es = x.element_size()
            nbytes = es * (n_rows * (m + 1) + g * k * nc + g * n_rows * nc) \
                + 4 * g * k
            ops = 2 * g * n_rows * k * nc
            peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
            bnd, by = bound_ms(nbytes, ops, peak)
            big = n_rows * k * nc > 1e8
            it, wu = (20, 3) if big else (100, 10)
            rows.append(dict(
                proj=name, rows=n_rows, dtype=str(dtype), m=m, n=n, g=g,
                cap_m=k, cap_n=nc, max_abs_err=err,
                ms=time_ms(lambda: fm_ops.fused_bmm(xp, wc, ids), it, wu),
                plain_ms=time_ms(lambda: fm_ref.ref_fused_bmm(xp, wc, ids),
                                 it, wu),
                library_ms=time_ms(lambda: torch.bmm(xg, wc), it, wu),
                library="torch.bmm on pre-gathered operands (gather not "
                        "counted)",
                bound_ms=bnd, bound_by=by, peak_ops_per_s=peak))
            rows[-1]["tflops"] = ops / rows[-1]["ms"] / 1e9
    return rows


def _attn_pairs(s: int, window: int) -> int:
    """Allowed (query, key) pairs of a causal mask with an optional
    window: the work this run's masks need."""
    return sum(min(q + 1, window) if window > 0 else q + 1 for q in range(s))


def check_flash_kernel(cfg, device) -> list[dict]:
    """flash_fwd against its plain version (f32 math) at the prefill's
    shapes, and timed against SDPA with softcap 0 (SDPA has none)."""
    import torch.nn.functional as F
    b, hq, hkv, d = SERVE_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    rows = []
    for s, window in ((PREFILL_SEQ, 4096), (PREFILL_SEQ, 0), (512, 128)):
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device=device)
                   .to(torch.bfloat16) for h in (hq, hkv, hkv))
        kw = dict(causal=True, window=window, softcap=cfg.attn_softcap)
        out, lse = fa_ops.flash_fwd(q, k, v, **kw)
        o_ref, l_ref = fa_ref.ref_flash_fwd(q, k, v, **kw)
        err = float((out.float() - o_ref.float()).abs().max())
        lerr = float((lse - l_ref).abs().max())
        check(torch.allclose(out.float(), o_ref.float(), **FLASH_BF16_TOL)
              and torch.allclose(lse, l_ref, **LSE_TOL),
              f"flash_fwd == plain at S={s} window={window} (max abs err "
              f"{err}, lse {lerr})")
        pairs = _attn_pairs(s, window)
        nbytes = 2 * (2 * b * hq * s * d + 2 * b * hkv * s * d) + 4 * b * hq * s
        bnd, by = bound_ms(nbytes, 4 * d * pairs * b * hq, BF16_OPS_PER_S)
        kw0 = dict(kw, softcap=0.0)
        row = dict(
            s=s, window=window, max_abs_err=err, lse_max_abs_err=lerr,
            ms=time_ms(lambda: fa_ops.flash_fwd(q, k, v, **kw), 20, 3),
            plain_ms=time_ms(lambda: fa_ref.ref_flash_fwd(q, k, v, **kw),
                             10, 2),
            ms_softcap0=time_ms(lambda: fa_ops.flash_fwd(q, k, v, **kw0),
                                20, 3),
            bound_ms=bnd, bound_by=by, peak_ops_per_s=BF16_OPS_PER_S,
            library_ms=None)
        if window == 0 or window >= s:      # SDPA's causal mask is the same
            row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), 20, 3)
            row["library"] = ("F.scaled_dot_product_attention(is_causal, "
                              "enable_gqa), against ms_softcap0")
        rows.append(row)
    return rows


def run_serve(cfg, params, kernels) -> dict:
    """The serving path with every launch count at 0 first: a certify
    session, a B=4 x S=1024 prefill, one lockstep and one continuous
    Engine run."""
    plan_cache.clear()
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    session = ServeSession(cfg, params, plan_policy="certify")
    torch.cuda.synchronize()
    session_s = time.perf_counter() - t0
    dev = session.device
    rng = torch.Generator(device=dev).manual_seed(SEED + 4)
    tok = torch.randint(0, cfg.vocab, (SERVE_BATCH, PREFILL_SEQ),
                        generator=rng, device=dev)
    batch = {"tokens": tok, "positions": torch.arange(
        PREFILL_SEQ, device=dev).expand(SERVE_BATCH, PREFILL_SEQ)}
    prefill_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = session.prefill(batch)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    check(logits.shape == (SERVE_BATCH, 1, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          "prefill logits finite, (B, 1, vocab)")

    prompts = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab, (SERVE_BATCH, PROMPT)).astype(np.int32)
    lock_reqs = [Request(rid=i, prompt=prompts[i], max_new_tokens=GEN)
                 for i in range(SERVE_BATCH)]
    lock = Engine(session, SERVE_BATCH, max_seq_for(lock_reqs),
                  admission="lockstep").run(lock_reqs)
    cont_reqs = synthetic_requests(1, 16, vocab=cfg.vocab, p_arrive=0.5,
                                   prompt_len=(PROMPT // 2, PROMPT),
                                   gen_len=(GEN // 2, GEN))
    cont = Engine(session, SERVE_BATCH, max_seq_for(cont_reqs),
                  admission="continuous").run(cont_reqs)
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in kernels}
    for name in ("plan_rank", "plan_place", "fused_bmm", "flash_fwd"):
        check(launches[name] > 0, f"{name} launched on the serving path")
    check(launches["grouped_bmm_f32"] == 0,
          "grouped_bmm_f32 not launched on the serving path")
    for rep, reqs in ((lock, lock_reqs), (cont, cont_reqs)):
        check(rep.generated_tokens == sum(r.max_new_tokens for r in reqs)
              and all(0 <= t < cfg.vocab for r in rep.records
                      for t in r.tokens),
              f"{rep.admission}: every request completed with valid ids")
    return dict(
        launches=launches, session_s=session_s, prefill_s=prefill_s,
        prefill_ms=statistics.median(prefill_s) * 1e3,
        prefill_tokens_per_s=SERVE_BATCH * PREFILL_SEQ
        / statistics.median(prefill_s),
        lockstep=lock.summary(), continuous=cont.summary(),
        plan_cache=plan_cache.stats(), session=session)


def _blocks_slice(tree, n: int):
    if isinstance(tree, dict):
        return {k: _blocks_slice(v, n) for k, v in tree.items()}
    return tree[:n]


def _to(tree, device, copy: bool = False):
    if isinstance(tree, dict):
        return {k: _to(v, device, copy) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device, copy=copy)
    return tree


def _decode_steps(session, cfg, prompt, steps, cache=None, feed=None):
    """Replay ``prompt`` through the decode path (hidden states only) and
    take ``steps`` greedy steps, or the tokens ``feed`` gives. Returns
    (per-step logits, tokens fed, the cache just before the steps)."""
    params = session.params
    dev = session.device
    run = transformer.lm_apply
    with torch.inference_mode():
        if cache is None:
            cache = session.new_cache(1, len(prompt) + steps)
            for t in range(len(prompt) - 1):
                _, _, cache = run(params, cfg, torch.tensor(
                    [[int(prompt[t])]], device=dev), torch.tensor(
                    [[t]], device=dev), cache=cache, return_hidden=True)
        # a copy: the steps below write the ring buffers in place
        snap = _to(dict(cache, plans=()), "cpu", copy=True)
        logits, fed = [], [int(prompt[-1])]
        pos = len(prompt) - 1
        for j in range(steps):
            lg, _, cache = run(params, cfg, torch.tensor([[fed[-1]]], device=dev),
                               torch.tensor([[pos + j]], device=dev),
                               cache=cache)
            logits.append(lg[0, -1].float().cpu())
            if j + 1 < steps:
                fed.append(int(lg[0, -1].argmax()) if feed is None
                           else feed[j + 1])
    return torch.stack(logits), fed, snap


def cpu_replay(cfg, params) -> dict:
    """The first 2 blocks (4 layers) of the served weights, full width
    and vocab, on the card and on the CPU: the same B=1 x S=256 prefill
    and 8 greedy decode steps (the CPU's from the card's KV cache, fed
    the card's tokens); logits within REPLAY_BF16_TOL, greedy tokens
    equal wherever the CPU's top-2 margin exceeds that tolerance."""
    cfg4 = cfg.with_updates(n_layers=4)
    card_p = dict(params, blocks=_blocks_slice(params["blocks"], 2))
    cpu_p = _to(card_p, "cpu")
    card = ServeSession(cfg4, card_p)
    cpu = ServeSession(cfg4, cpu_p)
    check(same_plans(card.plans.plans, cpu.plans.plans)
          and int(card.plans.sig) == int(cpu.plans.sig),
          "plans encoded on the card == plans encoded on the CPU (4 layers)")
    prompt = np.random.default_rng(SEED + 5).integers(0, cfg.vocab, 256)
    batch = {"tokens": torch.as_tensor(prompt[None]),
             "positions": torch.arange(256)[None]}
    t0 = time.perf_counter()
    want = cpu.prefill(batch)[0, 0]
    cpu_prefill_s = time.perf_counter() - t0
    got = card.prefill(_to(batch, card.device))[0, 0].float().cpu()
    errs = {"prefill": float((got - want).abs().max())}
    check(torch.allclose(got, want, **REPLAY_BF16_TOL),
          f"replay prefill logits within {REPLAY_BF16_TOL} (max abs err "
          f"{errs['prefill']})")
    card_lg, fed, snap = _decode_steps(card, cfg4, prompt, 8)
    cache = dict(snap, plans=cpu.new_cache(1, 1)["plans"])
    t0 = time.perf_counter()
    cpu_lg, _, _ = _decode_steps(cpu, cfg4, prompt, 8, cache=cache, feed=fed)
    cpu_decode_s = time.perf_counter() - t0
    errs["decode"] = float((card_lg - cpu_lg).abs().max())
    check(torch.allclose(card_lg, cpu_lg, **REPLAY_BF16_TOL),
          f"replay decode logits within {REPLAY_BF16_TOL} (max abs err "
          f"{errs['decode']})")
    top2 = cpu_lg.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    clear = margin > (REPLAY_BF16_TOL["atol"]
                      + REPLAY_BF16_TOL["rtol"] * top2[:, 0].abs())
    same = card_lg.argmax(-1) == cpu_lg.argmax(-1)
    check(bool(same[clear].all()),
          "greedy tokens equal where the top-2 margin exceeds the tolerance")
    return dict(max_abs_err=errs, greedy_tokens=fed, clear_steps=int(clear.sum()),
                equal_tokens=int(same.sum()), cpu_prefill_s=cpu_prefill_s,
                cpu_decode_s=cpu_decode_s, tol=REPLAY_BF16_TOL)


def profile_serve(session, cfg) -> dict:
    """The profiler over one B=4 x S=1024 prefill and 8 decode steps."""
    dev = session.device
    tok = torch.randint(0, cfg.vocab, (SERVE_BATCH, PREFILL_SEQ), device=dev)
    batch = {"tokens": tok, "positions": torch.arange(
        PREFILL_SEQ, device=dev).expand(SERVE_BATCH, PREFILL_SEQ)}
    cache = session.new_cache(SERVE_BATCH, 16)

    def run():
        nonlocal cache
        session.prefill(batch)
        nxt = tok[:, :1]
        for t in range(8):
            nxt, cache = session.decode(cache, nxt, session.greedy_positions(
                SERVE_BATCH, t))
    return profile(run, SERVE_KERNELS)


# ---------------------------------------------------------------------------
# Training gemma2-2b
# ---------------------------------------------------------------------------

TRAIN_FLGW = dict(flgw_groups=4, flgw_path="grouped")   # launcher's targets
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 3
BMM_BF16_TOL = dict(rtol=1e-2, atol=1e-2)     # f32 sums, one bf16 rounding
FLASH_BWD_BF16_TOL = dict(rtol=1e-2, atol=1e-2)
# phase (a), the chunked core, against phase (b), the flash core: bf16
# activations rounded at other places, f32 softmax in both. The step-0
# loss is forward-only; the grad norm and each attention projection's
# grad (relative norm of the difference) see the backward kernels.
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_ATTN_GRAD_RTOL = 1e-3, 5e-3, 5e-2
REPLAY_TRAIN_TOL = dict(rtol=5e-2, atol=5e-2)
TRAIN_KERNELS = {"plan_rank": "rank_kernel", "plan_place": "place_kernel",
                 "grouped_bmm_bf16": "grouped_bmm_bf16_kernel",
                 "flash_fwd": "flash_fwd_kernel",
                 "flash_bwd_dq": "flash_bwd_dq_kernel",
                 "flash_bwd_dkv": "flash_bwd_dkv_kernel"}


def check_bmm_bf16_kernel(cfg, device) -> list[dict]:
    """grouped_bmm_bf16 against its plain version at the training MLP's
    compact products (4096 rows; up and gate share a shape), and one
    ragged case; timed against its plain version and ``torch.bmm``."""
    g = cfg.flgw_groups
    cap_d, cap_ff = compute_cap(cfg.d_model, g, 1.25), \
        compute_cap(cfg.d_ff, g, 1.25)
    rows_n = TRAIN_BATCH * TRAIN_SEQ
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    rows = []
    for name, k, n in (("up", cap_d, cap_ff), ("gate", cap_d, cap_ff),
                       ("down", cap_ff, cap_d), ("ragged", 37, 45)):
        b = rows_n if name != "ragged" else 70
        xg = torch.randn((g, b, k), generator=gen, device=device).bfloat16()
        wc = torch.randn((g, k, n), generator=gen, device=device).bfloat16()
        y = fm_ops.grouped_bmm(xg, wc)
        y_ref = fm_ref.ref_grouped_bmm(xg, wc)
        err = float((y.float() - y_ref.float()).abs().max())
        check(torch.allclose(y.float(), y_ref.float(), **BMM_BF16_TOL),
              f"grouped_bmm_bf16 == plain at {name} (max abs err {err})")
        bnd, by = bound_ms(2 * (g * b * k + g * k * n + g * b * n),
                           2 * g * b * k * n, BF16_OPS_PER_S)
        rows.append(dict(
            proj=name, g=g, b=b, k=k, n=n, max_abs_err=err,
            ms=time_ms(lambda: fm_ops.grouped_bmm(xg, wc), 20, 3),
            plain_ms=time_ms(lambda: fm_ref.ref_grouped_bmm(xg, wc), 20, 3),
            library_ms=time_ms(lambda: torch.bmm(xg, wc), 20, 3),
            bound_ms=bnd, bound_by=by))
        rows[-1]["tflops"] = 2 * g * b * k * n / rows[-1]["ms"] / 1e9
    return rows


def check_flash_bwd_kernels(cfg, device) -> list[dict]:
    """flash_bwd_dq and flash_bwd_dkv against the plain backward (f32
    math) at the training attention's shapes, bf16, softcap 50; each
    kernel timed alone, the plain backward and SDPA's backward (softcap
    0, where its causal mask is the same) for all three gradients."""
    import torch.nn.functional as F
    b, hq, hkv, d = TRAIN_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    rows = []
    for s, window in ((TRAIN_SEQ, 4096), (TRAIN_SEQ, 0), (512, 128)):
        q, do = (torch.randn((b, hq, s, d), generator=gen, device=device)
                 .bfloat16() for _ in range(2))
        k, v = (torch.randn((b, hkv, s, d), generator=gen, device=device)
                .bfloat16() for _ in range(2))
        kw = dict(causal=True, window=window, softcap=cfg.attn_softcap)
        out, lse = fa_ops.flash_fwd(q, k, v, **kw)
        got = fa_ops.flash_bwd(q, k, v, out, lse, do, **kw)
        want = fa_ref.ref_flash_bwd(q, k, v, out, lse, do, **kw)
        errs = {}
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            errs[name] = float((a.float() - w.float()).abs().max())
            check(torch.allclose(a.float(), w.float(), **FLASH_BWD_BF16_TOL),
                  f"flash_bwd {name} == plain at S={s} window={window} "
                  f"(max abs err {errs[name]})")
        delta = fa_ref.delta_of(out, do)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        args = (b, hq, hkv, s, s, d, d ** -0.5, 1, window,
                float(cfg.attn_softcap), 1)
        ptrs = [x.data_ptr() for x in (q, k, v, do, lse, delta)]
        pairs = _attn_pairs(s, window) * b * hq
        io = 2 * (2 * b * hq * s * d + 2 * b * hkv * s * d) + 8 * b * hq * s
        dq_io, dkv_io = io + 2 * b * hq * s * d, io + 4 * b * hkv * s * d
        dq_b, dq_by = bound_ms(dq_io, 6 * d * pairs, BF16_OPS_PER_S)
        dkv_b, dkv_by = bound_ms(dkv_io, 8 * d * pairs, BF16_OPS_PER_S)
        row = dict(
            s=s, window=window, max_abs_err=errs,
            dq_ms=time_ms(lambda: fa_ops.DQ(device, *ptrs, dq.data_ptr(),
                                            *args), 10, 2),
            dkv_ms=time_ms(lambda: fa_ops.DKV(device, *ptrs, dk.data_ptr(),
                                              dv.data_ptr(), *args), 10, 2),
            bwd_ms=time_ms(lambda: fa_ops.flash_bwd(q, k, v, out, lse, do,
                                                    **kw), 10, 2),
            plain_ms=time_ms(lambda: fa_ref.ref_flash_bwd(q, k, v, out, lse,
                                                          do, **kw), 5, 1),
            dq_bound_ms=dq_b, dq_bound_by=dq_by, dkv_bound_ms=dkv_b,
            dkv_bound_by=dkv_by,
            # the ceiling of these kernels' own design, f32 FMA outside
            # the tensor cores; not the card's bound for bf16 operands
            dq_f32_cores_bound_ms=bound_ms(dq_io, 6 * d * pairs)[0],
            dkv_f32_cores_bound_ms=bound_ms(dkv_io, 8 * d * pairs)[0],
            library_ms=None)
        if window == 0 or window >= s:
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            o = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                               enable_gqa=True)
            row["library_ms"] = time_ms(lambda: torch.autograd.grad(
                o, leaves, do, retain_graph=True), 10, 2)
            row["library"] = ("backward of F.scaled_dot_product_attention("
                              "is_causal, enable_gqa), softcap 0, all of "
                              "dq, dk, dv")
        rows.append(row)
    return rows


def _zero(kernels) -> None:
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()


def _check_train_launches(launches: dict, phase: str, flash: bool) -> None:
    for name in ("plan_rank", "plan_place", "grouped_bmm_bf16"):
        check(launches[name] > 0, f"{name} launched in training {phase}")
    for name in ("fused_bmm", "grouped_bmm_f32"):
        check(launches[name] == 0, f"{name} not launched in training {phase}")
    layers = 26 * TRAIN_STEPS
    if flash:
        # each layer's forward runs once more under remat in the backward
        check(launches["flash_bwd_dq"] == layers
              and launches["flash_bwd_dkv"] == layers
              and launches["flash_fwd"] == 2 * layers,
              f"flash kernels launched once per layer and step in {phase} "
              f"(flash_fwd twice, for the remat replay): {launches}")
    else:
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            check(launches[name] == 0, f"{name} not launched in {phase}")


def _attn_grads(params, batch, cfg) -> dict:
    """Step-0 grads of every attention projection (q, k, v, o of each
    layer slot, stacked over the blocks), as the train step computes
    them."""
    with torch.no_grad():
        plans = transformer.encode_plans(params, cfg)
    _, _, grads = step_lib.loss_and_grads(
        params, batch, cfg, q_chunk=step_lib.pick_q_chunk(TRAIN_SEQ),
        plans=plans)
    out = {f"{slot}/{proj}": g["mixer"][proj]["w"].float()
           for slot, g in grads["blocks"].items() if "mixer" in g
           for proj in ("q", "k", "v", "o")}
    del grads
    return out


def compare_core_grads(params, batch, cfg) -> dict:
    """||g_chunked - g_flash|| / ||g_chunked|| for each attention
    projection's step-0 grad, from one init and batch."""
    ga = _attn_grads(params, batch, cfg.with_updates(use_flash=False))
    gb = _attn_grads(params, batch, cfg)
    rel = {k: float((ga[k] - gb[k]).norm() / ga[k].norm()) for k in ga}
    for k, r in rel.items():
        check(r <= TRAIN_ATTN_GRAD_RTOL,
              f"step-0 grad of {k}, chunked vs flash core, within relative "
              f"norm {TRAIN_ATTN_GRAD_RTOL} ({r})")
    return rel


def run_train(kernels) -> dict:
    """Phase (a): ``train_lm`` (chunked core); phase (b):
    ``make_train_step`` with ``use_flash`` from the same init and
    batches. Launch counts at 0 before each."""
    dev = resolve_device()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero(kernels)
    state, hist = train_lm("gemma2_2b", smoke=False, steps=TRAIN_STEPS,
                           batch=TRAIN_BATCH, seq=TRAIN_SEQ, log_every=1,
                           seed=SEED, device=dev, **TRAIN_FLGW)
    torch.cuda.synchronize()
    la = {k.symbol: k.launches for k in kernels}
    _check_train_launches(la, "phase (a)", flash=False)
    a = dict(loss=[float(h["loss"]) for h in hist],
             grad_norm=[float(h["grad_norm"]) for h in hist],
             step_s=[h["step_s"] for h in hist], launches=la,
             peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    del state, hist
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)

    cfg = registry.get_config("gemma2_2b", **TRAIN_FLGW).with_updates(
        use_flash=True)
    state = state_lib.init_state(
        torch.Generator(device=dev).manual_seed(SEED), cfg)
    step = step_lib.make_train_step(cfg)
    ds = SyntheticTokens(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=SEED)
    attn_rel = compare_core_grads(state.params, ds.tensors_at(0, dev), cfg)
    print(f"  attention grads, chunked vs flash core (relative): {attn_rel}",
          flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero(kernels)
    b = dict(loss=[], grad_norm=[], step_s=[])
    for i in range(TRAIN_STEPS):
        batch = ds.tensors_at(i, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        b["step_s"].append(time.perf_counter() - t0)
        b["loss"].append(float(m["loss"]))
        b["grad_norm"].append(float(m["grad_norm"]))
        print(f"  flash step {i + 1}: loss={b['loss'][-1]:.4f} grad_norm="
              f"{b['grad_norm'][-1]:.4f} {b['step_s'][-1] * 1e3:.1f} ms",
              flush=True)
    lb = {k.symbol: k.launches for k in kernels}
    _check_train_launches(lb, "phase (b)", flash=True)
    b.update(launches=lb, peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    for ph in (a, b):
        check(all(np.isfinite(ph["loss"])) and all(np.isfinite(ph["grad_norm"])),
              "every training loss and grad norm finite")
    check(abs(a["loss"][0] - b["loss"][0]) <= TRAIN_LOSS_RTOL * abs(a["loss"][0]),
          f"step-0 loss, chunked vs flash core, within rtol {TRAIN_LOSS_RTOL} "
          f"({a['loss'][0]} vs {b['loss'][0]})")
    check(abs(a["grad_norm"][0] - b["grad_norm"][0])
          <= TRAIN_GNORM_RTOL * abs(a["grad_norm"][0]),
          f"step-0 grad norm, chunked vs flash core, within rtol "
          f"{TRAIN_GNORM_RTOL} ({a['grad_norm'][0]} vs {b['grad_norm'][0]})")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for ph in (a, b):
        ph["step_ms"] = statistics.median(ph["step_s"][1:]) * 1e3
        ph["tokens_per_s"] = tokens / (ph["step_ms"] / 1e3)
    return dict(chunked=a, flash=b, attn_grad_rel=attn_rel, state=state,
                step=step, cfg=cfg, ds=ds)


def train_replay(cfg, params) -> dict:
    """One training step's loss and grad norm on the first block (2
    layers) of the trained weights, full width and vocab, B=1 x S=128, on
    the card and on the CPU (each encoding its own plans, held bitwise
    equal)."""
    cfg2 = cfg.with_updates(n_layers=2)
    card_p = dict(params, blocks=_blocks_slice(params["blocks"], 1))
    cpu_p = _to(card_p, "cpu", copy=True)
    batch = SyntheticTokens(cfg.vocab, 1, 128, seed=SEED + 8).tensors_at(0)
    out = {}
    plans = {}
    for where, p in (("card", card_p), ("cpu", cpu_p)):
        dev = p["embed"]["embedding"].device
        with torch.no_grad():
            plans[where] = transformer.encode_plans(p, cfg2)
        t0 = time.perf_counter()
        loss, _, grads = step_lib.loss_and_grads(
            p, {k: v.to(dev) for k, v in batch.items()}, cfg2, q_chunk=128,
            plans=plans[where])
        out[where] = (float(loss), float(global_norm(grads)),
                      time.perf_counter() - t0)
        del grads
    check(same_plans(plans["card"].plans, plans["cpu"].plans),
          "training replay: plans encoded on the card == on the CPU")
    errs = {}
    for i, name in enumerate(("loss", "grad_norm")):
        a, b = out["card"][i], out["cpu"][i]
        errs[name] = abs(a - b)
        check(errs[name] <= REPLAY_TRAIN_TOL["atol"]
              + REPLAY_TRAIN_TOL["rtol"] * abs(b),
              f"training replay {name} within {REPLAY_TRAIN_TOL} ({a} on the "
              f"card, {b} on the CPU)")
    return dict(card=out["card"][:2], cpu=out["cpu"][:2], abs_err=errs,
                cpu_s=out["cpu"][2], tol=REPLAY_TRAIN_TOL)


def profile_train(tr) -> dict:
    """The profiler over one more flash training step."""
    batch = tr["ds"].tensors_at(TRAIN_STEPS, resolve_device())

    def run():
        tr["state"], _ = tr["step"](tr["state"], batch)
    return profile(run, TRAIN_KERNELS)


# ---------------------------------------------------------------------------
# OSEL: the mask-encode kernel and the sparse row memory
# ---------------------------------------------------------------------------

# every FLGW side of gemma2-2b's MLP and attention (d 2304, d_ff 9216,
# 8 x 256 query and 4 x 256 key/value features)
OSEL_GEMMA = ((2304, 9216), (9216, 2304), (2304, 2048), (2304, 1024),
              (2048, 2304))
FIG10_M, FIG10_N, FIG10_G = 128, 512, (2, 4, 8, 16, 32)
FIG10_SWEEP = (2048, 4096, 8192)     # N = M / 4 at G = 8
OSEL_RAGGED = ((1, 64), (257, 129), (300, 200))


def _osel_cases(ic3_params, device) -> list:
    """(label, ig_idx, og_idx) of every shape the OSEL phase holds the
    kernel at: random G=4 indices at gemma2-2b's FLGW sides, the actor
    model's own grouping indices, Fig. 10's grid and ragged shapes."""
    gen = torch.Generator(device=device).manual_seed(SEED + 9)

    def rand(m, n, g):
        return (torch.randint(0, g, (m,), generator=gen, device=device),
                torch.randint(0, g, (n,), generator=gen, device=device))
    cases = [(f"gemma2_2b {m}x{n} G=4", *rand(m, n, 4))
             for m, n in OSEL_GEMMA]
    for path, p in grouped.iter_flgw_layers(ic3_params):
        ig, og = flgw.grouping_indices(p["ig"].detach(), p["og"].detach())
        cases.append((f"ic3net {path[-1]}", ig, og))
    cases += [(f"fig10 {FIG10_M}x{FIG10_N} G={g}",
               *rand(FIG10_M, FIG10_N, g)) for g in FIG10_G]
    cases += [(f"fig10 {m}x{m // 4} G=8", *rand(m, m // 4, 8))
              for m in FIG10_SWEEP]
    cases += [(f"ragged {m}x{n} G=4", *rand(m, n, 4))
              for m, n in OSEL_RAGGED]
    return cases


def run_osel(ic3_params, device) -> dict:
    """The OSEL phase. With the counts at 0: the kernel held bitwise at
    every case, then the encoder at Fig. 10's 128 x 512 (each G) checked
    against the mask by indices, the IS @ OS baseline and the CPU encode;
    the launches equal the osel_mask and encode calls made. Then the
    kernel timed at the largest mask, and profiled."""
    _zero((os_ops.OSEL,))
    rows = []
    calls = 0
    for label, ig, og in _osel_cases(ic3_params, device):
        got = os_ops.osel_mask(ig, og)
        calls += 1
        want = os_ref.ref_mask_indices(ig, og).to(torch.uint8)
        err = int((got.int() - want.int()).abs().max()) if got.numel() else 0
        check(torch.equal(got, want),
              f"osel_encode == plain, bitwise, at {label} (max abs err {err})")
        rows.append(dict(case=label, m=ig.shape[0], n=og.shape[0],
                         max_abs_err=err))
    torch.cuda.synchronize()
    holds = os_ops.OSEL.launches

    # the OSEL path: the sparse row memory, forward and transposed
    _zero((os_ops.OSEL,))
    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    for g in FIG10_G:
        ig = torch.randn((FIG10_M, g), generator=gen, device=device)
        og = torch.randn((g, FIG10_N), generator=gen, device=device)
        ig_idx, og_idx = flgw.grouping_indices(ig, og)
        mem = osel.encode(ig_idx, og_idx, g)
        tmem = osel.transpose_encode(ig_idx, og_idx, g)
        mask = flgw.mask_from_indices(ig_idx, og_idx, torch.bool)
        check(torch.equal(osel.mask_from_memory(mem), mask)
              and torch.equal(os_ops.reference_mask(ig, og), mask),
              f"OSEL memory == mask by indices == IS @ OS at G={g}")
        check(torch.equal(osel.mask_from_memory(tmem), mask.T),
              f"transpose_encode gives the transposed mask at G={g}")
        cpu = osel.encode(ig_idx.cpu(), og_idx.cpu(), g)
        check(all(torch.equal(a.cpu(), b) for a, b in zip(mem, cpu)),
              f"OSEL memory on the card == on the CPU, bitwise, at G={g}")
    torch.cuda.synchronize()
    path_launches = os_ops.OSEL.launches
    encodes = 2 * len(FIG10_G)
    check(holds == calls and path_launches == encodes,
          f"osel_encode launched once per osel_mask ({holds} of {calls}) "
          f"and encode call ({path_launches} of {encodes})")

    m, n = OSEL_GEMMA[0]
    ig = torch.randint(0, 4, (m,), generator=gen, device=device,
                       dtype=torch.int32)
    og = torch.randint(0, 4, (n,), generator=gen, device=device,
                       dtype=torch.int32)
    bnd, by = bound_ms(m * n + 4 * (m + n), m * n)
    timing = dict(
        m=m, n=n, ms=time_ms(lambda: os_ops.osel_mask(ig, og)),
        plain_ms=time_ms(lambda: os_ref.ref_mask_indices(ig, og).to(
            torch.uint8)),
        library_ms=time_ms(lambda: torch.eq(ig[:, None], og[None, :])),
        library="torch.eq(ig[:, None], og[None, :]) (bool out)",
        bound_ms=bnd, bound_by=by)
    timing["gb_per_s"] = (m * n + 4 * (m + n)) / timing["ms"] / 1e6
    prof = profile(lambda: [os_ops.osel_mask(ig, og) for _ in range(50)],
                   {"osel_encode": "osel_encode_kernel"})
    return dict(rows=rows, holds=holds, launches=path_launches,
                timing=timing, profile=prof)


def fpga_model_table() -> list[dict]:
    """The paper's FPGA encoder at Fig. 10's 128 x 512: cycles and
    on-chip bytes with and without OSEL (a model, not a measurement)."""
    rows = []
    for g in FIG10_G:
        c_osel = osel.cycle_model(FIG10_M, FIG10_N, g)["total"]
        c_base = osel.cycle_model(FIG10_M, FIG10_N, g, use_osel=False)["total"]
        f_dense = osel.footprint_model(FIG10_M, FIG10_N, g,
                                       use_grouping=False)["total"]
        f_grp = osel.footprint_model(FIG10_M, FIG10_N, g)["total"]
        rows.append(dict(g=g, cycles_osel=c_osel, cycles_baseline=c_base,
                         cycle_speedup=c_base / c_osel, bytes_dense=f_dense,
                         bytes_grouped=f_grp, footprint_ratio=f_dense / f_grp))
    return rows


# ---------------------------------------------------------------------------
# Training IC3Net: the A2C learner
# ---------------------------------------------------------------------------

LEARN_ITERS = 10
LEARN_SCHEDULE = SparsitySchedule(groups=4, warmup_steps=2)
LEARN_REPLAY_LOSS_RTOL, LEARN_REPLAY_GRAD_REL = 1e-5, 1e-4
LEARN_KERNELS = {"plan_rank": "rank_kernel", "plan_place": "place_kernel",
                 "grouped_bmm_f32": "grouped_bmm_kernel"}
# benchmarks/fig9_accuracy.py's config; the JAX package's final success
# rates (mean of the last 80 iterations) at G=4: masked from
# BENCH_fig9_accuracy.json, grouped from repro.marl.train.train under
# use_reference_impl() (the command is in PERF.md). Philox and threefry
# give other episodes, so the port is held to a band around them.
FIG9_ENV = dict(n_agents=4, size=4, max_steps=12)
FIG9_ITERS, FIG9_TAIL = 800, 80
FIG9_JAX_PCT = {"masked": 93.3, "grouped": 87.2}
FIG9_BAND_PCT = 15.0


def run_learner(kernels, device) -> dict:
    """10 iterations of ``train`` at full width with every launch count at
    0 first; the launches checked exactly."""
    env, ecfg = envs.make("predator_prey", **ENV)
    cfg = dataclasses.replace(configs.config(), flgw_groups=4,
                              flgw_path="grouped")
    tcfg = train.TrainConfig(batch=BATCH, lr=1e-3)
    _zero(kernels)
    t0 = time.perf_counter()
    model, hist = train.train(cfg, ecfg, tcfg, iterations=LEARN_ITERS,
                              seed=SEED, env=env, schedule=LEARN_SCHEDULE,
                              device=device)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in kernels}
    layers = len(list(grouped.iter_flgw_layers(model.params)))
    encodes = LEARN_ITERS + 1           # one before the loop, one a step
    sparse_iters = LEARN_ITERS - LEARN_SCHEDULE.warmup_steps
    want = {k.symbol: 0 for k in kernels}
    want.update(plan_rank=2 * layers * encodes,
                plan_place=2 * layers * encodes,
                grouped_bmm_f32=sparse_iters * layers * ecfg.max_steps)
    check(launches == want,
          f"IC3Net learner launches {launches} == {want}")
    check(all(np.isfinite(h["loss"]) for h in hist),
          "every learner loss finite")
    check(all(h["mask_sparsity"] == 0.0 for h in
              hist[:LEARN_SCHEDULE.warmup_steps])
          and all(h["mask_sparsity"] > 0.5 for h in
                  hist[LEARN_SCHEDULE.warmup_steps:]),
          "mask_sparsity 0 on the warmup, the grouped layout's after")
    sparse = hist[LEARN_SCHEDULE.warmup_steps:]
    return dict(
        launches=launches, wall_s=wall_s, history=hist,
        ms_per_iter=statistics.median(1e3 / h["steps_per_s"]
                                      for h in sparse),
        env_steps_per_s=statistics.median(h["env_steps_per_s"]
                                          for h in sparse),
        sparse_gflops=statistics.median(h["sparse_gflops"] for h in sparse),
        model=model, env=env, ecfg=ecfg, tcfg=tcfg)


def _grad_leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _grad_leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def learner_replay(lr: dict) -> dict:
    """One more learner iteration on the card (sparse, it = LEARN_ITERS),
    its sampled actions and gates recorded, replayed through a CPU copy
    of the model with the same weights and plans."""
    model, env, ecfg, tcfg = lr["model"], lr["env"], lr["ecfg"], lr["tcfg"]
    with torch.no_grad():
        plans = model.encode_plans()
    cpu_model = ic3net.IC3Net(model.cfg, seed=SEED, device="cpu")
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    with torch.no_grad():
        cpu_plans = cpu_model.encode_plans()
    check(same_plans(plans.plans, cpu_plans.plans)
          and int(plans.sig) == int(cpu_plans.sig),
          "learner replay: plans encoded on the card == on the CPU")
    gen = train.make_generator(SEED + 20, model.device)
    state = env.reset(gen, ecfg, tcfg.batch)
    start = type(state)(*(v.cpu() for v in state))
    draw = train.sampler(gen)
    record = []

    def sample(t, logits, gate_logits):
        a, g = draw(t, logits, gate_logits)
        record.append((a, g))
        return a, g
    out = {}
    m, g = train._loss_grads(model, env, ecfg, tcfg, state, sample,
                             LEARN_ITERS, LEARN_SCHEDULE, plans)
    out["card"] = (float(m["loss"]), dict(_grad_leaves(g)))
    rec = [(a.cpu(), gt.cpu()) for a, gt in record]
    t0 = time.perf_counter()
    m, g = train._loss_grads(cpu_model, env, ecfg, tcfg, start,
                             lambda t, lg, gl: rec[t], LEARN_ITERS,
                             LEARN_SCHEDULE, cpu_plans)
    cpu_s = time.perf_counter() - t0
    out["cpu"] = (float(m["loss"]), dict(_grad_leaves(g)))
    loss_card, loss_cpu = out["card"][0], out["cpu"][0]
    check(abs(loss_card - loss_cpu) <= LEARN_REPLAY_LOSS_RTOL * abs(loss_cpu),
          f"learner replay loss within rtol {LEARN_REPLAY_LOSS_RTOL} "
          f"({loss_card} on the card, {loss_cpu} on the CPU)")
    rel = {}
    for name, want in out["cpu"][1].items():
        got = out["card"][1][name].detach().cpu()
        if name.startswith("gate."):
            check(not got.any() and not want.any(),
                  f"the gate head's gradient {name} exactly 0 on both")
            continue
        rel[name] = float((got - want).norm() / want.norm())
        check(rel[name] <= LEARN_REPLAY_GRAD_REL,
              f"learner replay gradient {name} within relative norm "
              f"{LEARN_REPLAY_GRAD_REL} ({rel[name]})")
    return dict(loss=(loss_card, loss_cpu), grad_rel=rel, cpu_s=cpu_s)


def profile_learner(lr: dict) -> dict:
    """The profiler over one sparse learner iteration: the plan refresh,
    the reset, the rollout under autograd, the backward and RMSprop."""
    model, env, ecfg, tcfg = lr["model"], lr["env"], lr["ecfg"], lr["tcfg"]
    with torch.no_grad():
        plans = model.encode_plans()
    opt = rmsprop_init(model.params)
    gen = train.make_generator(SEED + 21, model.device)
    sample = train.sampler(gen)

    def run():
        p = train.maybe_refresh_plans(model, plans, LEARN_ITERS + 1,
                                      LEARN_SCHEDULE)
        state = env.reset(gen, ecfg, tcfg.batch)
        _, m = train.train_step(model, opt, env, ecfg, tcfg, state, sample,
                                LEARN_ITERS + 1, LEARN_SCHEDULE, p)
        float(m["loss"])
    run()       # warm
    return profile(run, LEARN_KERNELS)


def learning_check(device) -> dict:
    """The Fig. 9 config trained on the card on the masked and the grouped
    path; each final success rate within FIG9_BAND_PCT points of the JAX
    package's."""
    env, ecfg = envs.make("predator_prey", **FIG9_ENV)
    out = {}
    for path in ("masked", "grouped"):
        cfg = ic3net.IC3NetConfig(hidden=128, flgw_groups=4, flgw_path=path)
        t0 = time.perf_counter()
        _, hist = train.train(cfg, ecfg, train.TrainConfig(batch=BATCH),
                              iterations=FIG9_ITERS, seed=SEED, env=env,
                              device=device)
        wall_s = time.perf_counter() - t0
        succ = np.array([h["success"] for h in hist]) * 100
        out[path] = dict(
            final_pct=float(succ[-FIG9_TAIL:].mean()),
            first_pct=float(succ[:FIG9_TAIL].mean()),
            mean_pct=float(succ.mean()),
            mask_sparsity=hist[-1]["mask_sparsity"], wall_s=wall_s,
            ms_per_iter=statistics.median(1e3 / h["steps_per_s"]
                                          for h in hist),
            jax_final_pct=FIG9_JAX_PCT[path])
        print(f"  learning check {path}: final success "
              f"{out[path]['final_pct']:.2f} % (JAX package "
              f"{FIG9_JAX_PCT[path]} %), first {FIG9_TAIL} "
              f"{out[path]['first_pct']:.2f} %, mean "
              f"{out[path]['mean_pct']:.2f} %, sparsity "
              f"{out[path]['mask_sparsity']:.4f}, {wall_s:.1f} s", flush=True)
    for path, r in out.items():
        floor = FIG9_JAX_PCT[path] - FIG9_BAND_PCT
        check(r["final_pct"] >= floor,
              f"learning check {path}: final success {r['final_pct']:.2f} "
              f"% >= {floor:.1f} % (JAX {FIG9_JAX_PCT[path]} % less "
              f"{FIG9_BAND_PCT})")
    return out


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
    all_kernels = (pe_ops.RANK, pe_ops.PLACE, fm_ops.BMM, fm_ops.BMM16,
                   fm_ops.FUSED, fa_ops.FWD, fa_ops.DQ, fa_ops.DKV,
                   os_ops.OSEL)

    # -- path 1: the IC3Net actor -------------------------------------------
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

    enc_rows = check_encode_kernels(model, slack)
    with torch.inference_mode():
        plans = model.encode_plans()
    bmm_rows = check_bmm_kernel(model, plans, BATCH * cfg.n_agents)
    print("IC3Net kernels match their plain versions on the card; plan_rank "
          "and plan_place have no single PyTorch call to time as a library "
          "yardstick (library_ms null), grouped_bmm_f32 has torch.bmm",
          flush=True)

    sl = run_slice(model, cpu_model, env, ecfg, all_kernels)
    print(f"slice 1: launches {sl['launches']}, encode {sl['encode_ms']:.3f} "
          f"ms, rollout {sl['rollout_s'] * 1e3:.2f} ms, "
          f"{sl['env_steps_per_s']:.1f} env-steps/s, replay max abs err "
          f"{sl['replay_max_abs_err']}", flush=True)
    prof = profile_path(model, env, ecfg, {
        "plan_rank": "rank_kernel", "plan_place": "place_kernel",
        "grouped_bmm_f32": "grouped_bmm_kernel"})
    print_profile("encode + rollout", prof)
    ic3_params = model.params        # the OSEL phase's IC3Net layers
    del model, cpu_model, plans

    # -- path 2: serving gemma2-2b -------------------------------------------
    dev = resolve_device()
    scfg = registry.get_config("gemma2_2b", **SERVE_FLGW)
    params = serve_params(scfg, dev)
    n_params = sum(t.numel() for t in _leaves(params))
    fused_rows = check_fused_kernel(params, scfg)
    flash_rows = check_flash_kernel(scfg, dev)
    for r in fused_rows:
        print(f"  fused_bmm {r['proj']:>4} {r['rows']:>4} rows {r['dtype']}: "
              f"{r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s), plain "
              f"{r['plain_ms']:.4f}, bmm {r['library_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']})")
    for r in flash_rows:
        print(f"  flash_fwd S={r['s']} window={r['window']}: {r['ms']:.4f} "
              f"ms (softcap 0: {r['ms_softcap0']:.4f}), plain "
              f"{r['plain_ms']:.4f}, sdpa {r['library_ms']}, bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']})")
    print(f"gemma2-2b: {n_params:,} parameters; fused_bmm matches its plain "
          f"version at {len(fused_rows)} shapes (max abs err "
          f"{max(r['max_abs_err'] for r in fused_rows):.3g}), flash_fwd at "
          f"{len(flash_rows)} (max abs err "
          f"{max(r['max_abs_err'] for r in flash_rows):.3g})", flush=True)
    sv = run_serve(scfg, params, all_kernels)
    session = sv.pop("session")
    lk, ct = sv["lockstep"], sv["continuous"]
    print(f"slice 2: launches {sv['launches']}; prefill B={SERVE_BATCH} x "
          f"S={PREFILL_SEQ} {sv['prefill_ms']:.1f} ms "
          f"({sv['prefill_tokens_per_s']:.0f} tokens/s); lockstep "
          f"{lk['tokens_per_s']:.1f} tokens/s, p50 {lk['p50_s']:.3f} s, "
          f"p99 {lk['p99_s']:.3f} s; continuous {ct['tokens_per_s']:.1f} "
          f"tokens/s, p50 {ct['p50_s']:.3f} s, p99 {ct['p99_s']:.3f} s; plan "
          f"cache {sv['plan_cache']['encodes']} encodes, "
          f"{sv['plan_cache']['hits']} hits", flush=True)
    rp = cpu_replay(scfg, params)
    print(f"CPU replay (4 layers): max abs err {rp['max_abs_err']}, "
          f"{rp['equal_tokens']}/8 greedy tokens equal "
          f"({rp['clear_steps']} with a clear top-2 margin)", flush=True)
    sprof = profile_serve(session, scfg)
    print_profile("prefill + 8 decode steps", sprof)
    del session, params
    plan_cache.clear()
    torch.cuda.empty_cache()

    # -- path 3: training gemma2-2b ------------------------------------------
    tcfg = registry.get_config("gemma2_2b", **TRAIN_FLGW)
    bmm16_rows = check_bmm_bf16_kernel(tcfg, dev)
    bwd_rows = check_flash_bwd_kernels(tcfg, dev)
    for r in bmm16_rows:
        print(f"  grouped_bmm_bf16 {r['proj']:>6} {r['b']} rows: "
              f"{r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s), plain "
              f"{r['plain_ms']:.4f}, bmm {r['library_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']})")
    for r in bwd_rows:
        print(f"  flash_bwd S={r['s']} window={r['window']}: dq "
              f"{r['dq_ms']:.4f} ms (bound {r['dq_bound_ms']:.4f}), dkv "
              f"{r['dkv_ms']:.4f} ms (bound {r['dkv_bound_ms']:.4f}), both "
              f"{r['bwd_ms']:.4f}, plain {r['plain_ms']:.4f}, sdpa bwd "
              f"{r['library_ms']}", flush=True)
    print(f"training kernels match their plain versions: grouped_bmm_bf16 "
          f"max abs err {max(r['max_abs_err'] for r in bmm16_rows):.3g}, "
          f"flash_bwd {max(max(r['max_abs_err'].values()) for r in bwd_rows):.3g}",
          flush=True)
    tr = run_train(all_kernels)
    ca, fl = tr["chunked"], tr["flash"]
    print(f"slice 3: chunked core {ca['step_ms']:.1f} ms/step "
          f"({ca['tokens_per_s']:.0f} tokens/s), losses {ca['loss']}, grad "
          f"norms {ca['grad_norm']}, peak {ca['peak_gb']:.1f} GB; flash core "
          f"{fl['step_ms']:.1f} ms/step ({fl['tokens_per_s']:.0f} tokens/s), "
          f"losses {fl['loss']}, grad norms {fl['grad_norm']}, peak "
          f"{fl['peak_gb']:.1f} GB; launches (a) {ca['launches']}, (b) "
          f"{fl['launches']}", flush=True)
    tp = train_replay(tr["cfg"], tr["state"].params)
    print(f"CPU replay of a training step (2 layers): card {tp['card']}, "
          f"CPU {tp['cpu']} (loss, grad norm)", flush=True)
    tprof = profile_train(tr)
    print_profile("one flash training step", tprof)
    train_out = dict(chunked=ca, flash=fl, attn_grad_rel=tr["attn_grad_rel"],
                     tol=dict(loss_rtol=TRAIN_LOSS_RTOL,
                              gnorm_rtol=TRAIN_GNORM_RTOL,
                              attn_grad_rtol=TRAIN_ATTN_GRAD_RTOL))
    del tr
    torch.cuda.empty_cache()

    # -- the OSEL encoder (the mask-encode kernel) ----------------------------
    os_ = run_osel(ic3_params, dev)
    ot = os_["timing"]
    print(f"OSEL: osel_encode bitwise equal to its plain version at "
          f"{len(os_['rows'])} shapes; the encoder at {FIG10_M}x{FIG10_N}, "
          f"G in {FIG10_G}: {os_['launches']} launches, memory == mask by "
          f"indices == IS @ OS; at {ot['m']}x{ot['n']}: {ot['ms']:.4f} ms "
          f"({ot['gb_per_s']:.0f} GB/s), plain {ot['plain_ms']:.4f}, "
          f"torch.eq {ot['library_ms']:.4f}, bound {ot['bound_ms']:.4f} "
          f"({ot['bound_by']})", flush=True)
    print_profile("50 x osel_mask at 2304x9216", os_["profile"])
    fpga = fpga_model_table()
    print(f"FPGA model of the paper's encoder at {FIG10_M}x{FIG10_N} "
          "(osel.cycle_model / footprint_model: a model of the FPGA, not a "
          "card measurement):")
    for r in fpga:
        print(f"  G={r['g']:>2}: cycles OSEL {r['cycles_osel']:.0f}, "
              f"baseline {r['cycles_baseline']:.0f} "
              f"({r['cycle_speedup']:.2f}x); bytes dense "
              f"{r['bytes_dense']:.0f}, grouped {r['bytes_grouped']:.0f} "
              f"({r['footprint_ratio']:.2f}x)")

    # -- path 4: training IC3Net (the A2C learner) --------------------------
    lr = run_learner(all_kernels, dev)
    print(f"slice 4: IC3Net learner, {LEARN_ITERS} iterations "
          f"({LEARN_SCHEDULE.warmup_steps} dense): launches {lr['launches']}; "
          f"{lr['ms_per_iter']:.2f} ms per sparse iteration (median), "
          f"{lr['env_steps_per_s']:.1f} env-steps/s, "
          f"{lr['sparse_gflops']:.3f} sparse GFLOP/s; losses "
          f"{[round(h['loss'], 4) for h in lr['history']]}", flush=True)
    lrep = learner_replay(lr)
    print(f"CPU replay of a learner iteration: loss {lrep['loss']} (card, "
          f"CPU); max gradient relative difference "
          f"{max(lrep['grad_rel'].values()):.3g}; gate head 0 on both",
          flush=True)
    lprof = profile_learner(lr)
    print_profile("one sparse learner iteration", lprof)
    learner_out = {k: v for k, v in lr.items()
                   if k not in ("model", "env", "ecfg", "tcfg")}
    del lr
    fig9 = learning_check(dev)

    def total(rows, key):
        return sum(r[key] for r in rows)

    def bound_by(rows, key):
        return max(rows, key=lambda r: r[f"{key}_bound_ms"])[f"{key}_bound_by"]

    def path_launches(sym):
        return {"ic3net_actor": sl["launches"][sym],
                "gemma2_serve": sv["launches"][sym],
                "gemma2_train_chunked": ca["launches"][sym],
                "gemma2_train_flash": fl["launches"][sym],
                "osel": os_["launches"] if sym == "osel_encode" else 0,
                "ic3net_learner": learner_out["launches"][sym]}

    def launches(sym):
        return sum(path_launches(sym).values())

    prefill_layer = [r for r in fused_rows if r["rows"] == 4096]
    train_layer = [r for r in bmm16_rows if r["proj"] != "ragged"]
    bwd_timed = (f"one call at B={TRAIN_BATCH}, Hq=8, Hkv=4, S={TRAIN_SEQ}, "
                 "D=256, causal, window 0, softcap 50, bf16; bound: dq "
                 "6 D, dkv 8 D flops per allowed (query, key) pair at 989 "
                 "TFLOP/s (bf16 tensor cores); f32_cores_bound_ms: the same "
                 "flops at 67 TFLOP/s (f32 outside the tensor cores, where "
                 "these kernels compute); plain ms and library ms (SDPA's "
                 "backward, softcap 0) compute dq, dk and dv together")
    per_encode = "one encode: its calls at the path's 10 FLGW layer sides"
    kernels_line = {"kernels": [
        dict(name="plan_rank", route="cuda",
             source="src/repro_torch/csrc/plan_encode.cu",
             replaces="src/repro/kernels/plan_encode/plan_encode.py:50",
             launches=launches("plan_rank"),
             launches_by_path=path_launches("plan_rank"),
             max_abs_err=max(r["rank_max_abs_err"] for r in enc_rows),
             ms=total(enc_rows, "rank_ms"),
             plain_ms=total(enc_rows, "rank_plain_ms"),
             bound_ms=total(enc_rows, "rank_bound_ms"),
             bound_by=bound_by(enc_rows, "rank"), library_ms=None,
             timed_over=per_encode),
        dict(name="plan_place", route="cuda",
             source="src/repro_torch/csrc/plan_encode.cu",
             replaces="src/repro/kernels/plan_encode/plan_encode.py:81",
             launches=launches("plan_place"),
             launches_by_path=path_launches("plan_place"),
             max_abs_err=max(r["place_max_abs_err"] for r in enc_rows),
             ms=total(enc_rows, "place_ms"),
             plain_ms=total(enc_rows, "place_plain_ms"),
             bound_ms=total(enc_rows, "place_bound_ms"),
             bound_by=bound_by(enc_rows, "place"), library_ms=None,
             timed_over=per_encode),
        dict(name="grouped_bmm_f32", route="cuda",
             source="src/repro_torch/csrc/flgw_matmul.cu",
             replaces="src/repro/kernels/flgw_matmul/flgw_matmul.py:38",
             launches=launches("grouped_bmm_f32"),
             launches_by_path=path_launches("grouped_bmm_f32"),
             max_abs_err=max(r["max_abs_err"] for r in bmm_rows),
             ms=total(bmm_rows, "ms"), plain_ms=total(bmm_rows, "plain_ms"),
             bound_ms=total(bmm_rows, "bound_ms"),
             bound_by=max(bmm_rows, key=lambda r: r["bound_ms"])["bound_by"],
             library_ms=total(bmm_rows, "library_ms"),
             timed_over="one policy step: its calls at the path's 5 FLGW "
                        "layers"),
        dict(name="grouped_bmm_bf16", route="cuda",
             source="src/repro_torch/csrc/flgw_matmul.cu",
             replaces="src/repro/kernels/flgw_matmul/flgw_matmul.py:38",
             launches=launches("grouped_bmm_bf16"),
             launches_by_path=path_launches("grouped_bmm_bf16"),
             max_abs_err=max(r["max_abs_err"] for r in bmm16_rows),
             ms=total(train_layer, "ms"),
             plain_ms=total(train_layer, "plain_ms"),
             bound_ms=total(train_layer, "bound_ms"),
             bound_by=max(train_layer,
                          key=lambda r: r["bound_ms"])["bound_by"],
             library_ms=total(train_layer, "library_ms"),
             timed_over="one training layer's forward: its 3 MLP products "
                        "(up, gate, down) at 4096 rows, bf16; bound at 989 "
                        "TFLOP/s (bf16 tensor cores); library = torch.bmm "
                        "on the same compact operands"),
        dict(name="fused_bmm", route="cuda",
             source="src/repro_torch/csrc/flgw_matmul.cu",
             replaces="src/repro/kernels/flgw_matmul/flgw_matmul.py:93",
             launches=launches("fused_bmm"),
             launches_by_path=path_launches("fused_bmm"),
             max_abs_err=max(r["max_abs_err"] for r in fused_rows),
             ms=total(prefill_layer, "ms"),
             plain_ms=total(prefill_layer, "plain_ms"),
             bound_ms=total(prefill_layer, "bound_ms"),
             bound_by=max(prefill_layer,
                          key=lambda r: r["bound_ms"])["bound_by"],
             library_ms=total(prefill_layer, "library_ms"),
             timed_over="one prefill layer: its 7 projections at 4096 rows, "
                        "bf16; bound at 989 TFLOP/s (bf16 tensor cores); "
                        "library = torch.bmm on pre-gathered operands, "
                        "gather not counted"),
        dict(name="flash_fwd", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/"
                      "flash_attention.py:67",
             launches=launches("flash_fwd"),
             launches_by_path=path_launches("flash_fwd"),
             max_abs_err=max(r["max_abs_err"] for r in flash_rows),
             ms=flash_rows[1]["ms"], plain_ms=flash_rows[1]["plain_ms"],
             bound_ms=flash_rows[1]["bound_ms"],
             bound_by=flash_rows[1]["bound_by"],
             library_ms=flash_rows[1]["library_ms"],
             ms_softcap0=flash_rows[1]["ms_softcap0"],
             timed_over=f"one call at B={SERVE_BATCH}, Hq=8, Hkv=4, "
                        f"S={PREFILL_SEQ}, D=256, causal, softcap 50; bound "
                        "at 989 TFLOP/s (bf16 tensor cores); library = SDPA "
                        "(no softcap), compare with ms_softcap0"),
        dict(name="flash_bwd_dq", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/"
                      "flash_attention.py:178",
             launches=launches("flash_bwd_dq"),
             launches_by_path=path_launches("flash_bwd_dq"),
             max_abs_err=max(r["max_abs_err"]["dq"] for r in bwd_rows),
             ms=bwd_rows[1]["dq_ms"], plain_ms=bwd_rows[1]["plain_ms"],
             bound_ms=bwd_rows[1]["dq_bound_ms"],
             bound_by=bwd_rows[1]["dq_bound_by"],
             f32_cores_bound_ms=bwd_rows[1]["dq_f32_cores_bound_ms"],
             library_ms=bwd_rows[1]["library_ms"],
             timed_over=bwd_timed),
        dict(name="flash_bwd_dkv", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/"
                      "flash_attention.py:205",
             launches=launches("flash_bwd_dkv"),
             launches_by_path=path_launches("flash_bwd_dkv"),
             max_abs_err=max(max(r["max_abs_err"]["dk"],
                                 r["max_abs_err"]["dv"]) for r in bwd_rows),
             ms=bwd_rows[1]["dkv_ms"], plain_ms=bwd_rows[1]["plain_ms"],
             bound_ms=bwd_rows[1]["dkv_bound_ms"],
             bound_by=bwd_rows[1]["dkv_bound_by"],
             f32_cores_bound_ms=bwd_rows[1]["dkv_f32_cores_bound_ms"],
             library_ms=bwd_rows[1]["library_ms"],
             timed_over=bwd_timed),
        dict(name="osel_encode", route="cuda",
             source="src/repro_torch/csrc/osel_encode.cu",
             replaces="src/repro/kernels/osel_encode/osel_encode.py:27",
             launches=launches("osel_encode"),
             launches_by_path=path_launches("osel_encode"),
             max_abs_err=max(r["max_abs_err"] for r in os_["rows"]),
             ms=ot["ms"], plain_ms=ot["plain_ms"], bound_ms=ot["bound_ms"],
             bound_by=ot["bound_by"], library_ms=ot["library_ms"],
             timed_over=f"one call at M={ot['m']}, N={ot['n']} (the "
                        "largest FLGW mask of gemma2-2b), int32 indices, "
                        "uint8 out; bound: M*N + 4(M+N) bytes at 3.35 "
                        "TB/s; library = torch.eq(ig[:, None], og[None, :])"),
    ]}

    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, torch=torch.__version__, cuda=torch.version.cuda,
        build_s=build_s, build_logs=logs, encode_rows=enc_rows,
        bmm_rows=bmm_rows, slice=sl, profile=prof, serve_params=n_params,
        fused_rows=fused_rows, flash_rows=flash_rows, serve=sv, replay=rp,
        serve_profile=sprof, bmm16_rows=bmm16_rows, flash_bwd_rows=bwd_rows,
        train=train_out, train_replay=tp, train_profile=tprof,
        osel=os_, fpga_model=fpga, learner=learner_out,
        learner_replay=lrep, learner_profile=lprof, learning_check=fig9,
        **kernels_line), indent=1, default=str))
    print(json.dumps(kernels_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
