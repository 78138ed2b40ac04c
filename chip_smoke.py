#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

The port's paths, each at full width with random weights from a seed:

* IC3Net's actor half: the registered ``ic3net`` config (hidden 128,
  8 agents) with FLGW G=4 on the grouped path, predator-prey 10x10 with
  30 steps, B=16 environments;
* serving gemma2-2b: the registered ``gemma2_2b`` config at full width
  (d 2304, vocab 256,000, bf16), its depth cut from 26 to SERVE_LAYERS
  layers, with FLGW G=4 on the grouped path for the MLP and attention
  projections and the flash-attention prefill;
* training gemma2-2b: the same config with FLGW G=4 on the grouped path
  for the MLP (the launcher's targets), slack 1.25, AdamW, remat, B=4 x
  S=1024 batches of ``SyntheticTokens(seed=0)``;
* the OSEL encoder (the sparse row memory on the mask-encode kernel) at
  the paper's Fig. 10 shapes;
* training IC3Net (the A2C learner): the actor's config and env, B=16,
  RMSprop lr 1e-3, a dense warmup of 2 iterations, 10 iterations through
  ``train``; and the Fig. 9 learning check (predator-prey 4 agents on
  4x4, 12 steps, B=16, hidden 128, G=4, 800 iterations) on the masked
  and the grouped path;
* the async actor/learner pipeline (``marl/async_train``): the actor's
  config and env, B=16, through ``async_train``;
* checkpoints and the fault-tolerant LM loop: the training config at
  full width with its depth cut to 2 layers (one local, one global
  slot; ~7.5 GB a checkpoint), AdamW, B=4 x S=1024, plans refreshed on
  a change of layout every 2 steps, through ``StepRunner``; and the
  launcher ``python -m repro_torch.launch.train --ckpt-dir`` at its
  smoke config;
* serving the rest of the dense family at full width, cut in depth
  (random bf16 weights, FLGW G=4 grouped on the MLP and attention
  projections, slack 1.25): gemma2-27b at 4 layers (2 blocks of local +
  global; its d_ff of 36,864 takes the tiled plan encode), internlm2-20b
  at 2 (q-per-kv 6, head dim 128, no softcap) and gemma3-12b at 6 (one
  5:1 period, window 1,024, S=2,048);
* paligemma-3b's prefix-LM prefill at full depth (18 layers, 256 patch
  embeddings + 768 text tokens) and gemma3-12b's banded prefill;
* the sync IC3Net launcher ``python -m repro_torch.launch.marl_ic3net``
  at the reference's defaults (4 agents on 4x4, hidden 128, B=16);
* serving the MoE family at full width, cut in depth (random bf16
  weights, FLGW G=4 grouped, slack 1.25, each expert projection one
  kernel launch for all experts): mixtral-8x22b at 4 of 56 layers (8
  experts, top-2, window 4,096; G=4 on the experts and attention) and
  arctic-480b at 1 of 35 (128 experts, top-2, and the dense residual
  MLP; G=4 on the experts, the residual and attention);
* the SSM and hybrid families and grouped MoE training at full width:
  mamba2-1.3b at 12 of its 48 layers served and trained (G=4 on its in
  and out projections), jamba-1.5-large cut to slots 0-1 of its 8-slot
  period served (G=4 on its SSM, MoE, MLP and attention projections),
  mixtral-8x22b at 1 layer trained on the grouped path (the backward
  over the expert axis);
* whisper-large-v3 (the audio encoder-decoder) at full width and depth:
  32 encoder layers over 1,500 stub frame embeddings, 32 decoder layers
  with cross-attention, 1.53 B params, served and trained (G=4 on mlp and
  attn, the cross projections too);
* the IC3Net learner on an ``("env", "agent")`` process mesh: the
  actor's config and env, B=16, one process a shard (1, 2 or 4 processes
  on the card);
* gemma2-2b trained on a ``(data, model)`` process mesh (FSDP over data,
  the reference's TP layout over model): the training config at full
  width, its depth cut to 2 layers, B=4 x S=1024, through ``train_lm``
  on 1, 2 or 4 processes on the card.

The script

  1. builds the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
     per source, in parallel) and prints each kernel's registers and
     spills from ptxas;
  2. holds every kernel against its plain PyTorch version on the card at
     the shapes the path gives it (plan ids bitwise, grouped_bmm within
     rtol = atol = 1e-5) and times kernel, plain version and, where one
     PyTorch call computes the same function, that call (grouped_bmm_f32
     and torch.bmm also by the profiler's device us a call and by the
     host us a call takes to return): ``plan_assign`` at every IC3Net
     side, with its bound by bytes and ``torch.sort`` of the same number
     of keys as a yardstick for its sort step; ``plan_rank`` and
     ``plan_place`` at a side past the sort route's limit, where they
     run; and one whole encode's wall ms and device kernels at the
     IC3Net and gemma2-2b training widths;
  3. encodes the plans on the card and compares them bitwise with a CPU
     encode, then, with every launch count at 0, drives encode + one
     B=16 rollout and checks that each kernel was launched; replays the
     rollout's actions and gates on the CPU through the plain path
     (rewards, observations and success exact; logp, value, entropy and
     gate_logp within 1e-4); times rollouts (env-steps/s); and profiles
     one encode + rollout (device busy share, kernel device times);
  4. holds ``fused_bmm`` against its plain version at each FLGW projection
     shape of gemma2-2b for 4 and 4096 rows (bf16; one f32 case),
     ``plan_assign`` at every FLGW side of the served model (SERVE_LAYERS
     / 2 stacked layers a slot) and at the MLP's sides with 26 layers in
     a launch, and
     ``flash_fwd`` at the prefill's shapes, timing each against its plain
     version and a PyTorch call (with their TFLOP/s, share of the bound
     and route: wgmma or mma.sync on the tensor cores, or FP32 FMA; the
     4-row ``fused_bmm`` calls also over a ring of weight copies larger
     than L2); then, with every launch count at 0,
     builds a ``certify`` ServeSession, runs a B=4 x S=1024 prefill, one
     lockstep Engine run (4 requests, prompt 64, gen 32) and one
     continuous run (16 synthetic requests), and checks the path's
     launches exactly (28 ``plan_assign`` an encode, 7 ``fused_bmm`` a
     layer and forward, one ``flash_fwd`` a layer and prefill); replays a
     4-layer cut of the same weights on the CPU
     (prefill B=1 x S=256 and 8 greedy decode steps from the card's KV
     cache); and profiles one prefill plus 8 decode steps, checking that
     ``flash_fwd`` ran on the tensor cores and never on FP32 FMA, and
     ``fused_bmm`` on wgmma in the prefill and on the streaming kernel in
     decode, never on the wmma kernel;
  5. holds ``grouped_bmm_bf16`` against its plain version at the
     training MLP's product shapes (its TMA + wgmma route; the wmma
     kernel there too, on its route) and at a ragged case on each route,
     and ``flash_bwd_dq``/``flash_bwd_dkv`` at the attention's (bf16,
     S=1024 with windows 4096 and 0, S=512 with window 128), timing each
     against its plain version and a PyTorch call; then, with every
     launch count at 0 before each, trains 3 steps through ``train_lm``
     (the chunked attention core) and 3 through ``make_train_step`` with
     ``use_flash`` from the same init and batches, checks which kernels
     each phase launched (``grouped_bmm_bf16`` exactly 6 a layer and
     step) and that the two agree; replays one step of 2 layers of the
     trained weights on the CPU (B=1 x S=128); and profiles one flash
     training step, checking the same of ``flash_fwd``, ``flash_bwd_dq``
     and ``flash_bwd_dkv``, and that ``grouped_bmm_bf16`` ran on the TMA
     + wgmma kernel only;
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
     then starts the Fig. 9 learning check on the masked and the grouped
     path, each run in a spawned process of its own that goes on through
     phases 8 and 9 (host-bound, the card ~5 % busy), and checks them
     against bands around the JAX package's success rates once phase 8
     is joined;
  8. in a spawned process of its own, started with the Fig. 9 runs and
     joined after phase 9 (it is host-bound too; its numbers are taken
     beside phase 9's and those runs' work), with every launch count at
     0 before each run, drives the async
     pipeline: depth 1 without correction for 3 updates against 3
     iterations of ``train`` from the same seed (each loss within 1e-5,
     every parameter within 1e-4 relative norm); V-trace with 2 windows
     an update, depth 4, publication every 2 updates, staleness at most
     4, 20 updates (``grouped_bmm_f32`` exactly 150 a window and a
     replay, ``plan_assign`` 10 an encode and at least 21 encodes, no
     other kernel); one actor rollout against a published bundle (no
     ``plan_assign``, 150 ``grouped_bmm_f32``); the same run with the
     actor on its own thread and CUDA stream (the staleness bound, the
     thread joined); and one V-trace update of the card's window replayed
     on the CPU (loss within 1e-5, each gradient within 1e-4 relative
     norm, the gate head's exactly 0 on both); prints both drivers'
     updates/s and env-steps/s beside the card's name and power limit;
  9. with every launch count at 0 before each run, drives the
     checkpointed LM loop in a fresh temporary directory (which must
     hold two checkpoints; removed after): (a) steps 1-4 uninterrupted,
     its step-4 state hashed in memory; (b) the same init, a real
     SIGTERM inside step 3, the runner saving step 3 and stopping; (c) a
     fresh state from another seed restored through ``restore_state``
     (``plan_assign`` exactly one encode's 12 sides) and stepped to 4,
     saving step 4 (``grouped_bmm_bf16`` 6 a layer and step throughout);
     checks that (a)'s state and (c)'s step-4 checkpoint agree leaf for
     leaf, hash for hash (bitwise resume), times (c)'s step-4 save, the
     restore and the hashing, checks that a corrupted leaf raises
     ``IOError`` and leaves the target's hashes as they were, runs the
     launcher as a process, SIGTERM once it logs step 2 (it must save
     step 3 and exit 0) and again (it must print ``steps 3->6``), and
     checks that the SIGTERM handler is the one before the phase; prints
     checkpoint bytes, save and restore s and GB/s beside the card's
     name and power limit;
  10. for gemma2-27b, internlm2-20b and gemma3-12b in turn: holds
      ``plan_assign`` bitwise at every FLGW side on the sort route and
      ``plan_rank``/``plan_place`` at every side past it (gemma2-27b's
      d_ff sides), ``fused_bmm`` at one block's 7 projections for 4 and
      B*S rows, ``flash_fwd`` at the prefill's shapes (each window),
      timing one side or call of each shape against its plain version
      and, where one computes the same function, a PyTorch call; then,
      with every launch count at 0, a certify ServeSession, a B=4
      prefill with ``use_flash`` and a lockstep Engine run (4 requests,
      prompt 64, gen 32), checking the launches (``plan_rank`` and
      ``plan_place`` exactly one a side past the sort limit and encode,
      on gemma2-27b only); a CPU replay of a cut with a local and a
      global slot (B=1 x S=128, 4 greedy steps); and a profile of one
      prefill and 8 decode steps (``flash_fwd`` on wgmma only,
      ``fused_bmm`` on wgmma and the streaming kernel only);
  11. paligemma-3b at full depth: ``plan_assign`` bitwise at its L = 18
      sides (the d_ff sides at 16,384 items), ``fused_bmm`` at 4 and
      4096 rows; with the counts at 0, a certify session and a B=4
      prefill of 256 patches + 768 tokens (no ``flash_fwd``: a prefix
      takes the chunked core); a CPU replay of a 2-layer cut (the prefix
      mask); then gemma3-12b's chunked prefill at S=2,048, q_chunk 512,
      banded and not, each with the counts at 0: hidden states and last
      logits within the bf16 gate;
  12. the sync launcher: ``plan_assign`` bitwise and ``grouped_bmm_f32``
      timed at its shapes; its ``main`` in this process with the counts
      at 0 (the launches checked); the same command as a process on the
      card (exit 0, its success, throughput and sparsity lines, each
      layer's learned sparsity within 10 points of 75 %), and ``--mesh
      2,2`` in one process (a non-zero exit, "needs 4 devices");
  13. for mixtral-8x22b and arctic-480b in turn: ``plan_assign`` bitwise
      at every FLGW side (the experts' sides at L = layers x experts);
      ``fused_bmm`` at one MoE layer's batched expert shapes (E·G tiles
      in one launch) for a dropless prefill's rows (B·S·top-k) and a
      decode step's 8, and for mixtral ``grouped_bmm_bf16`` at the same
      prefill shapes, each against its plain version and timed against
      it and ``torch.bmm``; an oracle of the MoE layer (64 tokens) against
      plain masked products on the card (routing re-derived, each
      expert's mask from its balanced groups); ``flash_fwd`` at the
      prefill's shapes; then, with every launch count at 0, a certify
      session, the prefill (mixtral B=4 x S=1,024, arctic B=1 x S=512)
      and a lockstep Engine run (4 requests, prompt 64, gen 32), checking
      ``plan_assign`` exactly 2 a projection and encode (14 mixtral, 20
      arctic) and ``fused_bmm`` exactly one a projection, layer and
      forward (7 and 10); for mixtral also an ``off``-policy prefill
      (``grouped_bmm_bf16`` exactly 7 a layer, no ``fused_bmm``, logits
      within the bf16 gate of the certify prefill's), a CPU replay of a
      1-layer cut (B=1 x S=64, 4 greedy steps) and a profile of one
      prefill and 8 decode steps (``fused_bmm`` on wgmma and the
      streaming kernel only, ``flash_fwd`` on wgmma only);
  14. mamba2-1.3b at full width, its depth cut to 12 of 48 layers (G=4
      on its in and out projections): ``plan_assign`` bitwise at every side,
      ``fused_bmm`` at a layer's two projections for 4,096 and 4 rows,
      ``grouped_bmm_bf16`` at their training products, each timed; with
      the counts at 0, a certify session, a B=4 x S=1,024 prefill, a
      lockstep and a continuous Engine run (``plan_assign`` exactly 4 an
      encode, ``fused_bmm`` exactly 2 a layer and forward, no flash), a
      2-layer CPU replay (every greedy token equal), the SSD scan timed
      and its share of a profiled prefill's device time; 3 training steps
      through ``train_lm`` (B=4 x S=1,024, ``grouped_bmm_bf16`` exactly 4
      a layer and step). jamba-1.5-large cut to slots 0-1 of its period
      (attention + MLP, SSM + MoE; G=4 on all four targets):
      ``plan_assign`` bitwise at its 17 sort-route sides and
      ``plan_rank``/``plan_place`` at its 7 wide sides, ``fused_bmm`` at
      its 12 projections (the experts' dropless 4,096 rows) and
      ``flash_fwd`` at the prefill's shapes; with the counts at 0, a
      certify session, a B=2 x S=1,024 prefill and a lockstep run
      (exactly 17 ``plan_assign`` and 7 each ``plan_rank`` and
      ``plan_place`` an encode, 12 ``fused_bmm`` a forward, 1
      ``flash_fwd`` a prefill); each of its 2 layers on 64 tokens against
      plain masked products on the card. mixtral-8x22b at 1 layer,
      G=4 on the experts: ``grouped_bmm_bf16`` at the training dispatch's
      shapes; 3 grouped training steps (B=2 x S=1,024; exactly 6
      ``plan_assign`` an encode and 6 ``grouped_bmm_bf16`` a step); the
      expert-axis backward against the 2-D backward expert by expert;
  15. whisper-large-v3 at full width and depth (G=4 on mlp and attn,
      ``use_flash``): ``plan_assign`` bitwise at its 32 sides,
      ``fused_bmm`` at one encoder block's 6 and one decoder block's 10
      projections for 6,000 (B x frames), 1,792 (B x S) and 4 rows and
      ``grouped_bmm_bf16`` at the same products above 64 rows,
      ``flash_fwd``/``flash_bwd_dq``/``flash_bwd_dkv`` at B=4,
      Hq=Hkv=20, D=64, S=448, each timed; with the counts at 0, a
      certify session, a B=4 x S=448 prefill with 1,500 frames, a decode
      conditioned on the audio (the first step through
      ``lm_apply(frames=..., cache=...)``, then 16 through
      ``session.decode``) and a lockstep Engine run (4 requests, prompt
      16, gen 16), each sub-path's launches exact; a 2 + 2-layer CPU
      replay (B=1, S=64, every greedy token equal); a profile of a
      prefill and of 8 decode steps (the encoder's and the cross
      attention cores, the cross k/v projections and ``fused_bmm`` as
      shares of device time; ``fused_bmm`` on wgmma and the streaming
      kernel in every decode step, never wmma); 3 training steps through
      ``make_train_step`` with a frames batch (B=4 x S=448, launches
      exact);
  16. the IC3Net learner on an ``("env", "agent")`` process mesh, the
      actor's config and env, B=16, 5 iterations (a plan refresh at the
      top of each): with every launch count at 0, ``mesh=(1, 1)`` on a
      world-1 NCCL group in this process, bitwise the run without a mesh
      (parameters and history), ``plan_assign`` 2 x 5 layers x 6 encodes
      and ``grouped_bmm_f32`` 5 x 5 layers x 30 steps, the gradient and
      metric all-reduces on NCCL; then for (2, 1), (1, 2) and (2, 2) as
      many spawned ranks on this card on gloo, the 8 ranks at once (NCCL
      refuses two ranks on one card), each rank's launches exact on
      (16/env)·(8/agent) rows a
      ``grouped_bmm_f32`` call, its rollout tensors (16/env, 30,
      8/agent), every rank's parameters bitwise rank 0's and within 1e-5
      of the one-process run (losses within 1e-4); the compressed
      all-reduce at ratio 1/G of two ranks' gradient trees as CUDA
      tensors against a host reference; prints ms an iteration and
      env-steps/s of each shape beside the card's name and power limit;
  17. trains gemma2-2b's training config (depth cut to 2 layers) 2 steps
      through ``train_lm`` on ``(data, model)`` meshes: without a group
      in this process (the reference), on a world-1 NCCL group in a
      spawned process (bitwise the reference: losses, grad norms, final
      params; launches equal), then (2, 1), (1, 2) and (2, 2) as spawned
      gloo ranks sharing the card, in two waves ((a) beside (2, 2),
      then (2, 1) beside (1, 2)): each rank's losses and grad norms
      within 1e-2 of the reference and its step-2 loss change within
      5e-2; the params (each rank's shards against the reference's
      matching slices) within 5e-2, and what the 2 steps changed in them
      within relative L2 0.3 of the reference's change, a limit that a
      no-update and a neighbour's-slices control must fail; its state
      bytes the whole state's over its ranks (1 %), its launches the
      world-1 rank's; (2, 2) saves its final
      state once and (2, 1) restores it with ``shardings=``, each
      rank's shards the saved arrays' slices bitwise; prints ms a step,
      each rank's peak GB and the collectives by operation and backend;
  18. holds the analysis layer against the card: (a) the launch audit
      (``repro_torch.analysis.kernel_audit``): every profile the phases
      take records each kernel call's arguments, and each recorded launch
      of a port kernel in the exported trace must be the audit's
      prediction for those calls (kernel, grid, block, static + dynamic
      shared memory); it prints the (entry, shape) pairs matched and the
      launches without a record, and fails on any mismatch or on an
      entry launched inside a profile with no match; (b) the dry run
      (``repro_torch.launch.dryrun``) of phase 17's config on ``meta``
      over fake groups of (2, 1), (1, 2) and (2, 2), in a CPU process
      started after phase 12: each phase 17 rank's all-gathers,
      reduce-scatters and all-reduces and their bytes equal the
      prediction for 2 steps, its state bytes the predicted; the
      one-process step's time against the dry run's roofline bound;
      (c) the runtime contracts: a lockstep serve run (gemma2-2b at 2
      layers) with ``debug_contracts=True`` at one decode signature, a
      decode loop of batch 1 then 2 raising ``RetraceError``, and phase
      8's threaded async run under ``debug_contracts=True``;
  19. prints each phase's wall seconds as it ends, then one
      ``{"kernels": [...]}`` line, the card's name and power limit, and
      as the last line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
result line. Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import io
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

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
from repro_torch.marl import async_train  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import encoder as planenc  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serving import (Engine, Request, ServeSession,  # noqa: E402
                                 max_seq_for, plan_cache, synthetic_requests)
from repro_torch.data.pipeline import SyntheticTokens  # noqa: E402
from repro_torch.launch import time_encode  # noqa: E402
from repro_torch.launch.train import train_lm  # noqa: E402
from repro_torch.optim.optimizers import global_norm, rmsprop_init  # noqa
from repro_torch.train import state as state_lib  # noqa: E402
from repro_torch.train import step as step_lib  # noqa: E402
from repro_torch.core import flgw, osel  # noqa: E402
from repro_torch.core.schedule import SparsitySchedule  # noqa: E402
from repro_torch.kernels.osel_encode import ops as os_ops  # noqa: E402
from repro_torch.kernels.osel_encode import ref as os_ref  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.data.pipeline import make_batch_iterator  # noqa: E402
from repro_torch.models.config import param_count  # noqa: E402
from repro_torch.runtime import StepRunner  # noqa: E402
from repro_torch.launch import marl_ic3net  # noqa: E402
from repro_torch.models.layers import softcap, unembed  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402

# the card's numbers and the bound live in launch/roofline.py
HBM_BYTES_PER_S = roofline.HBM_BW
F32_OPS_PER_S = roofline.F32_FLOPS
BF16_OPS_PER_S = roofline.PEAK_FLOPS
bound_ms = roofline.bound_ms
BATCH = 16
SEED = 0
ENV = dict(n_agents=8, size=10, vision=1, max_steps=30)
BMM_TOL = 1e-5
REPLAY_TOL = 1e-4
OUT = ROOT / "chiprun_out"


def port_kernels() -> tuple:
    """Every kernel wrapper with a launch count, in the kernels line's
    order."""
    return (pe_ops.ASSIGN, pe_ops.RANK, pe_ops.PLACE, fm_ops.BMM,
            fm_ops.BMM16, fm_ops.FUSED, fa_ops.FWD, fa_ops.DQ, fa_ops.DKV,
            os_ops.OSEL)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


_WALL: dict = {}     # function -> [calls, inclusive wall s], this process


def _timed(fn):
    """Counts ``fn``'s calls and inclusive wall seconds in _WALL (where a
    phase's time goes: the script prints them at its end)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            c = _WALL.setdefault(fn.__name__, [0, 0.0])
            c[0] += 1
            c[1] += time.perf_counter() - t0
    return wrapper


@_timed
def time_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean ms per call of ``fn`` over back-to-back calls, by CUDA events
    (host enqueue included when it is slower than the device). The script
    takes ~1,000 such timings, so each is 100 calls, not more."""
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


@_timed
def host_us(fn, iters: int = 2000, warmup: int = 50) -> float:
    """Mean host us per call of ``fn``: the time for the call to return,
    without waiting for the device (the device keeps up when its time a
    call is shorter)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


@_timed
def device_us(fn, calls: int = 20) -> float:
    """Device us per call of ``fn``: for each kernel or memset that
    ``calls`` calls ran, the profiler's mean time an event times its
    events a call. Means, not the sum over ``calls``: the profiler can
    miss events in a run of short calls (section 7 of PERF.md)."""
    fn()
    top = profile(lambda: [fn() for _ in range(calls)], {})["top"]
    return sum(t["device_us"] / t["count"]
               * max(1, round(t["count"] / calls)) for t in top)


def _kernel_name(mangled: str) -> str:
    """A kernel's name from its mangled symbol, with its template
    arguments: ``flash_fwd_wgmma_kernel<256>``, ``flash_fwd_kernel<bf16>``,
    ``plan_assign_kernel<128, 4>``."""
    i, name = (3 if mangled.startswith("_ZN") else 2), mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    ints = re.match(r"I((?:Li\d+E)+)E", mangled[i:])
    if ints:
        return f"{name}<{', '.join(re.findall(r'Li(\d+)E', ints[1]))}>"
    arg = re.match(r"I(.+?)E", mangled[i:])
    if arg is None:
        return name
    arg = arg.group(1)
    arg = {"f": "float"}.get(arg, "bf16" if arg.endswith("bfloat16")
                             else arg.removeprefix("Li"))
    return f"{name}<{arg}>"


def ptxas_usage(log: str) -> dict:
    """``{kernel: {registers, static_smem_bytes, spill_stores,
    spill_loads}}`` from the ``nvcc -Xptxas -v`` report of one library
    (kernels named by :func:`_kernel_name`)."""
    usage, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = _kernel_name(line.split("'")[1])
            usage[name] = {}
        elif name and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            usage[name].update(spill_stores=nums[1], spill_loads=nums[2])
        elif name and "Used" in line:
            usage[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            usage[name]["static_smem_bytes"] = int(smem[1]) if smem else 0
    return usage


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# A side past the sort route's limits, where plan_rank and plan_place run:
# gemma2-27b's d_ff (ROADMAP Queue 1, item 4), one layer, G = 4.
TILED_SIDE = (1, 36864, 4)
# gemma2-2b's MLP sides with the two slots' 13 layers in one launch (L = 26),
# beside the SERVE_LAYERS / 2 stacked layers a slot the serve phase holds.
LM26_SIDES = ((26, 2304, 1), (26, 9216, 0), (26, 9216, 1), (26, 2304, 0))
ASSIGN_KERNEL = {"plan_assign": "plan_assign_kernel"}
# plan_assign's tiers (threads, items a thread; csrc/plan_encode.cu's
# by_tier)
ASSIGN_TIERS = ("128, 1", "128, 4", "256, 8", "512, 8", "512, 20",
                "1024, 16")


def flgw_sides(params):
    """``(name, scores, axis)`` of every FLGW grouping side of a tree."""
    for path, p in grouped.iter_flgw_layers(params):
        name = "/".join(path)
        yield f"{name}.ig", p["ig"].detach(), 1
        yield f"{name}.og", p["og"].detach(), 0


def time_assign(scores, axis: int, slack: float) -> dict:
    """plan_assign at one side: ms by events over back-to-back calls, the
    profiler's device us a launch (and how many of 20 launches it
    recorded), the plain version's ms, the bound by bytes (scores read
    once, ids and group written once) and ``torch.sort(stable=True)`` of
    an (L, M) int64 key, a yardstick for the sort step alone."""
    m, g = scores.shape[-2:] if axis else scores.shape[-2:][::-1]
    l = scores.numel() // (m * g)
    cap = compute_cap(m, g, slack)
    bnd, by = bound_ms(4 * l * m * g + 8 * l * g * cap + 8 * l * m, 0)
    calls = 20
    ours = profile(lambda: [pe_ops.assign(scores, axis, slack)
                            for _ in range(calls)],
                   ASSIGN_KERNEL)["kernels"]["plan_assign"]
    key = torch.randint(0, 2 ** 40, (l, m), device=scores.device)
    dev_us = ours["device_us_mean"]
    return dict(
        ms=time_ms(lambda: pe_ops.assign(scores, axis, slack)),
        device_us=dev_us, profiler_recorded_launches=ours["launches"],
        profiler_calls=calls,
        plain_ms=time_ms(lambda: pe_ref.ref_assign(scores, axis, slack),
                         20, 3),
        bound_ms=bnd, bound_by=by,
        bound_share=None if dev_us is None else bnd / (dev_us / 1e3),
        sort_yardstick_ms=time_ms(
            lambda: torch.sort(key, dim=-1, stable=True)))


def check_assign_one(what: str, scores, axis: int, slack: float) -> dict:
    """plan_assign at one side against its plain version (ids and groups)
    and, layer by layer, against the sort oracle; bitwise."""
    m, g = scores.shape[-2:] if axis else scores.shape[-2:][::-1]
    l = scores.numel() // (m * g)
    cap = compute_cap(m, g, slack)
    check(pe_ops.assign_route(m, g) == "sort",
          f"{what}: {m} items in {g} groups take the sort route")
    before = (pe_ops.ASSIGN.launches, pe_ops.RANK.launches,
              pe_ops.PLACE.launches)
    ids, group = pe_ops.assign(scores, axis, slack)
    check((pe_ops.ASSIGN.launches, pe_ops.RANK.launches,
           pe_ops.PLACE.launches) == (before[0] + 1, *before[1:]),
          f"{what}: one plan_assign launch, no plan_rank or plan_place")
    ids, group = ids.reshape(l, g * cap), group.reshape(l, m)
    want_ids, want_group = pe_ref.ref_assign(scores, axis, slack)
    err = max(int((ids - want_ids).abs().max()),
              int((group - want_group).abs().max()))
    check(err == 0, f"plan_assign == plain at {what} (max abs err {err})")
    rows = (scores if axis else scores.transpose(-1, -2)).reshape(l, m, g)
    check(all(torch.equal(ids[i].reshape(g, cap),
                          pe_ref.ref_balanced_assign(rows[i], slack))
              for i in range(l)),
          f"plan_assign == sort oracle at {what}")
    return dict(side=what, layers=l, items=m, groups=g, axis=axis, cap=cap,
                max_abs_err=err)


@_timed
def check_assign_kernel(sides, slack: float) -> list[dict]:
    """plan_assign checked and timed at every side of ``sides``
    (``(name, scores, axis)``)."""
    return [{**check_assign_one(name, scores, axis, slack),
             **time_assign(scores, axis, slack)}
            for name, scores, axis in sides]


def check_tiled_route(slack: float, device) -> dict:
    """The tiled route at TILED_SIDE, a synthetic side past the sort
    route's limit (see :func:`check_tiled`)."""
    scores = torch.randn(TILED_SIDE, device=device,
                         generator=torch.Generator(device=device)
                         .manual_seed(SEED + 5))
    return check_tiled(f"L, M, G = {TILED_SIDE}", scores, 1, slack)


def check_tiled(what: str, scores, axis: int, slack: float,
                timed: bool = True) -> dict:
    """plan_rank and plan_place against their plain versions at a side
    past the sort route's limit, where ``assign`` takes them (one launch
    of each), and the whole assignment there against the sort oracle,
    layer by layer; with ``timed``, each kernel timed, with its bound by
    bytes (pref, strength and rank read once, rank, histograms and slots
    written once)."""
    m, g = scores.shape[-2:] if axis else scores.shape[-2:][::-1]
    l = scores.numel() // (m * g)
    check(pe_ops.assign_route(m, g) == "tiled",
          f"{what}: {m} items in {g} groups take the tiled route")
    cap = compute_cap(m, g, slack)
    pref, strength, bi = pe_ops.preferences(scores, axis)
    rk, hist = pe_ops.rank(pref, strength, g, bi)
    rk_ref, hist_ref = pe_ref.ref_rank(pref, strength, g, bi)
    rank_err = max(int((rk - rk_ref).abs().max()),
                   int((hist - hist_ref).abs().max()))
    check(rank_err == 0, f"plan_rank == plain at {what}")
    slot = pe_ops.place(pref, rk, hist, g, cap)
    place_err = int((slot - pe_ref.ref_place(pref, rk_ref, hist_ref, g, cap)
                     ).abs().max())
    check(place_err == 0, f"plan_place == plain at {what}")
    before = (pe_ops.ASSIGN.launches, pe_ops.RANK.launches,
              pe_ops.PLACE.launches)
    ids = pe_ops.balanced_assign(scores, axis, slack)
    check((pe_ops.ASSIGN.launches, pe_ops.RANK.launches,
           pe_ops.PLACE.launches) == (before[0], before[1] + 1,
                                      before[2] + 1),
          f"{what}: assign runs plan_rank and plan_place once each")
    rows = (scores if axis else scores.transpose(-1, -2)).reshape(l, m, g)
    check(all(torch.equal(ids.reshape(l, g, cap)[i],
                          pe_ref.ref_balanced_assign(rows[i], slack))
              for i in range(l)),
          f"balanced_assign == sort oracle at {what}")
    mp = pref.shape[1]
    out = dict(side=what, layers=l, items=m, groups=g, axis=axis, mp=mp,
               tile=bi, cap=cap, max_abs_err=max(rank_err, place_err))
    if not timed:
        return out
    n_it = mp // bi
    calls = 10
    prof = profile(lambda: [pe_ops.place(pref, *pe_ops.rank(
        pref, strength, g, bi), g, cap) for _ in range(calls)],
        {"plan_rank": "rank_kernel", "plan_place": "place_kernel"})
    for name, err, fn, plain, nbytes in (
            ("rank", rank_err, lambda: pe_ops.rank(pref, strength, g, bi),
             lambda: pe_ref.ref_rank(pref, strength, g, bi),
             4 * (3 * l * mp + l * n_it * g)),
            ("place", place_err,
             lambda: pe_ops.place(pref, rk, hist, g, cap),
             lambda: pe_ref.ref_place(pref, rk, hist, g, cap),
             4 * (3 * l * mp + l * n_it * g))):
        bnd, by = bound_ms(nbytes, 0)
        k = prof["kernels"][f"plan_{name}"]
        out[name] = dict(max_abs_err=err, ms=time_ms(fn, 20, 3),
                         plain_ms=time_ms(plain, 10, 2), bound_ms=bnd,
                         bound_by=by, device_us=k["device_us_mean"],
                         profiler_recorded_launches=k["launches"],
                         profiler_calls=calls)
    return out


@_timed
def check_bmm_kernel(model, plans, rows_b: int) -> list[dict]:
    """grouped_bmm against its plain version on the compact operands of
    every FLGW layer, with B*A activation rows."""
    gen = torch.Generator(device=model.device).manual_seed(SEED + 1)
    rows = []
    for path, p in grouped.iter_flgw_layers(model.params):
        plan = plans.plans[path[-1]]
        x = torch.randn((rows_b, p["w"].shape[0]), generator=gen,
                        device=model.device)
        xg = fm_ops.gather_x(x, plan.row_ids, plan.row_valid)
        wc = fm_ops.compact_weights(p["w"].detach(), plan.row_ids,
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
            cols=fm_ops.bmm_f32_cols(g, b, n, fm_ops._sm_count(
                xg.device.index)),
            ms=time_ms(lambda: fm_ops.grouped_bmm(xg, wc)),
            plain_ms=time_ms(lambda: fm_ref.ref_grouped_bmm(xg, wc)),
            library_ms=time_ms(lambda: torch.bmm(xg, wc)),
            device_us=device_us(lambda: fm_ops.grouped_bmm(xg, wc), 50),
            library_device_us=device_us(lambda: torch.bmm(xg, wc), 50),
            host_us=host_us(lambda: fm_ops.grouped_bmm(xg, wc)),
            library_host_us=host_us(lambda: torch.bmm(xg, wc)),
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
    _zero(kernels)
    t0 = time.perf_counter()
    with torch.inference_mode():
        plans = model.encode_plans()
    gen = train.make_generator(SEED, model.device)
    r = train.rollout(model, env, ecfg, gen, BATCH, plans, collect=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in kernels}
    for name in ("plan_assign", "grouped_bmm_f32"):
        check(launches[name] > 0, f"{name} launched on the IC3Net path")
    check_sort_route(launches, "the IC3Net path")

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


def check_sort_route(launches: dict, what: str, tiled: int = 0) -> None:
    """Every side of the path took the sort route but the ``tiled`` side
    encodes past its limit (gemma2-27b's d_ff sides, jamba-1.5-large's
    wide sides): exactly that many plan_rank and plan_place launches,
    none on any other path."""
    for name in ("plan_rank", "plan_place"):
        check(launches[name] == tiled,
              f"{name} launched {tiled} times on {what} ({launches[name]})")


@_timed
def profile(fn, names, spans=()) -> dict:
    """torch.profiler over one call of ``fn``: how many kernels the device
    ran, how much of the wall time it was busy, and each port kernel's
    device time (``names``: launch-count symbol -> a substring of its
    CUDA kernel's name); for each of ``spans`` (``record_function``
    names that ``fn`` opens) the device time of the kernels launched
    inside it and its share of the busy time. The profiler's own cost
    inflates the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from repro_torch.kernels import KernelEntry
    torch.cuda.synchronize()
    KernelEntry.RECORD = []          # the launch audit's calls (phase 18)
    try:
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        recorded, KernelEntry.RECORD = KernelEntry.RECORD, None
    _audit_profile(recorded, prof)
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and e.name not in spans]
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
    span_us = {}
    for e in prof.events():
        if e.name in spans and e.device_type == DeviceType.CPU:
            n, us = span_us.get(e.name, (0, 0.0))
            span_us[e.name] = (n + 1, us + e.device_time_total)
    return dict(
        wall_us=wall_us, device_events=len(evs), device_busy_us=busy_us,
        device_busy_share=busy_us / wall_us if evs else None, kernels=ours,
        top=[dict(name=n[:100], count=len(v), device_us=sum(v))
             for n, v in top],
        spans={name: dict(count=n, device_us=us,
                          share=us / busy_us if busy_us else None)
               for name, (n, us) in span_us.items()})


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
# the serve phase's depth, cut from gemma2-2b's 26 layers (a multiple of
# its 2-slot period, full width) to keep the script inside its time limit
SERVE_LAYERS = 4
# a gemma2-2b layer's compact projections: q, k, v, o, up, gate, down
SERVE_PROJECTIONS = 7
PROMPT, GEN = 64, 32          # examples/serve.py defaults
PREFILL_SEQ = 1024
FUSED_BF16_TOL = dict(rtol=1e-2, atol=1e-3)   # f32 sums, one bf16 rounding
FUSED_F32_TOL = dict(rtol=1e-5, atol=1e-5)
FLASH_BF16_TOL = dict(rtol=1e-2, atol=1e-2)   # |out| < 4, one bf16 rounding
LSE_TOL = dict(rtol=1e-5, atol=1e-4)
# what computes each flash kernel's products at the path's shapes (bf16,
# D = 256): the tensor cores by wgmma or mma.sync, or FP32 FMA
FLASH_ROUTES = {"flash_fwd": "wgmma", "flash_bwd_dq": "mma.sync",
                "flash_bwd_dkv": "mma.sync"}
# what computes fused_bmm at the path's shapes (bf16): wgmma for a
# prefill's rows, FP32 FMA streaming wc for a decode step's few rows
FUSED_ROUTES = {"prefill": "wgmma", "decode": "streaming fp32 fma"}
L2_BYTES = 50e6               # H100 SXM L2
# card vs CPU, both bf16 with f32 sums: 4 layers of activations rounded to
# bf16 at the same places but from sums taken in other orders
REPLAY_BF16_TOL = dict(rtol=5e-2, atol=5e-2)
SERVE_KERNELS = {"plan_assign": "plan_assign_kernel",
                 "plan_rank": "rank_kernel", "plan_place": "place_kernel",
                 "grouped_bmm_f32": "grouped_bmm_f32_kernel",
                 "fused_bmm on wgmma": "fused_bmm_wgmma_kernel",
                 "fused_bmm streaming": "fused_bmm_stream_kernel",
                 "fused_bmm on wmma": "fused_bmm_bf16_kernel",
                 "fused_bmm split-K sum": "reduce_splits_kernel",
                 "flash_fwd": "flash_fwd",
                 "flash_fwd on FP32 FMA": "flash_fwd_kernel"}


def check_flash_routes(prof: dict, what: str, names) -> None:
    """The bf16 path's flash kernels ran on the tensor cores: the profile
    saw launches of each and none of its FP32 FMA kernel (the route the C
    entry takes for shapes the tensor-core kernels do not take)."""
    for name in names:
        ours = prof["kernels"]
        check(ours[name]["launches"] > 0
              and ours[f"{name} on FP32 FMA"]["launches"] == 0,
              f"{what}: {name} ran on the tensor cores only "
              f"({ours[name]['launches']} launches, "
              f"{ours[f'{name} on FP32 FMA']['launches']} on FP32 FMA)")


def check_fused_routes(prof: dict) -> None:
    """The serve profile's fused products ran on the new routes: wgmma in
    the prefill, the streaming kernel in decode, and never the wmma
    kernel that shapes outside both take."""
    ours = prof["kernels"]
    n = {k: ours[f"fused_bmm {k}"]["launches"]
         for k in ("on wgmma", "streaming", "on wmma")}
    check(n["on wgmma"] > 0 and n["streaming"] > 0 and n["on wmma"] == 0,
          f"the serve profile: fused_bmm on wgmma (prefill) and streaming "
          f"(decode) only ({n})")


def check_bmm_routes(prof: dict) -> None:
    """The flash-train profile's grouped products ran on the TMA + wgmma
    kernel only, never on the wmma kernel that other shapes take."""
    ours = prof["kernels"]
    n = {k: ours[k]["launches"]
         for k in ("grouped_bmm_bf16", "grouped_bmm_bf16 on wmma")}
    check(n["grouped_bmm_bf16"] > 0 and n["grouped_bmm_bf16 on wmma"] == 0,
          f"the flash training profile: grouped_bmm_bf16 on TMA + wgmma "
          f"only ({n})")


@_timed
def serve_params(cfg, device) -> dict:
    return transformer.lm_init(
        torch.Generator(device=device).manual_seed(SEED), cfg)


@_timed
def check_fused_kernel(params, cfg, rows_bf16=(4, 4096),
                       rows_f32: Optional[int] = 64) -> list[dict]:
    """fused_bmm against its plain version at each FLGW projection of
    block 0's first slot (the shapes every layer repeats), for a decode
    step's 4 rows and a prefill's B*S (``rows_bf16``), in bf16; one f32
    case (``rows_f32``, None for none). The 4-row
    calls are timed twice: on one wc (``ms``, which stays in L2) and over
    a ring of wc copies larger than L2 (``ms_cold``), as a decode step
    finds each layer's weights."""
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
    cases = [(r, torch.bfloat16) for r in rows_bf16] + (
        [] if rows_f32 is None else [(rows_f32, torch.float32)])
    for n_rows, dtype in cases:
        for part, name in projs:
            if dtype == torch.float32 and name != "q":
                continue
            plan = blk[part][name]
            m, n = blkp[part][name]["w"].shape
            dev = plan.wc.device
            x = torch.randn((n_rows, m), generator=gen, device=dev).to(dtype)
            xp, ids = fm_ops.fused_operands(x, plan.row_ids, plan.row_valid)
            wc = plan.wc.to(dtype).contiguous()
            y = fm_ops.fused_bmm(xp, wc, ids)
            y_ref = fm_ref.ref_fused_bmm(xp, wc, ids)
            err = float((y.float() - y_ref.float()).abs().max())
            tol = FUSED_F32_TOL if dtype == torch.float32 else FUSED_BF16_TOL
            check(torch.allclose(y.float(), y_ref.float(), **tol),
                  f"fused_bmm == plain at {name}, {n_rows} rows, {dtype} "
                  f"(max abs err {err})")
            g, k, nc = wc.shape
            xg = fm_ops.gather_x(x, plan.row_ids, plan.row_valid)
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
                bound_ms=bnd, bound_by=by, peak_ops_per_s=peak,
                route="fp32 fma" if dtype == torch.float32
                else FUSED_ROUTES["prefill" if n_rows > 64 else "decode"]))
            rows[-1]["tflops"] = ops / rows[-1]["ms"] / 1e9
            rows[-1]["bound_share"] = bnd / rows[-1]["ms"]
            if n_rows <= 64 and dtype == torch.bfloat16:
                ring = [wc.clone() for _ in range(
                    max(2, math.ceil(2 * L2_BYTES / (wc.numel() * es))))]
                turn = iter(range(1 << 30))
                rows[-1]["ms_cold"] = time_ms(lambda: fm_ops.fused_bmm(
                    xp, ring[next(turn) % len(ring)], ids), 4 * len(ring),
                    len(ring))
                rows[-1]["wc_ring_copies"] = len(ring)
                del ring
    return rows


def _attn_pairs(s: int, window: int) -> int:
    """Allowed (query, key) pairs of a causal mask with an optional
    window: the work this run's masks need."""
    return sum(min(q + 1, window) if window > 0 else q + 1 for q in range(s))


@_timed
def check_flash_kernel(cfg, device,
                       cases=((PREFILL_SEQ, 4096), (PREFILL_SEQ, 0),
                              (512, 128)),
                       batch: int = SERVE_BATCH) -> list[dict]:
    """flash_fwd against its plain version (f32 math) at the prefill's
    shapes (``cases``: (S, window) at ``cfg``'s heads, head dim and
    softcap, ``batch`` sequences), and timed against SDPA with softcap 0
    (SDPA has none)."""
    import torch.nn.functional as F
    b, hq, hkv, d = batch, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    rows = []
    for s, window in cases:
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
        flops = 4 * d * _attn_pairs(s, window) * b * hq
        nbytes = 2 * (2 * b * hq * s * d + 2 * b * hkv * s * d) + 4 * b * hq * s
        bnd, by = bound_ms(nbytes, flops, BF16_OPS_PER_S)
        kw0 = dict(kw, softcap=0.0)
        row = dict(
            b=b, hq=hq, hkv=hkv, d=d, softcap=cfg.attn_softcap,
            s=s, window=window, max_abs_err=err, lse_max_abs_err=lerr,
            ms=time_ms(lambda: fa_ops.flash_fwd(q, k, v, **kw), 20, 3),
            plain_ms=time_ms(lambda: fa_ref.ref_flash_fwd(q, k, v, **kw),
                             10, 2),
            ms_softcap0=time_ms(lambda: fa_ops.flash_fwd(q, k, v, **kw0),
                                20, 3),
            bound_ms=bnd, bound_by=by, peak_ops_per_s=BF16_OPS_PER_S,
            library_ms=None, route=FLASH_ROUTES["flash_fwd"])
        row["tflops"] = flops / row["ms"] / 1e9
        row["bound_share"] = bnd / row["ms"]
        if window == 0 or window >= s:      # SDPA's causal mask is the same
            row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), 20, 3)
            row["library"] = ("F.scaled_dot_product_attention(is_causal, "
                              "enable_gqa), against ms_softcap0")
        rows.append(row)
    return rows


@_timed
def run_serve(cfg, params, kernels, seq: int = PREFILL_SEQ,
              continuous: bool = True, tiled_sides: int = 0,
              batch: int = SERVE_BATCH,
              need=("plan_assign", "fused_bmm", "flash_fwd")) -> dict:
    """The serving path with every launch count at 0 first: a certify
    session, a B=``batch`` x S=``seq`` prefill, one lockstep and
    (``continuous``) one continuous Engine run. ``tiled_sides``: how many
    grouping sides of one encode lie past the sort route's limit (each
    then takes one plan_rank and one plan_place launch an encode); with
    none, no side may take them. ``need``: the kernels the path must
    launch (an attention-free model has no flash_fwd)."""
    plan_cache.clear()
    _zero(kernels)
    t0 = time.perf_counter()
    session = ServeSession(cfg, params, plan_policy="certify")
    torch.cuda.synchronize()
    session_s = time.perf_counter() - t0
    dev = session.device
    rng = torch.Generator(device=dev).manual_seed(SEED + 4)
    tok = torch.randint(0, cfg.vocab, (batch, seq), generator=rng,
                        device=dev)
    inputs = {"tokens": tok, "positions": torch.arange(
        seq, device=dev).expand(batch, seq)}
    prefill_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = session.prefill(inputs)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    check(logits.shape == (batch, 1, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          "prefill logits finite, (B, 1, vocab)")

    prompts = np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab, (SERVE_BATCH, PROMPT)).astype(np.int32)
    lock_reqs = [Request(rid=i, prompt=prompts[i], max_new_tokens=GEN)
                 for i in range(SERVE_BATCH)]
    lock = Engine(session, SERVE_BATCH, max_seq_for(lock_reqs),
                  admission="lockstep").run(lock_reqs)
    runs = [(lock, lock_reqs)]
    if continuous:
        cont_reqs = synthetic_requests(1, 16, vocab=cfg.vocab, p_arrive=0.5,
                                       prompt_len=(PROMPT // 2, PROMPT),
                                       gen_len=(GEN // 2, GEN))
        cont = Engine(session, SERVE_BATCH, max_seq_for(cont_reqs),
                      admission="continuous").run(cont_reqs)
        runs.append((cont, cont_reqs))
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in kernels}
    what = f"the {cfg.name} serving path"
    for name in need:
        check(launches[name] > 0, f"{name} launched on {what}")
    encodes = plan_cache.stats()["encodes"]
    check(encodes >= 1, f"{what}: at least one encode ({encodes})")
    # one plan_rank and one plan_place launch a side past the sort limit
    # and encode
    check_sort_route(launches, what, tiled_sides * encodes)
    for name in ("grouped_bmm_f32", "grouped_bmm_bf16", "flash_bwd_dq",
                 "flash_bwd_dkv", "osel_encode"):
        check(launches[name] == 0, f"{name} not launched on {what}")
    for rep, reqs in runs:
        check(rep.generated_tokens == sum(r.max_new_tokens for r in reqs)
              and all(0 <= t < cfg.vocab for r in rep.records
                      for t in r.tokens),
              f"{rep.admission}: every request completed with valid ids")
    return dict(
        launches=launches, session_s=session_s, prefill_s=prefill_s,
        prefill_ms=statistics.median(prefill_s) * 1e3,
        prefill_tokens_per_s=batch * seq / statistics.median(prefill_s),
        lockstep=lock.summary(),
        continuous=runs[1][0].summary() if continuous else None,
        encodes=encodes, plan_cache=plan_cache.stats(), session=session,
        inputs=inputs, logits=logits)


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


def _decode_steps(session, cfg, prompt, steps, cache=None, feed=None,
                  frames=None):
    """Replay ``prompt`` through the decode path (hidden states only) and
    take ``steps`` greedy steps, or the tokens ``feed`` gives. ``frames``
    go to the first prompt step (an encoder-decoder's audio: the step
    writes the encoder's output into the cache). Returns (per-step
    logits, tokens fed, the cache just before the steps)."""
    params = session.params
    dev = session.device
    run = transformer.lm_apply
    with torch.inference_mode():
        if cache is None:
            cache = session.new_cache(1, len(prompt) + steps)
            for t in range(len(prompt) - 1):
                kw = {} if t or frames is None else {"frames": frames}
                _, _, cache = run(params, cfg, torch.tensor(
                    [[int(prompt[t])]], device=dev), torch.tensor(
                    [[t]], device=dev), cache=cache, return_hidden=True,
                    **kw)
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


# each CPU replay's second half runs in a spawned process of its own,
# started when the card half ends and joined by join_replays() at the end
# of the script, so the CPU's math runs beside the phases that follow; a
# few intra-op threads each leave the main process its cores
REPLAY_THREADS = 2
REPLAY_TIMEOUT_S = 900
_REPLAYS: list = []


@_timed
def cpu_replay(cfg, params, blocks: int = 2, seq: int = 256,
               steps: int = 8, frames: Optional[torch.Tensor] = None,
               then=None) -> dict:
    """The first ``blocks`` blocks (2: 4 layers of gemma2) of the served
    weights, full width and vocab, on the card and on the CPU: the same
    B=1 x S=``seq`` prefill and ``steps`` greedy decode steps (the CPU's
    from the card's KV cache, fed the card's tokens); logits within
    REPLAY_BF16_TOL, greedy tokens equal wherever the CPU's top-2 margin
    exceeds that tolerance. An encoder-decoder keeps ``blocks`` encoder
    layers too and takes ``frames`` (1, T, d) on the card: in the
    prefill and in the first decode step, which writes the encoder's
    output into the cache the CPU continues from.

    The card half runs here; the CPU half (its own encode, prefill and
    decode, and the checks) in a spawned process (:func:`replay_cpu_half`)
    that :func:`join_replays` joins at the end of the script. The dict
    returned is filled in then, and ``then(dict)`` (the caller's checks
    and prints) called."""
    cfg4 = cfg.with_updates(n_layers=blocks * cfg.period)
    card_p = dict(params, blocks=_blocks_slice(params["blocks"], blocks))
    if cfg.encoder_layers:
        cfg4 = cfg4.with_updates(encoder_layers=blocks)
        card_p["encoder"] = _blocks_slice(params["encoder"], blocks)
    card = ServeSession(cfg4, card_p)
    prompt = np.random.default_rng(SEED + 5).integers(0, cfg.vocab, seq)
    batch = {"tokens": torch.as_tensor(prompt[None]),
             "positions": torch.arange(seq)[None]}
    if frames is not None:
        batch["frames"] = frames.cpu()
    got = card.prefill(_to(batch, card.device))[0, 0].float().cpu()
    card_lg, fed, snap = _decode_steps(card, cfg4, prompt, steps,
                                       frames=frames)
    d = tempfile.mkdtemp(prefix="repro-replay-")
    torch.save(dict(params=_to(card_p, "cpu"), batch=batch, prompt=prompt,
                    prefill=got, card_lg=card_lg, fed=fed, snap=snap,
                    frames=None if frames is None else frames.cpu(),
                    plans=_to_plans_cpu(card.plans.plans),
                    sig=int(card.plans.sig)), f"{d}/replay.pt")
    del card
    out = dict(layers=cfg4.n_layers, seq=seq, steps=steps,
               tol=REPLAY_BF16_TOL)
    _REPLAYS.append((in_process(replay_cpu_half, cfg4, d, steps,
                                threads=REPLAY_THREADS,
                                timeout_s=REPLAY_TIMEOUT_S),
                     out, then, d, time.perf_counter()))
    return out


def _to_plans_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_plans_cpu(v) for k, v in tree.items()}
    return type(tree)(*(None if t is None else t.cpu() for t in tree))


def replay_cpu_half(cfg4, d: str, steps: int) -> dict:
    """The CPU half of :func:`cpu_replay`, from the card half's file in
    ``d``: the CPU's own plans (== the card's), prefill and decode
    against the card's."""
    rec = torch.load(f"{d}/replay.pt", weights_only=False, mmap=True)
    cpu = ServeSession(cfg4, rec["params"])
    check(same_plans(rec["plans"], cpu.plans.plans)
          and rec["sig"] == int(cpu.plans.sig),
          f"plans encoded on the card == plans encoded on the CPU "
          f"({cfg4.n_layers} layers)")
    t0 = time.perf_counter()
    want = cpu.prefill(rec["batch"])[0, 0]
    cpu_prefill_s = time.perf_counter() - t0
    errs = {"prefill": float((rec["prefill"] - want).abs().max())}
    check(torch.allclose(rec["prefill"], want, **REPLAY_BF16_TOL),
          f"replay prefill logits within {REPLAY_BF16_TOL} (max abs err "
          f"{errs['prefill']})")
    card_lg, fed = rec["card_lg"], rec["fed"]
    cache = dict(rec["snap"], plans=cpu.new_cache(1, 1)["plans"])
    t0 = time.perf_counter()
    cpu_lg, _, _ = _decode_steps(cpu, cfg4, rec["prompt"], steps,
                                 cache=cache, feed=fed)
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
    return dict(max_abs_err=errs, greedy_tokens=fed,
                clear_steps=int(clear.sum()), equal_tokens=int(same.sum()),
                cpu_prefill_s=cpu_prefill_s, cpu_decode_s=cpu_decode_s)


def join_replays() -> float:
    """Wait for every CPU replay's second half, fill in its dict, call
    its ``then``; returns the seconds this waited."""
    t0 = time.perf_counter()
    while _REPLAYS:
        job, out, then, d, started = _REPLAYS.pop(0)
        try:
            out.update(job.result())
        finally:
            shutil.rmtree(d, ignore_errors=True)
        out["cpu_half_wall_s"] = time.perf_counter() - started
        if then is not None:
            then(out)
    return time.perf_counter() - t0


@_timed
def profile_serve(session, cfg, seq: int = PREFILL_SEQ,
                  names=None) -> dict:
    """The profiler over one B=4 x S=``seq`` prefill and 8 decode steps
    (``names``: the kernels to count, SERVE_KERNELS by default)."""
    dev = session.device
    tok = torch.randint(0, cfg.vocab, (SERVE_BATCH, seq), device=dev)
    batch = {"tokens": tok, "positions": torch.arange(
        seq, device=dev).expand(SERVE_BATCH, seq)}
    cache = session.new_cache(SERVE_BATCH, 16)

    def run():
        nonlocal cache
        session.prefill(batch)
        nxt = tok[:, :1]
        for t in range(8):
            nxt, cache = session.decode(cache, nxt, session.greedy_positions(
                SERVE_BATCH, t))
    return profile(run, names or SERVE_KERNELS)


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
TRAIN_KERNELS = {"plan_assign": "plan_assign_kernel",
                 "plan_rank": "rank_kernel", "plan_place": "place_kernel",
                 "grouped_bmm_bf16": "grouped_bmm_tma_kernel",
                 "grouped_bmm_bf16 on wmma": "grouped_bmm_bf16_kernel",
                 "flash_fwd": "flash_fwd",
                 "flash_bwd_dq": "flash_bwd_dq_mma_kernel",
                 "flash_bwd_dkv": "flash_bwd_dkv",
                 "flash_fwd on FP32 FMA": "flash_fwd_kernel",
                 "flash_bwd_dq on FP32 FMA": "flash_bwd_dq_kernel",
                 "flash_bwd_dkv on FP32 FMA": "flash_bwd_dkv_kernel"}


# grouped_bmm_bf16's routes by the C entry's route argument
BMM16_ROUTES = {fm_ops.TMA: "tma + wgmma", fm_ops.WMMA: "wmma"}


@_timed
def check_bmm_bf16_kernel(cfg, device) -> list[dict]:
    """grouped_bmm_bf16 against its plain version at the training MLP's
    compact products (4096 rows; up and gate share a shape), on the TMA
    route; a ragged case on the TMA route (K and N off the 64-deep k-tile
    and the 256-wide column tile, rows off the 128-row tile) and one on
    wmma (70 rows, 37 x 45). Each timed against its plain version and
    ``torch.bmm`` (ms by CUDA events, device us a call by the profiler);
    at the MLP's shapes the wmma kernel too, called on its route."""
    g = cfg.flgw_groups
    cap_d, cap_ff = compute_cap(cfg.d_model, g, 1.25), \
        compute_cap(cfg.d_ff, g, 1.25)
    rows_n = TRAIN_BATCH * TRAIN_SEQ
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    rows = []
    for name, b, k, n, want in (
            ("up", rows_n, cap_d, cap_ff, fm_ops.TMA),
            ("gate", rows_n, cap_d, cap_ff, fm_ops.TMA),
            ("down", rows_n, cap_ff, cap_d, fm_ops.TMA),
            ("ragged tma", 1000, 200, 328, fm_ops.TMA),
            ("ragged", 70, 37, 45, fm_ops.WMMA)):
        xg = torch.randn((g, b, k), generator=gen, device=device).bfloat16()
        wc = torch.randn((g, k, n), generator=gen, device=device).bfloat16()
        route = fm_ops.bmm_bf16_route(b, k, n, True)
        check(route == want, f"grouped_bmm_bf16 at {name} takes "
                             f"{BMM16_ROUTES[want]} ({BMM16_ROUTES[route]})")
        y = fm_ops.grouped_bmm(xg, wc)
        y_ref = fm_ref.ref_grouped_bmm(xg, wc)
        err = float((y.float() - y_ref.float()).abs().max())
        check(torch.allclose(y.float(), y_ref.float(), **BMM_BF16_TOL),
              f"grouped_bmm_bf16 == plain at {name}, {BMM16_ROUTES[route]} "
              f"(max abs err {err})")
        bnd, by = bound_ms(2 * (g * b * k + g * k * n + g * b * n),
                           2 * g * b * k * n, BF16_OPS_PER_S)
        rows.append(dict(
            proj=name, g=g, b=b, k=k, n=n, max_abs_err=err,
            route=BMM16_ROUTES[route],
            ms=time_ms(lambda: fm_ops.grouped_bmm(xg, wc), 20, 3),
            device_us=device_us(lambda: fm_ops.grouped_bmm(xg, wc)),
            plain_ms=time_ms(lambda: fm_ref.ref_grouped_bmm(xg, wc), 20, 3),
            library_ms=time_ms(lambda: torch.bmm(xg, wc), 20, 3),
            library_device_us=device_us(lambda: torch.bmm(xg, wc)),
            bound_ms=bnd, bound_by=by))
        rows[-1]["tflops"] = 2 * g * b * k * n / rows[-1]["ms"] / 1e9
        rows[-1]["bound_share"] = bnd / rows[-1]["ms"]
        if route == fm_ops.TMA and b == rows_n:
            yw = torch.empty_like(y)

            def wmma():
                fm_ops.BMM16(device, xg.data_ptr(), wc.data_ptr(),
                             yw.data_ptr(), g, b, k, n, fm_ops.WMMA)
            wmma()
            werr = float((yw.float() - y_ref.float()).abs().max())
            check(torch.allclose(yw.float(), y_ref.float(), **BMM_BF16_TOL),
                  f"grouped_bmm_bf16 == plain at {name}, wmma (max abs err "
                  f"{werr})")
            rows[-1].update(wmma_ms=time_ms(wmma, 20, 3),
                            wmma_device_us=device_us(wmma),
                            wmma_max_abs_err=werr)
    return rows


@_timed
def check_flash_bwd_kernels(cfg, device,
                            cases=((TRAIN_SEQ, 4096), (TRAIN_SEQ, 0),
                                   (512, 128)),
                            batch: int = TRAIN_BATCH) -> list[dict]:
    """flash_bwd_dq and flash_bwd_dkv against the plain backward (f32
    math) at the training attention's shapes (``cases``: (S, window) at
    ``cfg``'s heads, head dim and softcap, ``batch`` sequences), bf16;
    each kernel timed alone (dq also at softcap 0), the plain backward
    and SDPA's backward (softcap 0, where its causal mask is the same)
    for all three gradients."""
    import torch.nn.functional as F
    b, hq, hkv, d = batch, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    rows = []
    for s, window in cases:
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
        args0 = args[:-2] + (0.0, 1)
        ptrs = [x.data_ptr() for x in (q, k, v, do, lse, delta)]
        pairs = _attn_pairs(s, window) * b * hq
        io = 2 * (2 * b * hq * s * d + 2 * b * hkv * s * d) + 8 * b * hq * s
        dq_io, dkv_io = io + 2 * b * hq * s * d, io + 4 * b * hkv * s * d
        dq_b, dq_by = bound_ms(dq_io, 6 * d * pairs, BF16_OPS_PER_S)
        dkv_b, dkv_by = bound_ms(dkv_io, 8 * d * pairs, BF16_OPS_PER_S)
        row = dict(
            b=b, hq=hq, hkv=hkv, d=d, softcap=cfg.attn_softcap,
            s=s, window=window, max_abs_err=errs,
            dq_ms=time_ms(lambda: fa_ops.DQ(device, *ptrs, dq.data_ptr(),
                                            *args), 10, 2),
            dq_ms_softcap0=time_ms(lambda: fa_ops.DQ(
                device, *ptrs, dq.data_ptr(), *args0), 10, 2),
            dkv_ms=time_ms(lambda: fa_ops.DKV(device, *ptrs, dk.data_ptr(),
                                              dv.data_ptr(), *args), 10, 2),
            bwd_ms=time_ms(lambda: fa_ops.flash_bwd(q, k, v, out, lse, do,
                                                    **kw), 10, 2),
            plain_ms=time_ms(lambda: fa_ref.ref_flash_bwd(q, k, v, out, lse,
                                                          do, **kw), 5, 1),
            dq_bound_ms=dq_b, dq_bound_by=dq_by, dkv_bound_ms=dkv_b,
            dkv_bound_by=dkv_by,
            # the ceiling of the FP32 FMA route (f32 calls, unaligned bf16
            # ones); not the card's bound for bf16 operands
            dq_f32_cores_bound_ms=bound_ms(dq_io, 6 * d * pairs)[0],
            dkv_f32_cores_bound_ms=bound_ms(dkv_io, 8 * d * pairs)[0],
            library_ms=None, dq_route=FLASH_ROUTES["flash_bwd_dq"],
            dkv_route=FLASH_ROUTES["flash_bwd_dkv"])
        for name, n_flops in (("dq", 6 * d * pairs), ("dkv", 8 * d * pairs)):
            row[f"{name}_tflops"] = n_flops / row[f"{name}_ms"] / 1e9
            row[f"{name}_bound_share"] = (row[f"{name}_bound_ms"]
                                          / row[f"{name}_ms"])
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
    """The state every driven phase starts from: each launch count at 0,
    the interpreter's garbage collected (so that a full collection of
    the earlier phases' objects, the profiler's among them, does not land
    in a timed step) and the device idle."""
    for k in kernels:
        k.launches = 0
    gc.collect()
    torch.cuda.synchronize()


def _check_train_launches(launches: dict, phase: str, flash: bool) -> None:
    for name in ("plan_assign", "grouped_bmm_bf16"):
        check(launches[name] > 0, f"{name} launched in training {phase}")
    check_sort_route(launches, f"training {phase}")
    for name in ("fused_bmm", "grouped_bmm_f32"):
        check(launches[name] == 0, f"{name} not launched in training {phase}")
    layers = 26 * TRAIN_STEPS
    # 3 MLP products a layer, in the forward and its remat replay
    check(launches["grouped_bmm_bf16"] == 6 * layers,
          f"grouped_bmm_bf16 launched 6 times per layer and step in {phase} "
          f"({launches['grouped_bmm_bf16']} of {6 * layers})")
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


_FULL_GC = dict(t0=0.0, ms=0.0)   # wall ms of the full collections so far


def _time_full_gcs(phase: str, info: dict) -> None:
    """A ``gc.callbacks`` entry: adds each full (generation 2) garbage
    collection's wall ms to ``_FULL_GC["ms"]``."""
    if info["generation"] != 2:
        return
    if phase == "start":
        _FULL_GC["t0"] = time.perf_counter()
    else:
        _FULL_GC["ms"] += (time.perf_counter() - _FULL_GC["t0"]) * 1e3


def host_events(dev) -> dict:
    """What can stall a step's host time: the caching allocator's retries
    of a device allocation after freeing its cache, and the interpreter's
    full garbage collections, their count and their wall ms."""
    return dict(alloc_retries=torch.cuda.memory_stats(dev).get(
        "num_alloc_retries", 0), full_gcs=gc.get_stats()[2]["collections"],
        full_gc_ms=_FULL_GC["ms"])


def events_since(dev, before: dict) -> dict:
    return {k: v - before[k] for k, v in host_events(dev).items()}


def run_train(kernels) -> dict:
    """Phase (a): ``train_lm`` (chunked core); phase (b):
    ``make_train_step`` with ``use_flash`` from the same init and
    batches. Launch counts at 0 before each."""
    dev = resolve_device()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero(kernels)
    before = host_events(dev)
    state, hist = train_lm("gemma2_2b", smoke=False, steps=TRAIN_STEPS,
                           batch=TRAIN_BATCH, seq=TRAIN_SEQ, log_every=1,
                           seed=SEED, device=dev, **TRAIN_FLGW)
    torch.cuda.synchronize()
    la = {k.symbol: k.launches for k in kernels}
    _check_train_launches(la, "phase (a)", flash=False)
    a = dict(loss=[float(h["loss"]) for h in hist],
             grad_norm=[float(h["grad_norm"]) for h in hist],
             step_s=[h["step_s"] for h in hist], launches=la,
             peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
             peak_reserved_gb=torch.cuda.max_memory_reserved(dev) / 1e9,
             host_events=events_since(dev, before))
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
    before = host_events(dev)
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
    b.update(launches=lb, peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
             peak_reserved_gb=torch.cuda.max_memory_reserved(dev) / 1e9,
             host_events=events_since(dev, before))
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


@_timed
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
LEARN_KERNELS = {"plan_assign": "plan_assign_kernel",
                 "plan_rank": "rank_kernel", "plan_place": "place_kernel",
                 "grouped_bmm_f32": "grouped_bmm_f32_kernel"}
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
    want.update(plan_assign=2 * layers * encodes,
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


FIG9_PATHS = ("masked", "grouped")
FIG9_TIMEOUT_S = 900
FIG9_THREADS = 1         # intra-op threads a run (host-bound on the card)


def fig9_run(path: str, iters: int, device: str) -> dict:
    """One Fig. 9 training run on ``path`` (module level: a spawned
    process runs it)."""
    env, ecfg = envs.make("predator_prey", **FIG9_ENV)
    cfg = ic3net.IC3NetConfig(hidden=128, flgw_groups=4, flgw_path=path)
    t0 = time.perf_counter()
    _, hist = train.train(cfg, ecfg, train.TrainConfig(batch=BATCH),
                          iterations=iters, seed=SEED, env=env,
                          device=resolve_device(device))
    return dict(success=[h["success"] for h in hist],
                steps_per_s=[h["steps_per_s"] for h in hist],
                mask_sparsity=hist[-1]["mask_sparsity"],
                wall_s=time.perf_counter() - t0)


class _Background:
    """``fn(*args, **kwargs)`` on a daemon thread (the script's exit does
    not wait for it); ``result()`` joins it and re-raises its error."""

    def __init__(self, fn, *args, **kwargs):
        self._out = {}
        self._thread = threading.Thread(
            target=self._run, args=(fn, args, kwargs), daemon=True)
        self._thread.start()

    def _run(self, fn, args, kwargs) -> None:
        try:
            self._out["value"] = fn(*args, **kwargs)
        except BaseException as e:                      # noqa: BLE001
            self._out["error"] = e

    def result(self):
        self._thread.join()
        if "error" in self._out:
            raise self._out["error"]
        return self._out["value"]


def in_process(fn, *args, threads: int, timeout_s: float) -> _Background:
    """``fn(*args)`` in a spawned process of its own, started now;
    ``.result()`` waits for it and raises its error with its traceback.
    For host-bound runs (the card busy ~5 % of their time): the phases
    that run meanwhile share the host and the card with them."""
    from repro_torch.launch import mesh as mesh_lib
    d = tempfile.mkdtemp(prefix="repro-spawn-")

    def run():
        try:
            return mesh_lib.spawn(fn, 1, *args, backend="gloo",
                                  init_file=f"{d}/rdv", timeout_s=timeout_s,
                                  torch_threads=threads)[0]
        finally:
            shutil.rmtree(d, ignore_errors=True)
    return _Background(run)


def start_learning_check(device) -> dict:
    """Starts the Fig. 9 config's masked and grouped runs on ``device``,
    each in a process of its own; ``learning_check`` waits for them."""
    return dict(runs={path: in_process(
        fig9_run, path, FIG9_ITERS, str(device), threads=FIG9_THREADS,
        timeout_s=FIG9_TIMEOUT_S) for path in FIG9_PATHS},
        t0=time.perf_counter())


def learning_check(started: dict) -> dict:
    """Waits for ``start_learning_check``'s runs: each final success rate
    within FIG9_BAND_PCT points of the JAX package's."""
    out = {}
    for path, run in started["runs"].items():
        r = run.result()
        succ = np.array(r["success"]) * 100
        out[path] = dict(
            final_pct=float(succ[-FIG9_TAIL:].mean()),
            first_pct=float(succ[:FIG9_TAIL].mean()),
            mean_pct=float(succ.mean()),
            mask_sparsity=r["mask_sparsity"], wall_s=r["wall_s"],
            ms_per_iter=statistics.median(1e3 / x
                                          for x in r["steps_per_s"]),
            jax_final_pct=FIG9_JAX_PCT[path])
        print(f"  learning check {path}: final success "
              f"{out[path]['final_pct']:.2f} % (JAX package "
              f"{FIG9_JAX_PCT[path]} %), first {FIG9_TAIL} "
              f"{out[path]['first_pct']:.2f} %, mean "
              f"{out[path]['mean_pct']:.2f} %, sparsity "
              f"{out[path]['mask_sparsity']:.4f}, {r['wall_s']:.1f} s "
              "in its own process", flush=True)
    out["wall_s"] = time.perf_counter() - started["t0"]
    for path in FIG9_PATHS:
        r = out[path]
        floor = FIG9_JAX_PCT[path] - FIG9_BAND_PCT
        check(r["final_pct"] >= floor,
              f"learning check {path}: final success {r['final_pct']:.2f} "
              f"% >= {floor:.1f} % (JAX {FIG9_JAX_PCT[path]} % less "
              f"{FIG9_BAND_PCT})")
    return out


# ---------------------------------------------------------------------------
# The async actor/learner pipeline
# ---------------------------------------------------------------------------

ASYNC_ANCHOR_UPDATES = 3
ASYNC_UPDATES = 20
ASYNC_OFF_POLICY = dict(correction="vtrace", capacity=4, actors=2,
                        publish_every=2, max_staleness=4)
ASYNC_LOSS_TOL, ASYNC_PARAM_REL = 1e-5, 1e-4
ASYNC_REPLAY_LOSS_RTOL, ASYNC_REPLAY_GRAD_REL = 1e-5, 1e-4
ACTOR_THREAD = "async_train-actor"


def _counts(kernels) -> dict:
    torch.cuda.synchronize()
    return {k.symbol: k.launches for k in kernels}


class _CountWindows:
    """Counts the rollout windows ``async_train`` generates (its calls of
    ``actor_rollout``, the actor's and any the learner makes when every
    queued window is over the bound), by wrapping the module's function
    for the length of a ``with`` block."""

    def __enter__(self):
        self.windows, real = 0, async_train.actor_rollout

        def counting(*a, **kw):
            self.windows += 1
            return real(*a, **kw)
        self._real = real
        async_train.actor_rollout = counting
        return self

    def __exit__(self, *exc):
        async_train.actor_rollout = self._real


def _param_rel(a, b) -> dict:
    return {k: float((x.float() - y.float()).norm() / y.float().norm())
            for (k, x), y in zip(a.state_dict().items(),
                                 b.state_dict().values())}


def run_async(kernels, device) -> dict:
    """The async pipeline at the actor config's full width, every launch
    count at 0 before each run: the depth-1 anchor against ``train``, the
    off-policy V-trace run (launches checked exactly), one actor rollout
    (no encode), the threaded run and the CPU replay of one update."""
    env, ecfg = envs.make("predator_prey", **ENV)
    cfg = dataclasses.replace(configs.config(), flgw_groups=4,
                              flgw_path="grouped")
    tcfg = train.TrainConfig(batch=BATCH, lr=1e-3)
    window = 5 * ecfg.max_steps      # grouped_bmm_f32 launches a window
    out = {}

    # 1. depth 1, no correction: the synchronous learner's updates
    _zero(kernels)
    m_async, h_async = async_train.async_train(
        cfg, ecfg, tcfg, async_train.AsyncConfig(
            capacity=1, actors=1, correction="none"),
        updates=ASYNC_ANCHOR_UPDATES, seed=SEED, env=env,
        check_publication=True, device=device)
    anchor_launches = _counts(kernels)
    _zero(kernels)
    m_sync, h_sync = train.train(cfg, ecfg, tcfg,
                                 iterations=ASYNC_ANCHOR_UPDATES, seed=SEED,
                                 env=env, device=device)
    sync_launches = _counts(kernels)
    check(anchor_launches["grouped_bmm_f32"]
          == window * 2 * ASYNC_ANCHOR_UPDATES,
          f"async anchor: grouped_bmm_f32 launched {window} times a window "
          f"and a replay ({anchor_launches})")
    loss_diff = [abs(a["loss"] - b["loss"]) for a, b in zip(h_async, h_sync)]
    check(all(d <= ASYNC_LOSS_TOL for d in loss_diff),
          f"async anchor: each loss within {ASYNC_LOSS_TOL} of train's "
          f"({loss_diff})")
    rel = _param_rel(m_async, m_sync)
    check(max(rel.values()) <= ASYNC_PARAM_REL,
          f"async anchor: every parameter within relative norm "
          f"{ASYNC_PARAM_REL} of train's (max {max(rel.values())})")
    out["anchor"] = dict(
        losses=[h["loss"] for h in h_async],
        sync_losses=[h["loss"] for h in h_sync], loss_abs_diff=loss_diff,
        param_rel_max=max(rel.values()), launches=anchor_launches,
        sync_launches=sync_launches)
    del m_async, m_sync

    # 2. off-policy: V-trace, 2 windows an update, publication every 2
    acfg = async_train.AsyncConfig(**ASYNC_OFF_POLICY)
    _zero(kernels)
    with _CountWindows() as counted:
        model, hist = async_train.async_train(
            cfg, ecfg, tcfg, acfg, updates=ASYNC_UPDATES, seed=SEED,
            env=env, check_publication=True, device=device)
    launches = _counts(kernels)
    stale = [h["staleness"] for h in hist]
    check(max(stale) <= acfg.max_staleness and max(stale) >= 1,
          f"async run: staleness within [1, {acfg.max_staleness}] at its "
          f"most ({stale})")
    check(all(np.isfinite(h["loss"]) for h in hist),
          "async run: every loss finite")
    want_bmm = window * (counted.windows + ASYNC_UPDATES)
    check(launches["grouped_bmm_f32"] == want_bmm,
          f"async run: grouped_bmm_f32 launched {want_bmm} times "
          f"({counted.windows} windows + {ASYNC_UPDATES} replays), got "
          f"{launches['grouped_bmm_f32']}")
    layers = len(list(grouped.iter_flgw_layers(model.params)))
    encodes, rem = divmod(launches["plan_assign"], 2 * layers)
    check(rem == 0 and encodes >= 1 + ASYNC_UPDATES,
          f"async run: plan_assign launched {2 * layers} times an encode, "
          f"at least {1 + ASYNC_UPDATES} encodes ({launches['plan_assign']})")
    others = {k: v for k, v in launches.items()
              if k not in ("plan_assign", "grouped_bmm_f32")}
    check(not any(others.values()), f"async run: no other kernel ({others})")
    out["off_policy"] = dict(
        config=ASYNC_OFF_POLICY, updates=ASYNC_UPDATES,
        windows=counted.windows, encodes=encodes, launches=launches,
        staleness=stale, losses=[h["loss"] for h in hist],
        mean_is=[h["mean_is"] for h in hist],
        queue_depth=[h["queue_depth"] for h in hist],
        updates_per_s=hist[-1]["updates_per_s"],
        env_steps_per_s=hist[-1]["env_steps_per_s"])

    # 3. the actor only consumes published plans
    with torch.no_grad():
        plans = model.encode_plans()
    bundle = async_train.publish(model, plans, ASYNC_UPDATES)
    check(bool(async_train.bundle_consistent(bundle)),
          "async: the published bundle certifies")
    _zero(kernels)
    traj = async_train.actor_rollout(
        bundle, train.make_generator(SEED + 30, device), ecfg, tcfg, env)
    rollout_launches = _counts(kernels)
    check(rollout_launches["plan_assign"] == 0
          and rollout_launches["grouped_bmm_f32"] == window,
          f"async actor rollout: 0 plan_assign and {window} "
          f"grouped_bmm_f32 launches ({rollout_launches})")
    traj = async_train.Trajectory(*(x.clone() for x in traj))
    out["actor_rollout"] = dict(launches=rollout_launches)

    # 4. the threaded driver: the actor on its own thread and stream
    _zero(kernels)
    with _CountWindows() as counted_t:
        model_t, hist_t = async_train.async_train(
            cfg, ecfg, tcfg, acfg, updates=ASYNC_UPDATES, seed=SEED,
            env=env, threads=True, check_publication=True,
            debug_contracts=True, device=device)
    threaded_launches = _counts(kernels)
    stale_t = [h["staleness"] for h in hist_t]
    check(max(stale_t) <= acfg.max_staleness,
          f"threaded async run: staleness <= {acfg.max_staleness} "
          f"({stale_t})")
    check(all(np.isfinite(h["loss"]) for h in hist_t),
          "threaded async run: every loss finite")
    check(threaded_launches["grouped_bmm_f32"] > 0,
          "threaded async run: grouped_bmm_f32 launched")
    check(not any(t.name == ACTOR_THREAD for t in threading.enumerate()),
          "threaded async run: the actor thread joined")
    out["threaded"] = dict(
        debug_contracts=True,
        launches=threaded_launches, windows=counted_t.windows,
        staleness=stale_t,
        losses=[h["loss"] for h in hist_t],
        queue_depth=[h["queue_depth"] for h in hist_t],
        updates_per_s=hist_t[-1]["updates_per_s"],
        env_steps_per_s=hist_t[-1]["env_steps_per_s"])
    del model_t

    # 5. one V-trace update of the card's window, replayed on the CPU; the
    # window is one update off-policy for the weights it is replayed at
    opt = rmsprop_init(model.params)
    async_train.learner_update(model, opt, traj, tcfg, acfg, plans)
    out["replay"] = async_replay(model, traj, tcfg, acfg)
    out["breakdown"] = async_breakdown(model, opt, env, ecfg, tcfg, acfg)
    return out


ASYNC_TIMEOUT_S = 900
ASYNC_THREADS = 2        # intra-op threads (the CPU replay of an update)


def async_phase(device: str) -> dict:
    """``run_async`` in a process of its own (module level: a spawned
    process runs it), its wall seconds beside its results."""
    t0 = time.perf_counter()
    out = run_async(port_kernels(), resolve_device(device))
    out["wall_s"] = time.perf_counter() - t0
    return out


def async_breakdown(model, opt, env, ecfg, tcfg, acfg) -> dict:
    """Synchronised wall ms of each piece of a deterministic update
    (median of 3 after a warm-up), and the profiler over one update cycle
    (``acfg.actors`` windows, their pushes and a pop, the refresh, the
    update and a publication)."""
    dev = model.device
    with torch.no_grad():
        plans = model.encode_plans()
    queue = async_train.QueueDriver(
        acfg.capacity, async_train.trajectory_spec(
            model.cfg, tcfg.batch, ecfg.max_steps), acfg.push_policy, dev)
    bundle = async_train.publish(model, plans, 0)
    gen = train.make_generator(SEED + 40, dev)
    steps = dict(
        window=lambda: async_train.actor_rollout(bundle, gen, ecfg, tcfg,
                                                 env),
        push=lambda: queue.push(traj, 0),
        pop=lambda: queue.pop()[0],
        refresh=lambda: train.maybe_refresh_plans(model, plans, 0, None),
        update=lambda: async_train.learner_update(model, opt, window, tcfg,
                                                  acfg, plans),
        publish=lambda: async_train.publish(model, plans, 1))
    times = {k: [] for k in steps}
    for _ in range(4):
        for name, fn in steps.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            if name == "window":
                traj = r
            elif name == "pop":
                window = r
    ms = {k: statistics.median(v[1:]) for k, v in times.items()}

    def cycle():
        b = async_train.publish(model, plans, 2)
        for _ in range(acfg.actors):
            queue.push(async_train.actor_rollout(b, gen, ecfg, tcfg, env), 2)
        w, _ = queue.pop()
        p = train.maybe_refresh_plans(model, plans, 0, None)
        _, m = async_train.learner_update(model, opt, w, tcfg, acfg, p)
        float(m["loss"])
    prof = profile(cycle, LEARN_KERNELS)
    return dict(ms=ms, ms_all=times, profile=prof)


def async_replay(model, traj, tcfg, acfg) -> dict:
    """The V-trace learner loss and its gradients of one window on the
    card and through a CPU copy of the model with the same weights, by
    ``learner_replay``'s rules."""
    with torch.no_grad():
        plans = model.encode_plans()
    cpu_model = ic3net.IC3Net(model.cfg, seed=SEED, device="cpu")
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    with torch.no_grad():
        cpu_plans = cpu_model.encode_plans()
    check(same_plans(plans.plans, cpu_plans.plans)
          and int(plans.sig) == int(cpu_plans.sig),
          "async replay: plans encoded on the card == on the CPU")
    res = {}
    for name, m, p, tr in (
            ("card", model, plans, traj),
            ("cpu", cpu_model, cpu_plans,
             async_train.Trajectory(*(x.cpu() for x in traj)))):
        t0 = time.perf_counter()
        loss, metrics = async_train.learner_loss(m, tr, tcfg, acfg, p)
        grads = dict(_grad_leaves(train.param_grads(m, loss)))
        res[name] = (float(loss.detach()), float(metrics["mean_is"]), grads,
                     time.perf_counter() - t0)
    (loss_card, is_card, g_card, _), (loss_cpu, is_cpu, g_cpu, cpu_s) = \
        res["card"], res["cpu"]
    check(is_cpu < 1.0, f"async replay: the window is off-policy (mean "
                        f"importance weight {is_cpu})")
    check(abs(loss_card - loss_cpu) <= ASYNC_REPLAY_LOSS_RTOL * abs(loss_cpu),
          f"async replay loss within rtol {ASYNC_REPLAY_LOSS_RTOL} "
          f"({loss_card} on the card, {loss_cpu} on the CPU)")
    rel = {}
    for name, want in g_cpu.items():
        got = g_card[name].detach().cpu()
        if name.startswith("gate."):
            check(not got.any() and not want.any(),
                  f"async replay: the gate head's gradient {name} exactly 0 "
                  "on both")
            continue
        rel[name] = float((got - want).norm() / want.norm())
        check(rel[name] <= ASYNC_REPLAY_GRAD_REL,
              f"async replay gradient {name} within relative norm "
              f"{ASYNC_REPLAY_GRAD_REL} ({rel[name]})")
    return dict(loss=(loss_card, loss_cpu), mean_is=(is_card, is_cpu),
                grad_rel=rel, cpu_s=cpu_s)


# ---------------------------------------------------------------------------
# Checkpoints and the fault-tolerant LM loop
# ---------------------------------------------------------------------------

# gemma2-2b at full width cut to one local-window and one global slot:
# a checkpoint is ~7.5 GB (bf16 params, two f32 moments); at 26 layers it
# would be ~26 GB, and the phase holds two at once.
CKPT_LAYERS = 2
CKPT_STEPS, CKPT_SIGTERM_STEP = 4, 3
# refresh every 2 steps on a change of layout: the resume at step 3 lands
# mid-period, where a restore that trusted stale plans would diverge
CKPT_SCHEDULE = SparsitySchedule(groups=4, refresh_every=2,
                                 refresh="on_change")
CKPT_ON_DISK = 2               # (b)'s step 3 and (c)'s step 4
# the launcher leg: its smoke config on the card, grouped
LAUNCH_ARGS = ("--arch", "gemma2_2b", "--flgw-groups", "4", "--flgw-path",
               "grouped", "--save-every", "2", "--steps", "6",
               "--log-every", "1")
LAUNCH_TIMEOUT_S = 300


def _ckpt_run(runner, state, ds, start: int, device) -> tuple:
    """``runner.run`` from ``start`` up to step CKPT_STEPS on batches from
    ``start``; each step's loss and synchronised wall s."""
    batches = make_batch_iterator(ds, start_step=start, device=device)
    try:
        state, end, hist = runner.run(state, batches, start_step=start,
                                      max_steps=CKPT_STEPS)
    finally:
        batches.close()
    return state, dict(end=end, loss=[float(h["loss"]) for h in hist],
                       step_s=[h["step_s"] for h in hist])


def _ckpt_launches(counts: dict, what: str, steps: int,
                   encodes: Optional[int] = None) -> None:
    """grouped_bmm_bf16 6 a layer and step; plan_assign whole encodes of
    12 sides (exactly ``encodes`` where given); nothing of another path."""
    check(counts["grouped_bmm_bf16"] == 6 * CKPT_LAYERS * steps,
          f"grouped_bmm_bf16 launched 6 times per layer and step in {what} "
          f"({counts['grouped_bmm_bf16']} of {6 * CKPT_LAYERS * steps})")
    sides = 2 * 3 * 2      # slots x MLP projections x grouping sides
    if encodes is None:
        check(counts["plan_assign"] % sides == 0,
              f"plan_assign launched whole encodes in {what} ({counts})")
    else:
        check(counts["plan_assign"] == encodes * sides,
              f"plan_assign launched {encodes} encodes of {sides} sides in "
              f"{what} ({counts['plan_assign']})")
    check_sort_route(counts, what)
    for name in ("fused_bmm", "grouped_bmm_f32", "flash_fwd",
                 "flash_bwd_dq", "flash_bwd_dkv", "osel_encode"):
        check(counts[name] == 0, f"{name} not launched in {what}")


def _launcher(d: Path, stop_after: Optional[str]) -> dict:
    """``python -m repro_torch.launch.train`` on the card with
    ``--ckpt-dir d``; with ``stop_after``, SIGTERM once a line starts with
    it. Returns its exit code, output and wall s."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *LAUNCH_ARGS,
           "--ckpt-dir", str(d)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        head = []
        if stop_after is not None:
            for line in proc.stdout:
                head.append(line)
                if line.startswith(stop_after):
                    proc.send_signal(signal.SIGTERM)
                    break
        out, err = proc.communicate(timeout=LAUNCH_TIMEOUT_S)
    finally:
        proc.kill()
        proc.wait()
    return dict(rc=proc.returncode, out="".join(head) + out, err=err[-4000:],
                wall_s=time.perf_counter() - t0)


def _state_hashes(state) -> dict:
    """Each leaf's hash, as ``save_checkpoint`` records it (on
    ``store.IO_THREADS`` threads, as it hashes)."""
    flat = store.tree_paths(state)
    with ThreadPoolExecutor(store.IO_THREADS) as pool:
        futures = [pool.submit(store.hash_array, store.leaf_to_numpy(leaf)[0])
                   for _, leaf in flat]
        return {p: f.result() for (p, _), f in zip(flat, futures)}


def run_checkpoint(kernels, device) -> dict:
    """gemma2-2b at full width, 2 layers, grouped, through StepRunner:
    (a) steps 1-4 uninterrupted; (b) the same init preempted by a real
    SIGTERM inside step 3; (c) a fresh state from another seed restored
    through ``restore_state`` and stepped to 4, saving step 4. Every
    launch count at 0 before each. (a)'s step-4 state and (c)'s step-4
    checkpoint must agree hash for hash. Then a corrupted leaf of that
    checkpoint, and the launcher as a process preempted and resumed. The
    save timed is (c)'s step-4 save (its run's wall less its step's), the
    hashing (a)'s state's (the device-to-host copies included)."""
    t_phase = time.perf_counter()
    cfg = registry.get_config("gemma2_2b", **TRAIN_FLGW).with_updates(
        n_layers=CKPT_LAYERS)
    step_fn = step_lib.make_train_step(cfg, schedule=CKPT_SCHEDULE)
    ds = SyntheticTokens(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=SEED)
    sigterm_before = signal.getsignal(signal.SIGTERM)
    root = Path(tempfile.mkdtemp(prefix="repro-ckpt-"))
    dir_a, dir_b = root / "a", root / "b"      # (a) writes nothing
    out = dict(cut=f"n_layers {CKPT_LAYERS} of 26 (one local, one global "
                   f"slot)", params=param_count(cfg), dir=str(root))

    @functools.wraps(step_fn)                 # keeps ``mutates_state``
    def timed(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        return state, dict(metrics, step_s=time.perf_counter() - t0)

    @functools.wraps(step_fn)
    def preempted(state, batch):
        if int(state.step) == CKPT_SIGTERM_STEP - 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return timed(state, batch)

    try:
        # (a) uninterrupted
        _zero(kernels)
        state = state_lib.init_state(
            torch.Generator(device=device).manual_seed(SEED), cfg)
        state_bytes = sum(leaf.numel() * leaf.element_size()
                          for _, leaf in store.tree_paths(state))
        disk = shutil.disk_usage(root)
        out.update(state_bytes=state_bytes, disk_free=disk.free,
                   disk_total=disk.total)
        print(f"  checkpoint phase: {out['cut']}, {out['params']:,} params, "
              f"{state_bytes / 1e9:.3f} GB a state; {root}: "
              f"{disk.free / 1e9:.1f} of {disk.total / 1e9:.1f} GB free",
              flush=True)
        check(disk.free >= CKPT_ON_DISK * state_bytes,
              f"{root} holds {CKPT_ON_DISK} checkpoints of "
              f"{state_bytes / 1e9:.2f} GB ({disk.free / 1e9:.1f} GB free)")
        # no save: (c) takes the periodic one; (a)'s step-4 state is hashed
        # in memory, as a save would hash it
        runner = StepRunner(timed, dir_a, save_every=CKPT_STEPS + 1)
        try:
            state, out["a"] = _ckpt_run(runner, state, ds, 0, device)
        finally:
            runner.guard.restore()
        out["a"]["launches"] = _counts(kernels)
        _ckpt_launches(out["a"]["launches"], "checkpoint run (a)",
                       CKPT_STEPS)
        check(out["a"]["end"] == CKPT_STEPS,
              f"run (a) ran to step {CKPT_STEPS} ({out['a']['end']})")
        t0 = time.perf_counter()
        hashes_a = _state_hashes(state)
        out["hash_s"] = time.perf_counter() - t0
        del state

        # (b) the same init, SIGTERM inside step 3 (no periodic save before
        # it: (a) and (c) take those)
        _zero(kernels)
        state = state_lib.init_state(
            torch.Generator(device=device).manual_seed(SEED), cfg)
        runner = StepRunner(preempted, dir_b, save_every=CKPT_STEPS)
        try:
            state, out["b"] = _ckpt_run(runner, state, ds, 0, device)
        finally:
            runner.guard.restore()
        out["b"]["launches"] = _counts(kernels)
        _ckpt_launches(out["b"]["launches"], "checkpoint run (b)",
                       CKPT_SIGTERM_STEP)
        check(out["b"]["end"] == CKPT_SIGTERM_STEP
              and store.list_steps(dir_b) == [CKPT_SIGTERM_STEP],
              f"run (b) stopped at the SIGTERM's boundary "
              f"{CKPT_SIGTERM_STEP} and saved it ({out['b']['end']}, "
              f"{store.list_steps(dir_b)})")
        del state

        # (c) a fresh state, restored and stepped to 4
        state = state_lib.init_state(
            torch.Generator(device=device).manual_seed(SEED + 9), cfg)
        runner = StepRunner(timed, dir_b, save_every=2)
        try:
            _zero(kernels)
            t0 = time.perf_counter()
            state, start = runner.restore_or(
                state, restore_fn=lambda s, sh: state_lib.restore_state(
                    dir_b, s, cfg, shardings=sh))
            torch.cuda.synchronize()
            out["restore_s"] = time.perf_counter() - t0
            out["restore_launches"] = _counts(kernels)
            check(start == CKPT_SIGTERM_STEP
                  and int(state.step) == CKPT_SIGTERM_STEP,
                  f"restore_or resumed at {CKPT_SIGTERM_STEP} ({start})")
            _ckpt_launches(out["restore_launches"], "the restore", 0,
                           encodes=1)
            _zero(kernels)
            t0 = time.perf_counter()
            state, out["c"] = _ckpt_run(runner, state, ds, start, device)
            # the run's one step and its step-4 save
            out["save_s"] = time.perf_counter() - t0 - sum(
                out["c"]["step_s"])
        finally:
            runner.guard.restore()
        out["c"]["launches"] = _counts(kernels)
        _ckpt_launches(out["c"]["launches"], "checkpoint run (c)",
                       CKPT_STEPS - CKPT_SIGTERM_STEP)
        mc = store.read_manifest(dir_b, step=CKPT_STEPS)
        hashes_c = {e["path"]: e["hash"] for e in mc["leaves"]}
        differ = [p for p in hashes_c if hashes_a.get(p) != hashes_c[p]]
        out.update(leaves=len(hashes_c), leaves_differing=differ)
        check(hashes_a.keys() == hashes_c.keys() and not differ,
              f"(a)'s step-{CKPT_STEPS} state and (c)'s step-{CKPT_STEPS} "
              f"checkpoint agree leaf for leaf, hash for hash ({len(differ)} "
              f"of {len(hashes_c)} differ: {differ[:8]})")
        path = dir_b / f"step_{CKPT_STEPS:08d}"
        out["ckpt_bytes"] = sum(f.stat().st_size for f in path.iterdir())

        # a corrupted leaf of (c)'s step-4 checkpoint
        bad = mc["leaves"][-1]
        raw = bytearray((path / bad["file"]).read_bytes())
        raw[-1] ^= 0xFF
        (path / bad["file"]).write_bytes(bytes(raw))
        try:
            store.restore_checkpoint(dir_b, state)
            raised = None
        except IOError as e:
            raised = str(e)
        check(raised == f"checkpoint corruption at {bad['path']}",
              f"a corrupted {bad['path']} raises IOError ({raised})")
        check(_state_hashes(state) == hashes_c,
              "the failed restore left the target untouched")
        out.update(corrupted=bad["path"], raised=raised)
        del state
        torch.cuda.empty_cache()

        # the launcher as a process: SIGTERM inside step 3, then resume
        launch_dir = root / "launcher"
        first = _launcher(launch_dir, stop_after="step 2:")
        check(first["rc"] == 0 and store.list_steps(launch_dir) == [2, 3],
              f"the launcher saved step 3 at SIGTERM and exited 0 (rc "
              f"{first['rc']}, steps {store.list_steps(launch_dir)}): "
              f"{first['err']}")
        second = _launcher(launch_dir, stop_after=None)
        check(second["rc"] == 0 and "steps 3->6" in second["out"],
              f"the relaunched launcher resumed at 3 (rc {second['rc']}): "
              f"{second['out'][-2000:]} {second['err']}")
        out["launcher"] = dict(first=first, second=second)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(signal.getsignal(signal.SIGTERM) is sigterm_before,
          "the SIGTERM handler after the phase is the one before it")
    out["save_gb_s"] = out["ckpt_bytes"] / out["save_s"] / 1e9
    out["restore_gb_s"] = out["ckpt_bytes"] / out["restore_s"] / 1e9
    out["wall_s"] = time.perf_counter() - t_phase
    out["launches"] = {k: sum(out[leg]["launches"][k] for leg in "abc")
                       + out["restore_launches"][k]
                       for k in out["a"]["launches"]}
    return out


# ---------------------------------------------------------------------------
# The rest of the dense family, prefix-LM and the banded prefill
# ---------------------------------------------------------------------------

# (arch, layers run, prefill S). The depth is cut: gemma2-27b's 46 layers
# are 54.5 GB of bf16 weights, which with the compact copies, the
# activations and the plain versions' checks do not fit one 80 GB card;
# the other two for the script's time limit. gemma2-27b keeps 2 blocks of
# local + global, gemma3-12b one 5:1 period; gemma3-12b prefills 2,048
# tokens so that its 1,024 window bites.
DENSE_FAMILY = (("gemma2_27b", 4, 1024), ("internlm2_20b", 2, 1024),
                ("gemma3_12b", 6, 2048))
# blocks of the card's weights replayed on the CPU: one local and one
# global slot where the config has both (internlm2-20b has only global)
DENSE_REPLAY_BLOCKS = {"gemma2_27b": 1, "internlm2_20b": 2, "gemma3_12b": 1}
REPLAY_SEQ, REPLAY_STEPS = 128, 4
PREFIX_TEXT = 768             # paligemma: 256 patches + 768 text tokens
PREFIX_REPLAY_LAYERS, PREFIX_REPLAY_TEXT = 2, 128
BANDED_SEQ, BANDED_CHUNK = 2048, 512
LAUNCHER_ITERS = 20           # the sync launcher at the reference defaults
LAUNCHER_ARGS = ("--path", "grouped", "--groups", "4")
LAUNCHER_ENV = dict(n_agents=4, size=4, max_steps=12)
LAUNCHER_TIMEOUT_S = 300
LM_ONLY = ("grouped_bmm_f32", "grouped_bmm_bf16", "flash_bwd_dq",
           "flash_bwd_dkv", "osel_encode")


def _launches(kernels) -> dict:
    torch.cuda.synchronize()
    return {k.symbol: k.launches for k in kernels}


@_timed
def check_assign_sides(params, slack: float) -> dict:
    """plan_assign bitwise at every FLGW side of ``params`` that takes the
    sort route, timed once per distinct (L, M, G, axis); plan_rank and
    plan_place bitwise at every side past it, timed once per distinct
    shape. ``{"sort": rows, "tiled": rows}``."""
    out, timed = {"sort": [], "tiled": []}, set()
    for name, scores, axis in flgw_sides(params):
        m, g = scores.shape[-2:] if axis else scores.shape[-2:][::-1]
        key = (scores.numel() // (m * g), m, g, axis)
        first = key not in timed
        timed.add(key)
        if pe_ops.assign_route(m, g) == "sort":
            row = check_assign_one(name, scores, axis, slack)
            if first:
                row.update(time_assign(scores, axis, slack))
            out["sort"].append(row)
        else:
            out["tiled"].append(check_tiled(name, scores, axis, slack,
                                            timed=first))
    return out


def _print_family_kernels(arch, sides, fused_rows, flash_rows) -> None:
    for r in sides["sort"]:
        if "ms" in r:
            print(f"  plan_assign {arch} L={r['layers']} M={r['items']} "
                  f"axis {r['axis']}: {r['ms']:.4f} ms, {r['device_us']} "
                  f"device us, plain {r['plain_ms']:.4f}, bound "
                  f"{r['bound_ms']:.2e} ({r['bound_by']})")
    for r in sides["tiled"]:
        if "rank" in r:
            print(f"  plan_rank + plan_place {arch} {r['side']} L="
                  f"{r['layers']} M={r['items']}: rank {r['rank']['ms']:.4f}"
                  f" ms ({r['rank']['device_us']} device us), place "
                  f"{r['place']['ms']:.4f} ms ({r['place']['device_us']} "
                  f"device us), plain {r['rank']['plain_ms']:.3f} + "
                  f"{r['place']['plain_ms']:.3f}")
    for r in fused_rows:
        cold = f", cold {r['ms_cold']:.4f}" if "ms_cold" in r else ""
        print(f"  fused_bmm {arch} {r['proj']:>4} {r['rows']:>4} rows K="
              f"{r['cap_m']} N={r['cap_n']}: {r['ms']:.4f} ms{cold} "
              f"({r['tflops']:.1f} TFLOP/s, {r['bound_share']:.3f} of the "
              f"bound, {r['route']}), plain {r['plain_ms']:.4f}, bmm "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
              f"({r['bound_by']})")
    for r in flash_rows:
        print(f"  flash_fwd {arch} Hq={r['hq']} Hkv={r['hkv']} D={r['d']} "
              f"S={r['s']} window={r['window']} softcap {r['softcap']}: "
              f"{r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s, "
              f"{r['bound_share']:.3f} of the bound, {r['route']}), plain "
              f"{r['plain_ms']:.4f}, sdpa {r['library_ms']}, bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']})", flush=True)


def run_dense_family(kernels, device, card: str) -> tuple[dict, dict]:
    """Phase 10: each DENSE_FAMILY config at full width, cut in depth:
    its kernels held against their plain versions at its shapes, then
    its serving path driven with the launch counts at 0 (a certify
    session, a B=4 prefill with ``use_flash``, a lockstep Engine run of 4
    requests, prompt 64, gen 32), a CPU replay and a profile. Returns
    (per-config results, gemma3-12b's config and params for phase 11)."""
    out, keep = {}, None
    for arch, layers, seq in DENSE_FAMILY:
        cfg = registry.get_config(arch, n_layers=layers, **SERVE_FLGW)
        params = serve_params(cfg, device)
        slack = flgw.FLGWConfig().capacity_slack
        n_params = sum(t.numel() for t in _leaves(params))
        sides = check_assign_sides(params, slack)
        # per encode: the sides of every slot past the sort limit
        tiled_sides = len(sides["tiled"])
        fused_rows = check_fused_kernel(params, cfg,
                                        (4, SERVE_BATCH * seq), None)
        windows = sorted({s.window for s in cfg.pattern}, reverse=True)
        flash_rows = check_flash_kernel(cfg, device,
                                        tuple((seq, w) for w in windows))
        _print_family_kernels(arch, sides, fused_rows, flash_rows)
        sv = run_serve(cfg, params, kernels, seq=seq, continuous=False,
                       tiled_sides=tiled_sides)
        session = sv.pop("session")
        del sv["inputs"], sv["logits"]
        if arch == "gemma2_27b":
            check(tiled_sides == 3 * cfg.period and sv["launches"][
                "plan_rank"] > 0,
                  "gemma2-27b: plan_rank and plan_place on its d_ff sides")
        lk = sv["lockstep"]
        print(f"phase 10 {arch} ({layers} layers, {n_params:,} params) on "
              f"{card}: launches {sv['launches']}; prefill B={SERVE_BATCH} "
              f"x S={seq} {sv['prefill_ms']:.1f} ms "
              f"({sv['prefill_tokens_per_s']:.0f} tokens/s); lockstep "
              f"{lk['tokens_per_s']:.1f} tokens/s, p50 {lk['p50_s']:.3f} s",
              flush=True)
        rp = cpu_replay(
            cfg, params, blocks=DENSE_REPLAY_BLOCKS[arch], seq=REPLAY_SEQ,
            steps=REPLAY_STEPS, then=lambda rp, arch=arch: print(
                f"  phase 10 {arch}: CPU replay ({rp['layers']} layers): "
                f"max abs err {rp['max_abs_err']}, {rp['equal_tokens']}/"
                f"{REPLAY_STEPS} greedy tokens equal", flush=True))
        prof = profile_serve(session, cfg, seq)
        print_profile(f"{arch} prefill + 8 decode steps", prof)
        check_flash_routes(prof, f"the {arch} serve profile", ("flash_fwd",))
        check_fused_routes(prof)
        out[arch] = dict(layers=layers, seq=seq, params=n_params,
                         assign=sides, fused_rows=fused_rows,
                         flash_rows=flash_rows, serve=sv, replay=rp,
                         profile=prof)
        del session
        plan_cache.clear()
        if arch == "gemma3_12b":
            keep = (cfg, params)
        del params
        torch.cuda.empty_cache()
    return out, keep


def _prefix_batch(cfg, b: int, text: int, device, seed: int) -> dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab, (b, text), generator=gen,
                                    device=device),
            "positions": torch.arange(text, device=device).expand(b, text),
            "patch_embeds": torch.randn((b, cfg.prefix_len, cfg.d_model),
                                        generator=gen, device=device
                                        ).to(cfg.dtype)}


def run_prefix(kernels, device, card: str) -> dict:
    """Phase 11, first half: paligemma-3b at full depth. Its kernels at
    its shapes (plan_assign at L = 18, the d_ff sides at 16,384 items;
    fused_bmm at 4 and B*S rows), then with the counts at 0 a certify
    session and a B=4 prefill of 256 patches + 768 text tokens (the
    prefix takes the chunked core, so flash_fwd is not launched), and a
    CPU replay of a 2-layer cut (the prefix mask)."""
    cfg = registry.get_config("paligemma_3b", **SERVE_FLGW)
    params = serve_params(cfg, device)
    n_params = sum(t.numel() for t in _leaves(params))
    sides = check_assign_sides(params, flgw.FLGWConfig().capacity_slack)
    check(not sides["tiled"] and any(
        r["items"] == pe_ops.SORT_MAX_ITEMS and r["layers"] == cfg.n_layers
        for r in sides["sort"]),
          "paligemma-3b: every side on plan_assign, the d_ff sides at "
          "16,384 items and L = 18")
    seq = cfg.prefix_len + PREFIX_TEXT
    fused_rows = check_fused_kernel(params, cfg, (4, SERVE_BATCH * seq),
                                    None)
    _print_family_kernels("paligemma_3b", sides, fused_rows, [])
    plan_cache.clear()
    _zero(kernels)
    session = ServeSession(cfg, params, plan_policy="certify")
    batch = _prefix_batch(cfg, SERVE_BATCH, PREFIX_TEXT, device, SEED + 7)
    prefill_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = session.prefill(batch)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
    launches = _launches(kernels)
    check(logits.shape == (SERVE_BATCH, 1, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          "paligemma prefill logits finite, (B, 1, vocab)")
    check(launches["flash_fwd"] == 0,
          "a prefix prefill takes the chunked core: no flash_fwd launch")
    check(launches["plan_assign"] == 2 * 7 * cfg.period
          * plan_cache.stats()["encodes"] > 0 and launches["fused_bmm"] > 0,
          f"paligemma: plan_assign (14 sides an encode) and fused_bmm "
          f"launched ({launches})")
    check_sort_route(launches, "the paligemma prefix path")
    for name in LM_ONLY:
        check(launches[name] == 0, f"{name} not launched on the prefix path")
    # the CPU replay of a 2-layer cut: the same [patches; text] prefill
    cut = cfg.with_updates(n_layers=PREFIX_REPLAY_LAYERS)
    card_p = dict(params, blocks=_blocks_slice(params["blocks"],
                                               PREFIX_REPLAY_LAYERS))
    cpu_p = _to(card_p, "cpu")
    small = _prefix_batch(cfg, 1, PREFIX_REPLAY_TEXT, device, SEED + 8)
    outs = []
    for p in (card_p, cpu_p):
        dev = p["embed"]["embedding"].device
        b = _to(small, dev)
        with torch.inference_mode():
            plans = planenc.attach_compact(transformer.encode_plans(p, cut),
                                           p)
            hidden, _, _ = transformer.lm_apply(
                p, cut, b["tokens"], b["positions"],
                patch_embeds=b["patch_embeds"], return_hidden=True,
                plans=plans, q_chunk=step_lib.pick_q_chunk(
                    cfg.prefix_len + PREFIX_REPLAY_TEXT))
        outs.append(hidden.float().cpu())
    err = float((outs[0] - outs[1]).abs().max())
    check(outs[0].shape == (1, PREFIX_REPLAY_TEXT, cfg.d_model)
          and torch.allclose(outs[0], outs[1], **REPLAY_BF16_TOL),
          f"prefix replay: the text positions' hidden states within "
          f"{REPLAY_BF16_TOL} (max abs err {err})")
    res = dict(params=n_params, layers=cfg.n_layers, seq=seq,
               assign=sides, fused_rows=fused_rows, launches=launches,
               prefill_s=prefill_s,
               prefill_ms=statistics.median(prefill_s) * 1e3,
               prefill_tokens_per_s=SERVE_BATCH * seq
               / statistics.median(prefill_s),
               encodes=plan_cache.stats()["encodes"],
               replay=dict(layers=PREFIX_REPLAY_LAYERS,
                           text=PREFIX_REPLAY_TEXT, max_abs_err=err,
                           tol=REPLAY_BF16_TOL))
    print(f"phase 11 paligemma_3b ({cfg.n_layers} layers, {n_params:,} "
          f"params) on {card}: launches {launches}; prefill B={SERVE_BATCH} "
          f"x ({cfg.prefix_len} patches + {PREFIX_TEXT} tokens) "
          f"{res['prefill_ms']:.1f} ms; CPU replay ({PREFIX_REPLAY_LAYERS} "
          f"layers) max abs err {err:.3g}", flush=True)
    del session, params, card_p, cpu_p
    plan_cache.clear()
    torch.cuda.empty_cache()
    return res


def run_banded(cfg, params, kernels, card: str) -> dict:
    """Phase 11, second half: gemma3-12b's chunked prefill (no flash) at
    S = 2,048 with q_chunk 512, banded and not, from the same weights and
    plans, each driven with the counts at 0: every position's hidden
    state and the last logits within the bf16 gate."""
    cfg = cfg.with_updates(use_flash=False)
    dev = params["embed"]["embedding"].device
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    tok = torch.randint(0, cfg.vocab, (SERVE_BATCH, BANDED_SEQ),
                        generator=gen, device=dev)
    pos = torch.arange(BANDED_SEQ, device=dev).expand(SERVE_BATCH, BANDED_SEQ)
    with torch.inference_mode():
        plans = planenc.attach_compact(transformer.encode_plans(params, cfg),
                                       params)
    res, hid = {}, {}
    for banded in (True, False):
        _zero(kernels)
        ms = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                h, _, _ = transformer.lm_apply(
                    params, cfg, tok, pos, q_chunk=BANDED_CHUNK,
                    banded=banded, return_hidden=True, plans=plans)
                last = softcap(unembed(
                    params["embed"], h[:, -1:]).float(), cfg.logit_softcap)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = _launches(kernels)
        check(launches["flash_fwd"] == 0 and launches["fused_bmm"] > 0,
              f"banded={banded}: the chunked core, no flash_fwd; fused_bmm "
              f"launched ({launches})")
        for name in ("plan_assign", "plan_rank", "plan_place", *LM_ONLY):
            check(launches[name] == 0,
                  f"{name} not launched by a prefill on cached plans")
        hid[banded] = (h.float(), last)
        res["banded" if banded else "unbanded"] = dict(
            ms=ms, launches=launches)
    err = float((hid[True][0] - hid[False][0]).abs().max())
    lerr = float((hid[True][1] - hid[False][1]).abs().max())
    check(torch.allclose(hid[True][0], hid[False][0], **REPLAY_BF16_TOL)
          and torch.allclose(hid[True][1], hid[False][1], **REPLAY_BF16_TOL),
          f"banded == unbanded prefill within {REPLAY_BF16_TOL} (hidden "
          f"{err}, last logits {lerr})")
    window = max(s.window for s in cfg.pattern)
    res.update(seq=BANDED_SEQ, q_chunk=BANDED_CHUNK, window=window,
               band=min(BANDED_SEQ, (-(-window // BANDED_CHUNK) + 1)
                        * BANDED_CHUNK),
               hidden_max_abs_err=err, logits_max_abs_err=lerr,
               tol=REPLAY_BF16_TOL)
    print(f"phase 11 banded gemma3_12b B={SERVE_BATCH} x S={BANDED_SEQ} "
          f"q_chunk {BANDED_CHUNK} (band {res['band']} keys of a local "
          f"slot's chunk) on {card}: banded {min(res['banded']['ms']):.1f} "
          f"ms, unbanded {min(res['unbanded']['ms']):.1f} ms; max abs err "
          f"hidden {err:.3g}, last logits {lerr:.3g}", flush=True)
    return res


def _launcher_report(out: str) -> dict:
    """The sync launcher's printed success, throughput and per-layer
    sparsity."""
    succ = re.search(r"success: first-\d+ ([\d.]+)\s+last-\d+ ([\d.]+)", out)
    thr = re.search(r"throughput: ([\d.]+) iters/s, ([\d.]+) env-steps/s, "
                    r"est\. sparse ([\d.]+) GFLOPS", out)
    layers = dict(re.findall(r"^  (\w+)\s+([\d.]+)%$", out, re.M))
    check(succ is not None and thr is not None and "learned per-layer "
          "sparsity:" in out and len(layers) == 5,
          f"the launcher printed its success, throughput and sparsity lines "
          f"({out[-600:]!r})")
    for name, pct in layers.items():
        check(abs(float(pct) - 75.0) < 10.0,
              f"learned sparsity of {name} near 75 % ({pct} %)")
    return dict(success_first=float(succ[1]), success_last=float(succ[2]),
                iters_per_s=float(thr[1]), env_steps_per_s=float(thr[2]),
                sparse_gflops=float(thr[3]),
                sparsity_pct={k: float(v) for k, v in layers.items()})


def run_sync_launcher(kernels, device, card: str) -> dict:
    """Phase 12: ``python -m repro_torch.launch.marl_ic3net --path grouped
    --groups 4`` at the reference's defaults (4 agents on 4x4, hidden
    128, B=16). Its kernels at its shapes (plan_assign bitwise at every
    side, grouped_bmm_f32 at every layer, timed); its ``main`` in this
    process with the counts at 0; then the same command as a process on
    the card (exit 0, its lines), and ``--mesh 2,2`` without a process
    group (a non-zero exit, "needs 4 devices")."""
    env, ecfg = envs.make("predator_prey", **LAUNCHER_ENV)
    cfg = ic3net.IC3NetConfig(hidden=128, flgw_groups=4, flgw_path="grouped")
    model, _ = train._init(cfg, ecfg, env, SEED, device)
    slack = model.cfg.flgw.capacity_slack
    assign = [check_assign_one(name, scores, axis, slack)
              for name, scores, axis in flgw_sides(model.params)]
    with torch.inference_mode():
        plans = model.encode_plans()
    bmm_rows = check_bmm_kernel(model, plans, 16 * LAUNCHER_ENV["n_agents"])
    for r in bmm_rows:
        print(f"  grouped_bmm_f32 launcher {r['layer']:>7} {r['b']}x{r['k']}"
              f"x{r['n']}: {r['ms']:.4f} ms, {r['device_us']:.2f} device us; "
              f"plain {r['plain_ms']:.4f}, bmm {r['library_ms']:.4f}, bound "
              f"{r['bound_ms']:.2e} ({r['bound_by']})")
    del model, plans
    argv = [*LAUNCHER_ARGS, "--iterations", str(LAUNCHER_ITERS)]
    _zero(kernels)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        model, hist = marl_ic3net.main(argv)
    in_proc_s = time.perf_counter() - t0
    launches = _launches(kernels)
    check(model.device.type == "cuda" and len(hist) == LAUNCHER_ITERS,
          "the launcher trained on the card")
    check(launches["plan_assign"] > 0 and launches["grouped_bmm_f32"] > 0,
          f"plan_assign and grouped_bmm_f32 launched by the launcher "
          f"({launches})")
    check_sort_route(launches, "the sync launcher")
    for name in ("grouped_bmm_bf16", "fused_bmm", "flash_fwd",
                 "flash_bwd_dq", "flash_bwd_dkv", "osel_encode"):
        check(launches[name] == 0, f"{name} not launched by the launcher")
    in_proc = _launcher_report(buf.getvalue())
    del model, hist
    cmd = [sys.executable, "-m", "repro_torch.launch.marl_ic3net"]
    penv = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    ok = subprocess.run([*cmd, *argv], env=penv, capture_output=True,
                        text=True, timeout=LAUNCHER_TIMEOUT_S)
    proc_s = time.perf_counter() - t0
    check(ok.returncode == 0, f"the launcher process exited 0 "
          f"({ok.returncode}: {ok.stderr[-2000:]})")
    check("device cuda" in ok.stdout, "the launcher process ran on the card")
    proc = _launcher_report(ok.stdout)
    bad = subprocess.run([*cmd, *argv, "--mesh", "2,2"], env=penv,
                         capture_output=True, text=True,
                         timeout=LAUNCHER_TIMEOUT_S)
    check(bad.returncode != 0 and "marl mesh (2, 2) needs 4 devices, only "
          "1 available" in bad.stderr,
          f"--mesh 2,2 without a process group exits non-zero with the "
          f"reference's message ({bad.returncode}: {bad.stderr[-400:]!r})")
    res = dict(argv=argv, launches=launches, assign=assign,
               bmm_rows=bmm_rows, in_process=in_proc, in_process_s=in_proc_s,
               process=proc, process_s=proc_s, process_stdout=ok.stdout,
               mesh_rc=bad.returncode, mesh_stderr=bad.stderr[-400:])
    print(f"phase 12 sync launcher ({' '.join(argv)}) on {card}: launches "
          f"{launches}; in process {in_proc['iters_per_s']:.2f} iters/s, "
          f"{in_proc['env_steps_per_s']:.0f} env-steps/s, "
          f"{in_proc['sparse_gflops']:.3f} GFLOPS, sparsity "
          f"{in_proc['sparsity_pct']}; as a process (exit 0, {proc_s:.1f} s) "
          f"{proc['iters_per_s']:.2f} iters/s; --mesh 2,2 exit "
          f"{bad.returncode}", flush=True)
    return res


# ---------------------------------------------------------------------------
# Phase 13: the MoE family served
# ---------------------------------------------------------------------------

# (arch, layers, FLGW targets, prefill B, prefill S), full width, cut in
# depth: mixtral-8x22b at 4 of 56 layers (4.83 GB of bf16 experts a
# layer, ~1.9 GB of compact copies), arctic-480b at 1 of 35 (26.8 GB of
# experts, ~10.5 GB of compact copies, the dense residual beside them)
MOE_FAMILY = (("mixtral_8x22b", 4, ("moe", "attn"), 4, 1024),
              ("arctic_480b", 1, ("moe", "mlp", "attn"), 1, 512))
MOE_REPLAY_SEQ, MOE_REPLAY_STEPS = 64, 4      # mixtral's 1-layer CPU replay
MOE_ORACLE_TOKENS = 64
DECODE_ROWS = 8          # a lockstep decode step's dropless rows: B=4, top-2
# compact projections a layer: q, k, v, o and the experts' up, gate, down
# (each one launch for all experts), plus moe_dense's residual MLP
MOE_PROJECTIONS = {"moe": 7, "moe_dense": 10}
MOE_KERNELS = dict(SERVE_KERNELS, **{
    "grouped_bmm_bf16": "grouped_bmm_tma_kernel",
    "grouped_bmm_bf16 on wmma": "grouped_bmm_bf16_kernel"})


def _moe_layer(params, cfg):
    """Block 0's MoE params and their freshly encoded plans (stacked over
    the experts), with compact weights attached."""
    p = transformer._index(params["blocks"], 0)["slot0"]["moe"]
    fl = flgw.FLGWConfig(groups=cfg.flgw_groups, path="grouped")
    with torch.inference_mode():
        plans = grouped.attach_compact(grouped.encode_plans(p, fl), p)
    return p, plans


# the plain versions of the batched expert products run this many tiles
# at a time (they are independent): arctic's 512 tiles at 1,024 rows in
# one f32 einsum would hold ~25 GB beside the layer's 38 GB, and 32 of
# jamba-1.5-large's 64 expert tiles at 4,096 rows ~10 GB
PLAIN_TILES = 32


def _plain_tiles(fn, *args):
    """``fn(*args)`` with its last two arguments (tiled on their leading
    axis) split into chunks of PLAIN_TILES tiles, the outputs
    concatenated: the same values as one call."""
    *head, a, b = args
    return torch.cat([fn(*head, a[i:i + PLAIN_TILES], b[i:i + PLAIN_TILES])
                      for i in range(0, a.shape[0], PLAIN_TILES)])


def _close_tiles(fn, y, tol, *args) -> tuple[bool, float]:
    """``y`` against ``fn(*args)`` (tiled as :func:`_plain_tiles`), chunk
    by chunk: (allclose within ``tol``, max abs err), without holding the
    whole plain output."""
    *head, a, b = args
    ok, err = True, 0.0
    for i in range(0, a.shape[0], PLAIN_TILES):
        got = y[i:i + PLAIN_TILES].float()
        want = fn(*head, a[i:i + PLAIN_TILES], b[i:i + PLAIN_TILES]).float()
        err = max(err, float((got - want).abs().max()))
        ok &= bool(torch.allclose(got, want, **tol))
        del got, want
    return ok, err


def fused_route(rows: int, cols: int) -> str:
    """What computes a bf16 fused_bmm call (the C entry's shape test, on
    aligned operands): wgmma above 64 rows, the streaming kernel at 64 or
    fewer, both for rows and columns multiples of 8; else the first wmma
    kernel."""
    if cols % 8 == 0 and rows <= 64:
        return FUSED_ROUTES["decode"]
    if cols % 8 == 0 and rows % 8 == 0:
        return FUSED_ROUTES["prefill"]
    return "wmma"


def _expert_projs(p, plans) -> list:
    """``(name, w (E, M, N), plan)`` of one MoE layer's expert
    projections."""
    return [(name, p[name]["w"], plans[name])
            for name in ("up", "gate", "down")]


@_timed
def check_compact_kernels(projs, cfg, rows_list, bmm: bool,
                          fused: bool = True) -> list[dict]:
    """fused_bmm against its plain version at each of ``projs`` (``(name,
    w (E, M, N), plan with leaves (E, G, cap) and wc attached)``; a
    single projection has E = 1), E·G tiles in one launch on the
    operands grouped_matmul_fused builds, for each of ``rows_list`` rows
    an expert; with ``bmm``, grouped_bmm_bf16 on the gathered operands of
    the same calls (its TMA route, rows > 64 only); ``fused=False``
    leaves fused_bmm out. Each timed against its plain version and
    torch.bmm on pre-gathered operands."""
    gen = torch.Generator(device=projs[0][1].device).manual_seed(SEED + 11)
    rows = []
    for n_rows in rows_list:
        for name, w, plan in projs:
            e, m, n = w.shape
            _, g, k, nc = plan.wc.shape
            x = torch.randn((e, n_rows, m), generator=gen,
                            device=w.device).to(w.dtype)
            xt, ids = fm_ops.fused_operands(x, plan.row_ids, plan.row_valid)
            wc = plan.wc.view(e * g, k, nc)
            xg = fm_ops.gather_x(x, plan.row_ids, plan.row_valid)
            ops = 2 * e * g * n_rows * k * nc
            it, wu = (10, 2) if n_rows > 64 else (50, 5)
            row = dict(arch=cfg.name, proj=name, experts=e, tiles=e * g,
                       rows=n_rows, m=m, n=n, cap_m=k, cap_n=nc)
            if fused:
                ok, err = _close_tiles(fm_ref.ref_fused_bmm,
                                       fm_ops.fused_bmm(xt, wc, ids),
                                       FUSED_BF16_TOL, xt, wc, ids)
                check(ok, f"fused_bmm == plain at {cfg.name} {name}, {e * g} "
                          f"tiles, {n_rows} rows (max abs err {err})")
                nbytes = 2 * (e * (m + 1) * n_rows + e * g * k * nc
                              + e * g * n_rows * nc) + 4 * e * g * k
                bnd, by = bound_ms(nbytes, ops, BF16_OPS_PER_S)
                row.update(
                    max_abs_err=err,
                    ms=time_ms(lambda: fm_ops.fused_bmm(xt, wc, ids), it, wu),
                    plain_ms=time_ms(lambda: _plain_tiles(
                        fm_ref.ref_fused_bmm, xt, wc, ids), 3, 1),
                    library_ms=time_ms(lambda: torch.bmm(xg, wc), it, wu),
                    library="torch.bmm on pre-gathered operands (gather "
                            "not counted)",
                    bound_ms=bnd, bound_by=by, route=fused_route(n_rows, nc))
                row["tflops"] = ops / row["ms"] / 1e9
                row["bound_share"] = bnd / row["ms"]
            if bmm and n_rows > 64:
                # TMA needs K and N multiples of 8 (mamba2-1.3b's in
                # projection has 2,660 compact columns: wmma)
                route = fm_ops.bmm_bf16_route(n_rows, k, nc, True)
                want = fm_ops.TMA if k % 8 == 0 and nc % 8 == 0 \
                    else fm_ops.WMMA
                check(route == want,
                      f"grouped_bmm_bf16 at {cfg.name} {name} takes the "
                      f"{BMM16_ROUTES[want]} route ({BMM16_ROUTES[route]})")
                ok, berr = _close_tiles(fm_ref.ref_grouped_bmm,
                                        fm_ops.grouped_bmm(xg, wc),
                                        BMM_BF16_TOL, xg, wc)
                check(ok, f"grouped_bmm_bf16 == plain at {cfg.name} {name}, "
                          f"{n_rows} rows (max abs err {berr})")
                bb, bby = bound_ms(2 * (e * g * n_rows * k + e * g * k * nc
                                        + e * g * n_rows * nc), ops,
                                   BF16_OPS_PER_S)
                row["grouped_bmm_bf16"] = dict(
                    max_abs_err=berr, route=BMM16_ROUTES[route],
                    ms=time_ms(lambda: fm_ops.grouped_bmm(xg, wc), it, wu),
                    plain_ms=time_ms(lambda: _plain_tiles(
                        fm_ref.ref_grouped_bmm, xg, wc), 3, 1),
                    library_ms=row.get("library_ms") or time_ms(
                        lambda: torch.bmm(xg, wc), it, wu),
                    bound_ms=bb, bound_by=bby)
                row["grouped_bmm_bf16"]["bound_share"] = \
                    bb / row["grouped_bmm_bf16"]["ms"]
            rows.append(row)
            del x, xt, xg
            torch.cuda.empty_cache()
    return rows


@_timed
def moe_oracle(p, plans, cfg, device) -> dict:
    """One MoE layer's output for MOE_ORACLE_TOKENS tokens through
    ``moe`` (dropless, the plans' compact weights: one fused_bmm launch a
    projection) against plain torch products on the card: routing
    re-derived by ``torch.topk``, and for each token and each of its
    experts the gated FFN on x @ (W_e * [row_group_e[r] ==
    col_group_e[c]]), the mask from that expert's balanced groups, one
    expert at a time."""
    import torch.nn.functional as F
    from repro_torch.models import moe as moe_mod
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    t = MOE_ORACLE_TOKENS
    x = torch.randn((1, t, cfg.d_model), generator=gen,
                    device=device).to(cfg.dtype)
    fl = flgw.FLGWConfig(groups=cfg.flgw_groups, path="grouped")
    before = fm_ops.FUSED.launches
    with torch.inference_mode():
        got, _ = moe_mod.moe(p, x, cfg, flgw=fl, dropless=True, plans=plans)
    torch.cuda.synchronize()
    check(fm_ops.FUSED.launches == before + 3,
          f"{cfg.name}: the MoE layer is 3 fused_bmm launches "
          f"({fm_ops.FUSED.launches - before})")
    xf = x[0]
    with torch.inference_mode():
        probs = torch.softmax(xf.float() @ p["router"], dim=-1)
        top_w, top_e = probs.topk(cfg.top_k, dim=-1)
        top_w = top_w / top_w.sum(-1, keepdim=True)
        want = torch.zeros((t, cfg.d_model), dtype=torch.float32,
                           device=device)
        for e in top_e.unique().tolist():
            tok, slot = (top_e == e).nonzero(as_tuple=True)

            def masked(name):
                pl = plans[name]
                keep = pl.row_group[e][:, None] == pl.col_group[e][None, :]
                return p[name]["w"][e] * keep.to(cfg.dtype)
            xe = xf[tok]
            h = F.gelu(xe @ masked("gate"), approximate="tanh") * (
                xe @ masked("up"))
            ye = h @ masked("down")
            want[tok] += (ye * top_w[tok, slot, None].to(ye.dtype)).float()
    got = got[0].float()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(torch.allclose(got, want, **REPLAY_BF16_TOL)
          and err <= REPLAY_BF16_TOL["rtol"] * scale,
          f"{cfg.name}: the MoE layer == plain masked products on the card "
          f"within {REPLAY_BF16_TOL} and {REPLAY_BF16_TOL['rtol']} of its "
          f"largest value (max abs err {err}, largest {scale})")
    return dict(tokens=t, experts_used=int(top_e.unique().numel()),
                max_abs_err=err, max_abs_value=scale, tol=REPLAY_BF16_TOL)


def _count_forwards():
    """Patch ``transformer.lm_apply`` to count its calls (the serving
    steps reach it through the module); returns (counter, restore)."""
    calls = [0]
    orig = transformer.lm_apply

    def counted(*a, **kw):
        calls[0] += 1
        return orig(*a, **kw)
    transformer.lm_apply = counted

    def restore():
        transformer.lm_apply = orig
    return calls, restore


def run_moe(kernels, device, card: str) -> dict:
    """Phase 13: each MOE_FAMILY config at full width, cut in depth, FLGW
    G=4 grouped, slack 1.25, bf16, ``use_flash``: plan_assign bitwise at
    every side; fused_bmm (and for mixtral grouped_bmm_bf16) at the
    batched expert shapes and flash_fwd at the prefill's, against their
    plain versions; with the counts at 0, a certify session, the prefill
    and a lockstep Engine run (4 requests, prompt 64, gen 32), with exact
    launch counts; mixtral also an ``off``-policy prefill (the gather
    path, grouped_bmm_bf16), a 1-layer CPU replay and a profile; each
    an oracle of its MoE layer against plain products on the card."""
    out = {}
    slack = flgw.FLGWConfig().capacity_slack
    for arch, layers, targets, b, seq in MOE_FAMILY:
        cfg = registry.get_config(arch, n_layers=layers,
                                  flgw_targets=targets, **{
                                      k: v for k, v in SERVE_FLGW.items()
                                      if k != "flgw_targets"})
        t0 = time.perf_counter()
        params = serve_params(cfg, device)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in _leaves(params))
        per_layer = MOE_PROJECTIONS[cfg.pattern[0].ffn]
        sides = check_assign_sides(params, slack)
        check(not sides["tiled"] and len(sides["sort"]) == 2 * per_layer,
              f"{arch}: every side on plan_assign ({len(sides['sort'])})")
        p_moe, moe_plans = _moe_layer(params, cfg)
        kern_rows = check_compact_kernels(
            _expert_projs(p_moe, moe_plans), cfg,
            (b * seq * cfg.top_k, DECODE_ROWS), bmm=arch == "mixtral_8x22b")
        oracle = moe_oracle(p_moe, moe_plans, cfg, device)
        del moe_plans
        torch.cuda.empty_cache()
        windows = sorted({s.window for s in cfg.pattern}, reverse=True)
        flash_rows = check_flash_kernel(cfg, device,
                                        tuple((seq, w) for w in windows), b)
        _print_family_kernels(arch, sides, [], flash_rows)
        for r in kern_rows:
            bm = r.get("grouped_bmm_bf16")
            bm = (f"; grouped_bmm_bf16 {bm['ms']:.4f} ms ({bm['route']}, "
                  f"{bm['bound_share']:.3f} of its bound), plain "
                  f"{bm['plain_ms']:.3f}") if bm else ""
            print(f"  fused_bmm {arch} {r['proj']:>4} {r['tiles']} tiles x "
                  f"{r['rows']} rows K={r['cap_m']} N={r['cap_n']}: "
                  f"{r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s, "
                  f"{r['bound_share']:.3f} of the bound, {r['route']}), "
                  f"plain {r['plain_ms']:.3f}, bmm {r['library_ms']:.4f}, "
                  f"bound {r['bound_ms']:.4f} ({r['bound_by']}){bm}",
                  flush=True)
        print(f"  oracle {arch}: the MoE layer on {oracle['tokens']} tokens "
              f"({oracle['experts_used']} experts) == plain masked products "
              f"on the card, max abs err {oracle['max_abs_err']:.3g} (largest "
              f"{oracle['max_abs_value']:.3g})", flush=True)

        calls, restore = _count_forwards()
        try:
            sv = run_serve(cfg, params, kernels, seq=seq, continuous=False,
                           batch=b)
        finally:
            restore()
        session = sv.pop("session")
        inputs, certify_logits = sv.pop("inputs"), sv.pop("logits")
        lc, enc = sv["launches"], sv["encodes"]
        check(lc["plan_assign"] == 2 * per_layer * enc and enc >= 1,
              f"{arch}: plan_assign exactly {2 * per_layer} an encode "
              f"({enc} encodes; {lc})")
        check(lc["fused_bmm"] == per_layer * layers * calls[0],
              f"{arch}: fused_bmm exactly {per_layer} a layer and forward "
              f"({layers} layers, {calls[0]} forwards; {lc})")
        res = dict(layers=layers, targets=targets, batch=b, seq=seq,
                   params=n_params, init_s=init_s, assign=sides,
                   kernel_rows=kern_rows, flash_rows=flash_rows,
                   oracle=oracle, serve=sv, forwards=calls[0],
                   dropless_rows_per_expert=b * seq * cfg.top_k,
                   mean_rows_per_expert=b * seq * cfg.top_k / cfg.n_experts)
        lk = sv["lockstep"]
        print(f"phase 13 {arch} ({layers} layers, {n_params:,} params) on "
              f"{card}: launches {lc} over {calls[0]} forwards; prefill "
              f"B={b} x S={seq} {sv['prefill_ms']:.1f} ms "
              f"({sv['prefill_tokens_per_s']:.0f} tokens/s; dropless "
              f"{res['dropless_rows_per_expert']} rows an expert against a "
              f"mean load of {res['mean_rows_per_expert']:.0f}); lockstep "
              f"{lk['tokens_per_s']:.1f} tokens/s, p50 {lk['p50_s']:.3f} s",
              flush=True)
        if arch == "mixtral_8x22b":
            plan_cache.clear()
            _zero(kernels)
            off = ServeSession(cfg, params, plan_policy="off")
            with torch.inference_mode():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                off_logits = off.prefill(inputs)
                torch.cuda.synchronize()
            off_ms = (time.perf_counter() - t0) * 1e3
            lo = _launches(kernels)
            check(lo["grouped_bmm_bf16"] == per_layer * layers
                  and lo["fused_bmm"] == 0
                  and lo["plan_assign"] == 2 * per_layer * layers,
                  f"{arch} off-policy prefill: grouped_bmm_bf16 exactly "
                  f"{per_layer} a layer, an encode a projection, no "
                  f"fused_bmm ({lo})")
            oerr = float((off_logits - certify_logits).abs().max())
            check(torch.allclose(off_logits, certify_logits,
                                 **REPLAY_BF16_TOL),
                  f"{arch}: the off-policy prefill's logits within "
                  f"{REPLAY_BF16_TOL} of the certify prefill's (max abs err "
                  f"{oerr})")
            res["off_policy"] = dict(launches=lo, ms=off_ms,
                                     max_abs_err=oerr)
            del off
            rp = cpu_replay(
                cfg, params, blocks=1, seq=MOE_REPLAY_SEQ,
                steps=MOE_REPLAY_STEPS, then=lambda rp, arch=arch: print(
                    f"  phase 13 {arch}: CPU replay (1 layer): max abs err "
                    f"{rp['max_abs_err']}, {rp['equal_tokens']}/"
                    f"{MOE_REPLAY_STEPS} greedy tokens equal", flush=True))
            res["replay"] = rp
            prof = profile_serve(session, cfg, seq, MOE_KERNELS)
            print_profile(f"{arch} prefill + 8 decode steps", prof)
            check_flash_routes(prof, f"the {arch} serve profile",
                               ("flash_fwd",))
            check_fused_routes(prof)
            res["profile"] = prof
            print(f"  {arch} off-policy prefill {off_ms:.1f} ms, launches "
                  f"{lo}, logits max abs err {oerr:.3g}", flush=True)
        out[arch] = res
        del session, params, p_moe, inputs, certify_logits
        plan_cache.clear()
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 14: the SSM and hybrid families, and the grouped MoE trained
# ---------------------------------------------------------------------------

SSM_SEQ = 1024
MAMBA_TARGETS = ("ssm",)
MAMBA_PROJECTIONS = 2         # a Mamba2 layer's compact products: in, out
MAMBA_REPLAY_BLOCKS = 2       # 2 layers replayed on the CPU
MAMBA_LAYERS = 12             # of 48: the script's time limit
SSM_TRAIN_BATCH = 4
# jamba-1.5-large cut in depth to slots 0-1 of its 8-slot period (attention
# + MLP, SSM + MoE: every kind of slot it has); one period is ~44 B params
JAMBA_SLOTS = 2
JAMBA_TARGETS = ("ssm", "moe", "mlp", "attn")
JAMBA_BATCH = 2
# compact projections of the cut (q, k, v, o, the MLP's 3; ssm in, out,
# the experts' 3, one launch each) and its grouping sides past the sort
# route's limit: the MLP's up/gate columns and down rows (24,576), the
# experts' the same (L = 16), ssm in's columns (33,152)
JAMBA_PROJECTIONS = 12
JAMBA_TILED_SIDES = 7
JAMBA_ORACLE_TOKENS = 64
MOE_TRAIN = ("mixtral_8x22b", 1, ("moe",), 2)   # arch, layers, targets, B
SSD_SPAN = "ssd_scan"
MAMBA_KERNELS = {"fused_bmm": "fused_bmm", "plan_assign": "plan_assign_kernel"}


def _ssm_cfg(arch: str, targets, **kw):
    return registry.get_config(arch, flgw_targets=targets, **{
        k: v for k, v in SERVE_FLGW.items() if k != "flgw_targets"}, **kw)


def _block_projs(params, plans, names, stack: str = "blocks"):
    """``(label, w (1, M, N) or (E, M, N), plan)`` of block 0's FLGW
    projections at ``names`` (paths of (slot, part, name)) in ``stack``
    (the decoder's ``blocks`` or an ``encoder``, whose labels it
    prefixes); a single projection gets a leading axis of 1."""
    blk = transformer._index(params[stack], 0)
    bpl = transformer._index(plans[stack], 0)
    out = []
    for path in names:
        p, pl = blk, bpl
        for key in path:
            p, pl = p[key], pl[key]
        w = p["w"]
        if w.dim() == 2:
            w, pl = w[None], grouped.GroupPlan(*(t[None] for t in pl))
        label = "/".join(path if stack == "blocks" else (stack, *path))
        out.append((label, w, pl))
    return out


def time_ssd_scan(cfg, b: int, s: int, device) -> dict:
    """One layer's SSD scan (``models.ssm._ssd_chunked``) at a B x S
    prefill's shapes, by CUDA events: it is plain PyTorch, as it is XLA
    einsums in the JAX package."""
    from repro_torch.models import ssm as ssm_mod
    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    xh = torch.randn((b, s, h, p), generator=gen, device=device).to(cfg.dtype)
    bm, cm = (torch.randn((b, s, n), generator=gen, device=device)
              for _ in range(2))
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=gen, device=device))
    a_neg = -torch.linspace(1.0, 16.0, h, device=device)
    chunk = min(cfg.ssm_chunk, s)
    with torch.inference_mode():
        y = ssm_mod._ssd_chunked(xh, bm, cm, dt, a_neg, chunk)
        check(bool(torch.isfinite(y).all()), "SSD scan output finite")
        ms = time_ms(lambda: ssm_mod._ssd_chunked(xh, bm, cm, dt, a_neg,
                                                  chunk), 10, 2)
    return dict(b=b, s=s, heads=h, head_dim=p, state=n, chunk=chunk, ms=ms)


def profile_ssd_prefill(session, inputs, names) -> dict:
    """The profiler over one prefill with each SSD scan inside a
    ``record_function`` span (SSD_SPAN): device busy time, the device
    time of the kernels the spans' ops launched (the scan's), and each
    of ``names``."""
    from torch.profiler import record_function
    from repro_torch.models import ssm as ssm_mod
    orig = ssm_mod._ssd_chunked

    def traced(*a, **kw):
        with record_function(SSD_SPAN):
            return orig(*a, **kw)
    ssm_mod._ssd_chunked = traced
    try:
        session.prefill(inputs)
        return profile(lambda: session.prefill(inputs), names, (SSD_SPAN,))
    finally:
        ssm_mod._ssd_chunked = orig


def _train_launches(launches: dict, what: str, sides: int, bmm: int,
                    steps: int) -> None:
    """A grouped training path's launches, exactly: ``sides``
    plan_assign launches an encode (one at init and one a step),
    ``bmm`` grouped_bmm_bf16 launches a step (its projections' forward
    and remat replay), nothing else."""
    check(launches["plan_assign"] == sides * (steps + 1),
          f"{what}: plan_assign exactly {sides} an encode, {steps + 1} "
          f"encodes ({launches})")
    check(launches["grouped_bmm_bf16"] == bmm * steps,
          f"{what}: grouped_bmm_bf16 exactly {bmm} a step ({launches})")
    check_sort_route(launches, what)
    for name in ("fused_bmm", "grouped_bmm_f32", "flash_fwd", "flash_bwd_dq",
                 "flash_bwd_dkv", "osel_encode"):
        check(launches[name] == 0, f"{name} not launched on {what}")


@_timed
def run_lm_train(kernels, device, arch: str, targets, batch: int,
                 layers: Optional[int] = None) -> tuple:
    """``train_lm`` at full width (cut to ``layers``), FLGW G=4 grouped
    on ``targets``, AdamW, remat, TRAIN_STEPS steps of B=``batch`` x
    S=SSM_SEQ, with the launch counts at 0 first. Returns (record, the
    trained state)."""
    torch.cuda.reset_peak_memory_stats(device)
    _zero(kernels)
    state, hist = train_lm(arch, smoke=False, steps=TRAIN_STEPS, batch=batch,
                           seq=SSM_SEQ, log_every=1, seed=SEED, device=device,
                           flgw_targets=targets, n_layers=layers,
                           **TRAIN_FLGW)
    torch.cuda.synchronize()
    out = dict(loss=[float(h["loss"]) for h in hist],
               grad_norm=[float(h["grad_norm"]) for h in hist],
               step_s=[h["step_s"] for h in hist], launches=_launches(kernels),
               peak_gb=torch.cuda.max_memory_allocated(device) / 1e9)
    check(all(np.isfinite(out["loss"])) and all(np.isfinite(out["grad_norm"])),
          f"{arch} training: every loss and grad norm finite ({out})")
    out["step_ms"] = statistics.median(out["step_s"][1:]) * 1e3
    out["tokens_per_s"] = batch * SSM_SEQ / (out["step_ms"] / 1e3)
    return out, state


def run_mamba2(kernels, device, card: str) -> dict:
    """mamba2-1.3b at full width, MAMBA_LAYERS of 48, FLGW G=4 grouped
    on ``"ssm"`` (its in and out projections): plan_assign bitwise at
    every side, fused_bmm at a layer's 2 projections and grouped_bmm_bf16
    at their training products; with the counts at 0, a certify session,
    a B=4 x S=1,024 prefill, a lockstep and a continuous Engine run
    (continuous admission recycles slots through ``reset_slots``, which
    zeroes their SSM state) with exact launches; a 2-layer CPU replay; a
    profile of the prefill (the SSD scan's share of device time); then
    3 training steps."""
    cfg = _ssm_cfg("mamba2_1_3b", MAMBA_TARGETS, n_layers=MAMBA_LAYERS)
    slack = flgw.FLGWConfig().capacity_slack
    params = serve_params(cfg, device)
    n_params = sum(t.numel() for t in _leaves(params))
    sides = check_assign_sides(params, slack)
    check(not sides["tiled"] and len(sides["sort"]) == 2 * MAMBA_PROJECTIONS,
          f"mamba2: every side on plan_assign ({len(sides['sort'])})")
    with torch.inference_mode():
        state = planenc.attach_compact(transformer.encode_plans(params, cfg),
                                       params)
    projs = _block_projs(params, state.plans,
                         [("slot0", "mixer", "in"), ("slot0", "mixer", "out")])
    kern_rows = check_compact_kernels(
        projs, cfg, (SERVE_BATCH * SSM_SEQ, SERVE_BATCH), bmm=False)
    train_rows = check_compact_kernels(
        projs, cfg, (SSM_TRAIN_BATCH * SSM_SEQ,), bmm=True, fused=False)
    del state, projs
    torch.cuda.empty_cache()
    _print_family_kernels("mamba2_1_3b", sides, [], [])
    _print_compact_rows("mamba2_1_3b", kern_rows + train_rows)

    calls, restore = _count_forwards()
    try:
        sv = run_serve(cfg, params, kernels, seq=SSM_SEQ, continuous=True,
                       need=("plan_assign", "fused_bmm"))
    finally:
        restore()
    session = sv.pop("session")
    inputs = sv.pop("inputs")
    del sv["logits"]
    lc, enc = sv["launches"], sv["encodes"]
    check(lc["plan_assign"] == 2 * MAMBA_PROJECTIONS * enc,
          f"mamba2: plan_assign exactly {2 * MAMBA_PROJECTIONS} an encode "
          f"({enc} encodes; {lc})")
    check(lc["fused_bmm"] == MAMBA_PROJECTIONS * cfg.n_layers * calls[0],
          f"mamba2: fused_bmm exactly {MAMBA_PROJECTIONS} a layer and "
          f"forward ({cfg.n_layers} layers, {calls[0]} forwards; {lc})")
    check(lc["flash_fwd"] == 0, f"mamba2: no flash_fwd ({lc})")
    def replayed(rp):
        check(rp["equal_tokens"] == REPLAY_STEPS,
              f"mamba2 CPU replay: every greedy token equal ({rp})")
        print(f"  phase 14 mamba2_1_3b: CPU replay ({rp['layers']} layers) "
              f"max abs err {rp['max_abs_err']}, {rp['equal_tokens']}/"
              f"{REPLAY_STEPS} greedy tokens equal", flush=True)
    rp = cpu_replay(cfg, params, blocks=MAMBA_REPLAY_BLOCKS, seq=REPLAY_SEQ,
                    steps=REPLAY_STEPS, then=replayed)
    scan = time_ssd_scan(cfg, SERVE_BATCH, SSM_SEQ, device)
    prof = profile_ssd_prefill(session, inputs, MAMBA_KERNELS)
    lk, ct = sv["lockstep"], sv["continuous"]
    print(f"phase 14 mamba2_1_3b ({cfg.n_layers} layers, {n_params:,} params) "
          f"on {card}: launches {lc} over {calls[0]} forwards; prefill "
          f"B={SERVE_BATCH} x S={SSM_SEQ} {sv['prefill_ms']:.1f} ms "
          f"({sv['prefill_tokens_per_s']:.0f} tokens/s); lockstep "
          f"{lk['tokens_per_s']:.1f} tokens/s, p50 {lk['p50_s']:.3f} s; "
          f"continuous {ct['tokens_per_s']:.1f} tokens/s, p50 "
          f"{ct['p50_s']:.3f} s", flush=True)
    print(f"  SSD scan: {scan['ms']:.3f} ms a layer at B={SERVE_BATCH} x "
          f"S={SSM_SEQ} (x {cfg.n_layers} layers = "
          f"{scan['ms'] * cfg.n_layers:.1f} ms); prefill profile: busy "
          f"{prof['device_busy_us'] / 1e3:.1f} of {prof['wall_us'] / 1e3:.1f}"
          f" ms, the SSD spans' kernels {prof['spans'][SSD_SPAN]} us, "
          f"fused_bmm {prof['kernels']['fused_bmm']['device_us_total']:.0f} "
          "us", flush=True)
    del session, inputs, params
    plan_cache.clear()
    gc.collect()
    torch.cuda.empty_cache()

    tr, state = run_lm_train(kernels, device, "mamba2_1_3b", MAMBA_TARGETS,
                             SSM_TRAIN_BATCH, MAMBA_LAYERS)
    # the 2 projections a layer, in the forward and its remat replay
    _train_launches(tr["launches"], "mamba2 training",
                    2 * MAMBA_PROJECTIONS, 2 * MAMBA_PROJECTIONS
                    * cfg.n_layers, TRAIN_STEPS)
    print(f"  mamba2 training (B={SSM_TRAIN_BATCH} x S={SSM_SEQ}, "
          f"{TRAIN_STEPS} steps): {tr['step_ms']:.1f} ms/step "
          f"({tr['tokens_per_s']:.0f} tokens/s), losses {tr['loss']}, peak "
          f"{tr['peak_gb']:.1f} GB; launches {tr['launches']}", flush=True)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return dict(layers=cfg.n_layers, params=n_params, assign=sides,
                kernel_rows=kern_rows, train_rows=train_rows, serve=sv,
                forwards=calls[0], replay=rp, ssd_scan=scan, profile=prof,
                train=tr)


def _masked_dense(p, plans):
    """A slot's params on the plain path: each FLGW projection's W times
    the mask of its plan's balanced groups (``row_group[r] ==
    col_group[c]``, expert by expert), its IG/OG dropped."""
    if "ig" in p:
        keep = plans.row_group[..., :, None] == plans.col_group[..., None, :]
        return {"w": torch.where(keep, p["w"], 0)}
    return {k: (_masked_dense(v, plans.get(k) if isinstance(plans, dict)
                              else None) if isinstance(v, dict) else v)
            for k, v in p.items()}


@_timed
def jamba_oracle(params, plans, cfg, device) -> list[dict]:
    """The cut's 2 layers on JAMBA_ORACLE_TOKENS tokens, layer by layer
    from the same input: ``_slot_apply`` on the grouped path (the plans'
    compact weights, fused_bmm) against the plain path with each weight
    masked by its plan's balanced groups, on the card (a CPU replay would
    need ~60 GB of host memory). Dropless MoE on both."""
    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    t = JAMBA_ORACLE_TOKENS
    h = torch.randn((1, t, cfg.d_model), generator=gen,
                    device=device).to(cfg.dtype)
    pos = torch.arange(t, device=device)[None]
    dense = cfg.with_updates(flgw_groups=1)
    blocks = transformer._index(params["blocks"], 0)
    bplans = transformer._index(plans.plans["blocks"], 0)
    out = []
    for j, slot in enumerate(cfg.pattern):
        name = f"slot{j}"
        with torch.inference_mode():
            got, _ = transformer._slot_apply(blocks[name], h, pos, cfg, slot,
                                             moe_dropless=True,
                                             plans=bplans[name])
            plain = _masked_dense(blocks[name], bplans[name])
            want, _ = transformer._slot_apply(plain, h, pos, dense, slot,
                                              moe_dropless=True)
            del plain
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        check(torch.allclose(got.float(), want.float(), **REPLAY_BF16_TOL)
              and err <= REPLAY_BF16_TOL["rtol"] * scale,
              f"jamba {name} ({slot.mixer} + {slot.ffn}) == plain masked "
              f"products on the card within {REPLAY_BF16_TOL} and "
              f"{REPLAY_BF16_TOL['rtol']} of its largest value (max abs err "
              f"{err}, largest {scale})")
        out.append(dict(slot=name, mixer=slot.mixer, ffn=slot.ffn, tokens=t,
                        max_abs_err=err, max_abs_value=scale))
        h = got
        torch.cuda.empty_cache()
    return out


def run_jamba(kernels, device, card: str) -> dict:
    """jamba-1.5-large at full width, cut to slots 0-1 of its period,
    FLGW G=4 grouped on ssm, moe, mlp and attn, ``use_flash``: plan_assign
    bitwise at its 17 sides on the sort route, plan_rank + plan_place at
    its 7 wide sides; fused_bmm at the cut's 12 projections for a B=2 x
    S=1,024 prefill's rows (the experts' dropless 4,096) and a decode
    step's; flash_fwd at the prefill's shapes; with the counts at 0, a
    certify session, the prefill and a lockstep Engine run with exact
    launches; each layer held against plain masked products on the
    card."""
    full = registry.get_config("jamba_1_5_large")
    cfg = _ssm_cfg("jamba_1_5_large", JAMBA_TARGETS,
                   pattern=full.pattern[:JAMBA_SLOTS], n_layers=JAMBA_SLOTS)
    slack = flgw.FLGWConfig().capacity_slack
    t0 = time.perf_counter()
    params = serve_params(cfg, device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    sides = check_assign_sides(params, slack)
    check(len(sides["tiled"]) == JAMBA_TILED_SIDES
          and len(sides["sort"]) == 2 * JAMBA_PROJECTIONS - JAMBA_TILED_SIDES,
          f"jamba: {JAMBA_TILED_SIDES} sides past the sort route "
          f"({len(sides['tiled'])}), the rest on plan_assign "
          f"({len(sides['sort'])})")
    with torch.inference_mode():
        state = planenc.attach_compact(transformer.encode_plans(params, cfg),
                                       params)
    dense = _block_projs(params, state.plans, [
        *(("slot0", "mixer", n) for n in "qkvo"),
        *(("slot0", "ffn", n) for n in ("up", "gate", "down")),
        ("slot1", "mixer", "in"), ("slot1", "mixer", "out")])
    experts = _block_projs(params, state.plans, [
        ("slot1", "moe", n) for n in ("up", "gate", "down")])
    rows_b = JAMBA_BATCH * SSM_SEQ
    kern_rows = (check_compact_kernels(dense, cfg, (rows_b, SERVE_BATCH),
                                       bmm=False)
                 + check_compact_kernels(experts, cfg,
                                         (rows_b * cfg.top_k, DECODE_ROWS),
                                         bmm=False))
    del state, dense, experts
    torch.cuda.empty_cache()
    flash_rows = check_flash_kernel(cfg, device, ((SSM_SEQ, 0),), JAMBA_BATCH)
    _print_family_kernels("jamba_1_5_large", sides, [], flash_rows)
    _print_compact_rows("jamba_1_5_large", kern_rows)

    calls, restore = _count_forwards()
    try:
        sv = run_serve(cfg, params, kernels, seq=SSM_SEQ, continuous=False,
                       tiled_sides=JAMBA_TILED_SIDES, batch=JAMBA_BATCH)
    finally:
        restore()
    session = sv.pop("session")
    del sv["inputs"], sv["logits"]
    lc, enc = sv["launches"], sv["encodes"]
    sort_sides = 2 * JAMBA_PROJECTIONS - JAMBA_TILED_SIDES
    check(lc["plan_assign"] == sort_sides * enc,
          f"jamba: plan_assign exactly {sort_sides} an encode ({enc} "
          f"encodes; {lc})")
    check(lc["fused_bmm"] == JAMBA_PROJECTIONS * calls[0],
          f"jamba: fused_bmm exactly {JAMBA_PROJECTIONS} a forward "
          f"({calls[0]} forwards; {lc})")
    prefills = len(sv["prefill_s"])
    check(lc["flash_fwd"] == prefills,
          f"jamba: flash_fwd exactly 1 a prefill forward ({prefills} "
          f"prefills; {lc})")
    oracle = jamba_oracle(params, session.plans and session._attach(
        session.plans), cfg, device)
    lk = sv["lockstep"]
    print(f"phase 14 jamba_1_5_large (slots 0-1, {n_params:,} params) on "
          f"{card}: launches {lc} over {calls[0]} forwards; prefill "
          f"B={JAMBA_BATCH} x S={SSM_SEQ} {sv['prefill_ms']:.1f} ms "
          f"({sv['prefill_tokens_per_s']:.0f} tokens/s; dropless "
          f"{rows_b * cfg.top_k} rows an expert); lockstep "
          f"{lk['tokens_per_s']:.1f} tokens/s, p50 {lk['p50_s']:.3f} s; "
          f"oracle max abs err {[round(o['max_abs_err'], 4) for o in oracle]}"
          f" (largest {[round(o['max_abs_value'], 3) for o in oracle]})",
          flush=True)
    del session, params
    plan_cache.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return dict(slots=JAMBA_SLOTS, batch=JAMBA_BATCH, seq=SSM_SEQ,
                params=n_params, init_s=init_s, assign=sides,
                kernel_rows=kern_rows, flash_rows=flash_rows, serve=sv,
                forwards=calls[0], oracle=oracle,
                dropless_rows_per_expert=rows_b * cfg.top_k)


def _print_compact_rows(arch, rows) -> None:
    for r in rows:
        bm = r.get("grouped_bmm_bf16")
        bm = (f"grouped_bmm_bf16 {bm['ms']:.4f} ms ({bm['route']}, "
              f"{bm['bound_share']:.3f} of its bound {bm['bound_ms']:.4f}), "
              f"plain {bm['plain_ms']:.3f}, bmm {bm['library_ms']:.4f}"
              ) if bm else ""
        fb = (f"fused_bmm {r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s, "
              f"{r['bound_share']:.3f} of the bound {r['bound_ms']:.4f}, "
              f"{r['route']}), plain {r['plain_ms']:.3f}, bmm "
              f"{r['library_ms']:.4f}; ") if "ms" in r else ""
        print(f"  {arch} {r['proj']} {r['tiles']} tiles x {r['rows']} rows "
              f"K={r['cap_m']} N={r['cap_n']}: {fb}{bm}", flush=True)


def backward_over_experts(p, plans, xs) -> list[dict]:
    """The expert-axis backward (dx, dW, dIG, dOG of every expert at once)
    against the 2-D backward run expert by expert, on the card, at each
    expert projection with its inputs ``xs`` (captured from a training
    step's dispatch) and a random output gradient. Both are the same
    ``torch.bmm`` products and scatters; cuBLAS may pick other algorithms
    for E·G tiles than for G, so each is held within 1e-2 of its largest
    value and its bitwise agreement recorded."""
    gen = torch.Generator(device=p["router"].device).manual_seed(SEED + 15)
    out = []
    with torch.no_grad():
        for name in ("up", "gate", "down"):
            w, ig, og = p[name]["w"], p[name]["ig"], p[name]["og"]
            x, pl = xs[name], plans[name]
            gy = torch.randn((*x.shape[:2], w.shape[-1]), generator=gen,
                             device=w.device).to(w.dtype)
            got = grouped._grouped_bwd(x, w, ig, og, pl, 1.0, gy)
            errs, scales, same = [0.0] * 4, [0.0] * 4, True
            for e in range(w.shape[0]):
                one = grouped.GroupPlan(*(t[e] for t in pl[:6]))
                want = grouped._grouped_bwd(x[e], w[e], ig[e], og[e], one,
                                            1.0, gy[e])
                for i, (a, b) in enumerate(zip(got, want)):
                    errs[i] = max(errs[i], float((a[e].float() - b.float())
                                                 .abs().max()))
                    scales[i] = max(scales[i], float(b.float().abs().max()))
                    same &= bool(torch.equal(a[e], b))
                del want
            for what, err, scale in zip(("dx", "dW", "dIG", "dOG"), errs,
                                        scales):
                check(err <= 1e-2 * scale,
                      f"mixtral {name}: the expert-axis {what} == the 2-D "
                      f"backward expert by expert within 1e-2 of its largest "
                      f"value (max abs err {err}, largest {scale})")
            out.append(dict(proj=name, experts=w.shape[0], rows=x.shape[1],
                            max_abs_err=dict(zip(("dx", "dW", "dIG", "dOG"),
                                                 errs)),
                            max_abs_value=dict(zip(("dx", "dW", "dIG", "dOG"),
                                                   scales)),
                            bitwise=same))
            del got, gy
            torch.cuda.empty_cache()
    return out


def run_moe_train(kernels, device, card: str) -> dict:
    """mixtral-8x22b at full width, 1 of 56 layers, FLGW G=4 grouped on
    the experts: grouped_bmm_bf16 at the training dispatch's expert
    shapes against its plain version; with the counts at 0, 3 training
    steps of B=2 x S=1,024 (the grouped backward over the expert axis);
    then on a step's batch the expert-axis backward against the 2-D one
    expert by expert."""
    from repro_torch.models import moe as moe_mod
    arch, layers, targets, b = MOE_TRAIN
    cfg = registry.get_config(arch, n_layers=layers, flgw_targets=targets,
                              **TRAIN_FLGW)
    cap = moe_mod.capacity(b * SSM_SEQ, cfg, False)
    params = serve_params(cfg, device)
    p_moe = transformer._index(params["blocks"], 0)["slot0"]["moe"]
    fl = flgw.FLGWConfig(groups=cfg.flgw_groups, path="grouped")
    with torch.inference_mode():
        plans = grouped.attach_compact(grouped.encode_plans(p_moe, fl), p_moe)
    kern_rows = check_compact_kernels(_expert_projs(p_moe, plans), cfg,
                                      (cap,), bmm=True, fused=False)
    del params, p_moe, plans
    torch.cuda.empty_cache()
    _print_compact_rows(arch, kern_rows)

    tr, state = run_lm_train(kernels, device, arch, targets, b, layers)
    # the 3 expert projections, in the forward and its remat replay
    _train_launches(tr["launches"], f"{arch} grouped MoE training",
                    2 * 3 * layers, 2 * 3 * layers, TRAIN_STEPS)

    # the dispatch's activations of a step's batch, for each projection
    xs = {}
    orig = moe_mod._expert_ffn

    def capture(p, xe, flgw_cfg, plans=None):
        xs["up"] = xs["gate"] = xe
        return orig(p, xe, flgw_cfg, plans)
    ds = SyntheticTokens(cfg.vocab, b, SSM_SEQ, seed=SEED)
    batch = ds.tensors_at(0, device)
    moe_mod._expert_ffn = capture
    try:
        with torch.no_grad():
            transformer.lm_apply(state.params, cfg, batch["tokens"],
                                 batch["positions"], return_hidden=True,
                                 plans=state.plans)
    finally:
        moe_mod._expert_ffn = orig
    p_moe = transformer._index(state.params["blocks"], 0)["slot0"]["moe"]
    bplans = transformer._index(state.plans.plans["blocks"], 0)["slot0"]["moe"]
    fl = flgw.FLGWConfig(groups=cfg.flgw_groups, path="grouped")
    with torch.no_grad():
        up = flgw.flgw_linear(xs["up"], p_moe["up"]["w"], p_moe["up"]["ig"],
                              p_moe["up"]["og"], fl, plan=bplans["up"])
        gate = flgw.flgw_linear(xs["up"], p_moe["gate"]["w"],
                                p_moe["gate"]["ig"], p_moe["gate"]["og"], fl,
                                plan=bplans["gate"])
        xs["down"] = torch.nn.functional.gelu(gate, approximate="tanh") * up
        del up, gate
    bwd = backward_over_experts(p_moe, bplans, xs)
    print(f"phase 14 {arch} grouped MoE training ({layers} layer, "
          f"B={b} x S={SSM_SEQ}, {cap} rows an expert) on {card}: "
          f"{tr['step_ms']:.1f} ms/step ({tr['tokens_per_s']:.0f} tokens/s), "
          f"losses {tr['loss']}, peak {tr['peak_gb']:.1f} GB; launches "
          f"{tr['launches']}; expert-axis backward vs 2-D: "
          + ", ".join(f"{r['proj']} {r['max_abs_err']} "
                      f"(bitwise {r['bitwise']})" for r in bwd), flush=True)
    del state, xs, p_moe, bplans
    gc.collect()
    torch.cuda.empty_cache()
    return dict(layers=layers, batch=b, seq=SSM_SEQ, rows_per_expert=cap,
                kernel_rows=kern_rows, train=tr, backward=bwd)


def run_ssm_family(kernels, device, card: str) -> dict:
    """Phase 14: mamba2-1.3b served and trained, jamba-1.5-large (slots
    0-1) served, mixtral-8x22b's grouped MoE trained."""
    return {"mamba2_1_3b": run_mamba2(kernels, device, card),
            "jamba_1_5_large": run_jamba(kernels, device, card),
            "mixtral_8x22b_train": run_moe_train(kernels, device, card)}


def ssm_launches(fam, sym: str) -> dict:
    """One kernel's launches on each path of phase 14."""
    return {"mamba2_1_3b_serve": fam["mamba2_1_3b"]["serve"]["launches"][sym],
            "mamba2_1_3b_train":
                fam["mamba2_1_3b"]["train"]["launches"][sym],
            "jamba_1_5_large_serve":
                fam["jamba_1_5_large"]["serve"]["launches"][sym],
            "mixtral_8x22b_grouped_train":
                fam["mixtral_8x22b_train"]["train"]["launches"][sym]}


def moe_launches(moe, sym: str) -> dict:
    """One kernel's launches on each path of phase 13."""
    out = {}
    for arch, r in moe.items():
        out[f"{arch}_serve"] = r["serve"]["launches"][sym]
        if "off_policy" in r:
            out[f"{arch}_off_policy_prefill"] = \
                r["off_policy"]["launches"][sym]
    return out


def family_launches(fam, pre, band, sync, sym: str) -> dict:
    """One kernel's launches on each path of phases 10-12."""
    return {**{f"{arch}_serve": fam[arch]["serve"]["launches"][sym]
               for arch in fam},
            "paligemma_3b_prefix": pre["launches"][sym],
            "gemma3_12b_banded": band["banded"]["launches"][sym],
            "gemma3_12b_unbanded": band["unbanded"]["launches"][sym],
            "ic3net_sync_launcher": sync["launches"][sym]}


def family_kernel_rows(fam, pre) -> dict:
    """The kernels line's rows of phases 10-11: plan_assign at each timed
    side, plan_rank/plan_place at gemma2-27b's timed d_ff sides,
    flash_fwd at each config's prefill shapes, fused_bmm at each config's
    down projection (the largest K)."""
    keys = ("side", "layers", "items", "axis", "ms", "device_us", "plain_ms",
            "bound_ms")
    assign = [(a, f["assign"]) for a, f in fam.items()] + [
        ("paligemma_3b", pre["assign"])]
    return dict(
        sort=[dict(arch=a, **{k: r[k] for k in keys}) for a, sides in assign
              for r in sides["sort"] if "ms" in r],
        tiled=[r for r in fam["gemma2_27b"]["assign"]["tiled"]
               if "rank" in r],
        flash=[dict(arch=a, **{k: r[k] for k in (
            "hq", "hkv", "d", "s", "window", "softcap", "max_abs_err", "ms",
            "plain_ms", "library_ms", "bound_ms", "bound_by", "bound_share",
            "tflops", "route")}) for a, f in fam.items()
            for r in f["flash_rows"]],
        fused_down=[dict(arch=a, **{k: r.get(k) for k in (
            "proj", "rows", "cap_m", "cap_n", "max_abs_err", "ms", "ms_cold",
            "plain_ms", "library_ms", "bound_ms", "bound_by", "bound_share",
            "route")}) for a, f in [*fam.items(), ("paligemma_3b", pre)]
            for r in f["fused_rows"] if r["proj"] == "down"])


# ---------------------------------------------------------------------------
# whisper-large-v3: the encoder stack and cross-attention
# ---------------------------------------------------------------------------

WHISPER = "whisper_large_v3"
WHISPER_SEQ = 448             # whisper's published decoder context
WHISPER_PROMPT, WHISPER_GEN = 16, 16     # the lockstep Engine run
WHISPER_DECODE_STEPS = 16     # session.decode steps after the frames step
# compact projections a layer: the encoder's q, k, v, o, up, down; the
# decoder's self-attention q, k, v, o, cross-attention q, k, v, o, up,
# down (the MLP is not gated)
WHISPER_ENC_PROJS, WHISPER_DEC_PROJS = 6, 10
WHISPER_REPLAY_BLOCKS, WHISPER_REPLAY_SEQ = 2, 64     # 2 + 2 layers, B=1
WHISPER_PROFILE_STEPS = 8
WHISPER_SPANS = ("encoder attention core", "cross attention core",
                 "cross k/v projection")


def _whisper_frames(cfg, b: int, device, seed: int) -> torch.Tensor:
    """Stub frame embeddings (b, num_frames, d_model) in ``cfg.dtype``
    from a seeded generator: the front end the JAX package stubs too."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((b, cfg.num_frames, cfg.d_model), generator=gen,
                       device=device).to(cfg.dtype)


@contextlib.contextmanager
def whisper_spans():
    """Each attention core (``models.attention._attend``) of the encoder's
    self-attention and of the cross-attention, and each cross layer's k
    and v projections of the encoder output, inside a ``record_function``
    span named by WHISPER_SPANS."""
    from torch.profiler import record_function
    from repro_torch.models import attention as attn_mod
    orig = (attn_mod.attention, attn_mod._attend, attn_mod.proj)
    cur = {"span": None, "kv_x": None}

    def attention(p, x, positions, cfg, **kw):
        kv_x = kw.get("kv_x")
        cur["kv_x"] = kv_x
        cur["span"] = (WHISPER_SPANS[1] if kv_x is not None else
                       None if kw.get("causal", True) else WHISPER_SPANS[0])
        try:
            return orig[0](p, x, positions, cfg, **kw)
        finally:
            cur["span"] = cur["kv_x"] = None

    def attend(*a, **kw):
        if cur["span"] is None:
            return orig[1](*a, **kw)
        with record_function(cur["span"]):
            return orig[1](*a, **kw)

    def proj(p, x, *a, **kw):
        if cur["kv_x"] is None or x is not cur["kv_x"]:
            return orig[2](p, x, *a, **kw)
        with record_function(WHISPER_SPANS[2]):
            return orig[2](p, x, *a, **kw)
    attn_mod.attention, attn_mod._attend, attn_mod.proj = \
        attention, attend, proj
    try:
        yield
    finally:
        attn_mod.attention, attn_mod._attend, attn_mod.proj = orig


def _fused_share(prof) -> float:
    k = prof["kernels"]
    us = sum(k[f"fused_bmm {r}"]["device_us_total"] for r in (
        "on wgmma", "streaming", "on wmma", "split-K sum"))
    return us / prof["device_busy_us"] if prof["device_busy_us"] else None


def run_whisper_serve(cfg, params, kernels, card: str) -> dict:
    """The serving paths with every launch count at 0 first: a certify
    session (one encode), a B=4 x S=448 prefill with frames (3 times), a
    decode conditioned on the audio (its first step through
    ``lm_apply(frames=..., cache=...)``, then WHISPER_DECODE_STEPS steps
    through ``session.decode``) and one lockstep Engine run (4 requests,
    prompt 16, gen 16; it decodes against the cache's zero
    ``encoder_out``, as the reference's does), each sub-path's launches
    exact: 32 plan_assign an encode (16 projections x 2 sides, L = 32),
    512 fused_bmm a forward with frames (32 x 6 encoder + 32 x 10
    decoder), 320 a forward from the cache, 32 flash_fwd a prefill."""
    dev = params["embed"]["embedding"].device
    b, s = SERVE_BATCH, WHISPER_SEQ
    sides = 2 * (WHISPER_ENC_PROJS + WHISPER_DEC_PROJS)
    with_frames = (WHISPER_ENC_PROJS * cfg.encoder_layers
                   + WHISPER_DEC_PROJS * cfg.n_layers)
    from_cache = WHISPER_DEC_PROJS * cfg.n_layers
    plan_cache.clear()
    _zero(kernels)
    calls, restore = _count_forwards()
    sub, last = {}, dict({k.symbol: 0 for k in kernels}, forwards=0)

    def since(name):
        """The launches and forwards since the last sub-path."""
        nonlocal last
        now = dict(_launches(kernels), forwards=calls[0])
        sub[name] = {k: now[k] - last[k] for k in now}
        last = now
        return sub[name]

    try:
        t0 = time.perf_counter()
        session = ServeSession(cfg, params, plan_policy="certify")
        torch.cuda.synchronize()
        session_s = time.perf_counter() - t0
        encodes = plan_cache.stats()["encodes"]
        lc = since("session")
        check(encodes == 1 and lc["plan_assign"] == sides,
              f"whisper session: one encode of exactly {sides} plan_assign "
              f"launches ({encodes} encodes; {lc})")

        rng = torch.Generator(device=dev).manual_seed(SEED + 16)
        tok = torch.randint(0, cfg.vocab, (b, s), generator=rng, device=dev)
        inputs = {"tokens": tok, "positions": torch.arange(
            s, device=dev).expand(b, s),
            "frames": _whisper_frames(cfg, b, dev, SEED + 17)}
        prefill_s = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = session.prefill(inputs)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
        check(logits.shape == (b, 1, cfg.vocab)
              and bool(torch.isfinite(logits).all()),
              "whisper prefill logits finite, (B, 1, vocab)")
        lc = since("prefill")
        check(lc["forwards"] == 3 and lc["fused_bmm"] == 3 * with_frames
              and lc["flash_fwd"] == 3 * cfg.n_layers
              and lc["plan_assign"] == 0,
              f"whisper prefill with frames: exactly {with_frames} fused_bmm "
              f"and {cfg.n_layers} flash_fwd a forward, no encode ({lc})")

        # a decode conditioned on the audio: the first step takes the
        # frames (the encoder runs and its output enters the cache)
        cache = session.new_cache(
            b, 1 + WHISPER_DECODE_STEPS + WHISPER_PROFILE_STEPS)
        check(not cache["encoder_out"].any(),
              "a new cache's encoder_out is zeros")
        nxt, step_s = tok[:, :1], []
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, _, cache = transformer.lm_apply(
                params, cfg, nxt, session.greedy_positions(b, 0),
                cache=cache, frames=inputs["frames"])
            nxt = lg[:, -1:].argmax(-1)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
        check(bool(cache["encoder_out"].abs().amax() > 0),
              "the frames step wrote the encoder output into the cache")
        lc = since("frames_step")
        check(lc["forwards"] == 1 and lc["fused_bmm"] == with_frames
              and lc["flash_fwd"] == 0,
              f"whisper frames step: exactly {with_frames} fused_bmm, no "
              f"flash ({lc})")
        tokens = [nxt]
        for t in range(1, 1 + WHISPER_DECODE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nxt, cache = session.decode(cache, nxt,
                                        session.greedy_positions(b, t))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            tokens.append(nxt)
        gen = torch.cat(tokens, 1)
        check(gen.shape == (b, 1 + WHISPER_DECODE_STEPS)
              and bool(((gen >= 0) & (gen < cfg.vocab)).all()),
              "the audio-conditioned decode's tokens are valid ids")
        lc = since("decode")
        check(lc["forwards"] == WHISPER_DECODE_STEPS
              and lc["fused_bmm"] == from_cache * WHISPER_DECODE_STEPS
              and lc["flash_fwd"] == 0,
              f"whisper decode from the cache: exactly {from_cache} "
              f"fused_bmm a step, no flash ({lc})")

        prompts = np.random.default_rng(SEED + 18).integers(
            0, cfg.vocab, (b, WHISPER_PROMPT)).astype(np.int32)
        reqs = [Request(rid=i, prompt=prompts[i],
                        max_new_tokens=WHISPER_GEN) for i in range(b)]
        lock = Engine(session, b, max_seq_for(reqs),
                      admission="lockstep").run(reqs)
        check(lock.generated_tokens == b * WHISPER_GEN
              and all(0 <= t < cfg.vocab for r in lock.records
                      for t in r.tokens),
              "whisper lockstep: every request completed with valid ids")
        lc = since("lockstep")
        check(lc["fused_bmm"] == from_cache * lc["forwards"]
              and lc["flash_fwd"] == 0 and lc["plan_assign"] == 0,
              f"whisper lockstep: exactly {from_cache} fused_bmm a step "
              f"({lc})")
    finally:
        restore()
    launches = _launches(kernels)
    check_sort_route(launches, "the whisper serving path")
    for name in ("grouped_bmm_f32", "grouped_bmm_bf16", "flash_bwd_dq",
                 "flash_bwd_dkv", "osel_encode"):
        check(launches[name] == 0, f"{name} not launched on the whisper "
                                   "serving path")
    step_ms = statistics.median(step_s) * 1e3
    out = dict(
        launches=launches, by_subpath=sub, forwards=calls[0],
        session_s=session_s, prefill_s=prefill_s,
        prefill_ms=statistics.median(prefill_s) * 1e3,
        prefill_tokens_per_s=b * s / statistics.median(prefill_s),
        prefill_frames_per_s=b * cfg.num_frames
        / statistics.median(prefill_s),
        frames_step_ms=first_s * 1e3, decode_step_ms=step_ms,
        decode_tokens_per_s=b / (step_ms / 1e3), lockstep=lock.summary(),
        encodes=encodes)
    lk = lock.summary()
    print(f"phase 15 {WHISPER} serving on {card}: launches {launches} over "
          f"{calls[0]} forwards; prefill B={b} x S={s} + {cfg.num_frames} "
          f"frames {out['prefill_ms']:.1f} ms "
          f"({out['prefill_tokens_per_s']:.0f} tokens/s); frames step "
          f"{out['frames_step_ms']:.1f} ms, then {step_ms:.1f} ms a decode "
          f"step ({out['decode_tokens_per_s']:.1f} tokens/s); lockstep "
          f"{lk['tokens_per_s']:.1f} tokens/s, p50 {lk['p50_s']:.3f} s",
          flush=True)
    return dict(out, session=session, inputs=inputs, cache=cache)


def profile_whisper(session, inputs, cache) -> dict:
    """The profiler over one prefill with frames, then over
    WHISPER_PROFILE_STEPS decode steps from the audio cache, each with
    WHISPER_SPANS: the encoder's and the cross layers' attention cores
    (plain PyTorch in both packages) and the cross k/v projections, each
    as a share of device time beside fused_bmm's. Checks the routes:
    flash_fwd on wgmma only; fused_bmm on wgmma only in the prefill, and
    on both wgmma (the cross k/v projections, B x 1,500 rows) and the
    streaming kernel (the rest, B rows) in every decode step, never on
    wmma."""
    b = inputs["tokens"].shape[0]
    pos0 = int(cache["pos"])

    def decode():
        nonlocal cache
        nxt = inputs["tokens"][:, :1]
        for t in range(WHISPER_PROFILE_STEPS):
            nxt, cache = session.decode(
                cache, nxt, session.greedy_positions(b, pos0 + t))
    with whisper_spans():
        pre = profile(lambda: session.prefill(inputs), SERVE_KERNELS,
                      WHISPER_SPANS)
        dec = profile(decode, SERVE_KERNELS, WHISPER_SPANS)
    check_flash_routes(pre, "the whisper prefill profile", ("flash_fwd",))
    kp, kd = pre["kernels"], dec["kernels"]
    check(kp["fused_bmm on wgmma"]["launches"] > 0
          and kp["fused_bmm streaming"]["launches"] == 0
          and kp["fused_bmm on wmma"]["launches"] == 0,
          f"the whisper prefill profile: fused_bmm on wgmma only ({kp})")
    check(kd["fused_bmm on wgmma"]["launches"] > 0
          and kd["fused_bmm streaming"]["launches"] > 0
          and kd["fused_bmm on wmma"]["launches"] == 0
          and kd["flash_fwd"]["launches"] == 0,
          f"the whisper decode profile: fused_bmm on wgmma (cross k/v) and "
          f"streaming, never wmma; no flash ({kd})")
    for what, pr in (("prefill", pre), ("decode", dec)):
        check(all(pr["spans"].get(n, {}).get("count") for n in
                  WHISPER_SPANS[1:]),
              f"the whisper {what} profile saw every cross span "
              f"({pr['spans']})")
    check(pre["spans"].get(WHISPER_SPANS[0], {}).get("count"),
          f"the whisper prefill profile saw the encoder's attention core "
          f"({pre['spans']})")
    for pr in (pre, dec):
        pr["fused_bmm_share"] = _fused_share(pr)
    return dict(prefill=pre, decode=dec, decode_steps=WHISPER_PROFILE_STEPS)


def run_whisper_train(kernels, device, cfg) -> dict:
    """3 steps through ``make_train_step`` (AdamW, remat, ``use_flash``,
    G=4 grouped on mlp and attn) on B=4 x S=448 batches of
    ``SyntheticTokens`` with stub frames, the launch counts at 0 before
    the state's init: exactly 32 plan_assign an encode (init and each
    step), 1,024 grouped_bmm_bf16 a step (the 512 projections of a
    forward, again in the remat replay), 64 flash_fwd, 32 flash_bwd_dq
    and 32 flash_bwd_dkv a step (the decoder's self-attention; the
    encoder's and the cross cores are plain)."""
    b, s = SERVE_BATCH, WHISPER_SEQ
    sides = 2 * (WHISPER_ENC_PROJS + WHISPER_DEC_PROJS)
    fwd = (WHISPER_ENC_PROJS * cfg.encoder_layers
           + WHISPER_DEC_PROJS * cfg.n_layers)
    torch.cuda.reset_peak_memory_stats(device)
    _zero(kernels)
    state = state_lib.init_state(
        torch.Generator(device=device).manual_seed(SEED), cfg)
    step = step_lib.make_train_step(cfg)
    ds = SyntheticTokens(cfg.vocab, b, s, seed=SEED)
    out = dict(loss=[], grad_norm=[], step_s=[])
    for i in range(TRAIN_STEPS):
        batch = dict(ds.tensors_at(i, device),
                     frames=_whisper_frames(cfg, b, device, SEED + 20 + i))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    la = _launches(kernels)
    check(all(np.isfinite(out["loss"])) and all(np.isfinite(out["grad_norm"])),
          f"whisper training: every loss and grad norm finite ({out})")
    steps = TRAIN_STEPS
    check(la["plan_assign"] == sides * (steps + 1)
          and la["grouped_bmm_bf16"] == 2 * fwd * steps
          and la["flash_fwd"] == 2 * cfg.n_layers * steps
          and la["flash_bwd_dq"] == cfg.n_layers * steps
          and la["flash_bwd_dkv"] == cfg.n_layers * steps,
          f"whisper training launches exact: plan_assign {sides} an encode, "
          f"grouped_bmm_bf16 {2 * fwd}, flash_fwd {2 * cfg.n_layers}, dq and "
          f"dkv {cfg.n_layers} a step ({la})")
    check_sort_route(la, "whisper training")
    for name in ("fused_bmm", "grouped_bmm_f32", "osel_encode"):
        check(la[name] == 0, f"{name} not launched in whisper training")
    out.update(launches=la, batch=b, seq=s, frames=cfg.num_frames,
               peak_gb=torch.cuda.max_memory_allocated(device) / 1e9,
               step_ms=statistics.median(out["step_s"][1:]) * 1e3)
    out["tokens_per_s"] = b * s / (out["step_ms"] / 1e3)
    out["frames_per_s"] = b * cfg.num_frames / (out["step_ms"] / 1e3)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_whisper(kernels, device, card: str) -> dict:
    """Phase 15: whisper-large-v3 at full width and depth (32 encoder
    layers over 1,500 stub frames, 32 decoder layers), FLGW G=4 grouped
    on mlp and attn (the cross projections too), ``use_flash``:
    plan_assign bitwise at its 32 sides; fused_bmm at one encoder block's
    6 and one decoder block's 10 projections for 6,000 (B x frames),
    1,792 (B x S) and 4 rows, grouped_bmm_bf16 at the same products above
    64 rows; flash_fwd, flash_bwd_dq and flash_bwd_dkv at B=4, Hq=Hkv=20,
    D=64, S=448, causal; then the serving paths with exact launches, a
    2 + 2-layer CPU replay, a profile, and 3 training steps."""
    cfg = registry.get_config(WHISPER, **SERVE_FLGW)
    slack = flgw.FLGWConfig().capacity_slack
    t0 = time.perf_counter()
    params = serve_params(cfg, device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    sides = check_assign_sides(params, slack)
    n_sides = 2 * (WHISPER_ENC_PROJS + WHISPER_DEC_PROJS)
    check(not sides["tiled"] and len(sides["sort"]) == n_sides,
          f"whisper: every one of its {n_sides} sides on plan_assign "
          f"({len(sides['sort'])}, {len(sides['tiled'])} past the limit)")
    with torch.inference_mode():
        state = planenc.attach_compact(transformer.encode_plans(params, cfg),
                                       params)
    mlp = [("slot0", "ffn", n) for n in ("up", "down")]
    projs = (_block_projs(params, state.plans, [
                 *(("slot0", "mixer", n) for n in "qkvo"), *mlp],
                 stack="encoder")
             + _block_projs(params, state.plans, [
                 *(("slot0", part, n) for part in ("mixer", "cross")
                   for n in "qkvo"), *mlp]))
    check(len(projs) == WHISPER_ENC_PROJS + WHISPER_DEC_PROJS,
          f"whisper: {len(projs)} compact projections a block pair")
    rows = (SERVE_BATCH * cfg.num_frames, SERVE_BATCH * WHISPER_SEQ,
            SERVE_BATCH)
    kern_rows = check_compact_kernels(projs, cfg, rows, bmm=True)
    for r in kern_rows:
        check(r["route"] != "wmma",
              f"whisper {r['proj']} at {r['rows']} rows: fused_bmm on wgmma "
              f"or the streaming kernel ({r['route']})")
    del state, projs
    torch.cuda.empty_cache()
    flash_rows = check_flash_kernel(cfg, device, ((WHISPER_SEQ, 0),),
                                    SERVE_BATCH)
    bwd_rows = check_flash_bwd_kernels(cfg, device, ((WHISPER_SEQ, 0),),
                                       SERVE_BATCH)
    _print_family_kernels(WHISPER, sides, [], flash_rows)
    _print_compact_rows(WHISPER, kern_rows)
    for r in bwd_rows:
        print(f"  flash_bwd {WHISPER} B={r['b']} Hq={r['hq']} Hkv={r['hkv']} "
              f"D={r['d']} S={r['s']}: dq {r['dq_ms']:.4f} ms "
              f"({r['dq_bound_share']:.3f} of the bound "
              f"{r['dq_bound_ms']:.4f}), dkv {r['dkv_ms']:.4f} ms "
              f"({r['dkv_bound_share']:.3f} of the bound "
              f"{r['dkv_bound_ms']:.4f}), plain {r['plain_ms']:.4f}, sdpa "
              f"bwd {r['library_ms']}; max abs err {r['max_abs_err']}",
              flush=True)

    sv = run_whisper_serve(cfg, params, kernels, card)
    session, inputs, cache = sv.pop("session"), sv.pop("inputs"), \
        sv.pop("cache")
    def replayed(rp):
        check(rp["equal_tokens"] == REPLAY_STEPS,
              f"whisper CPU replay: every greedy token equal ({rp})")
        print(f"  phase 15 whisper: CPU replay ({rp['layers']} + "
              f"{WHISPER_REPLAY_BLOCKS} layers, {cfg.num_frames} frames, "
              f"S={WHISPER_REPLAY_SEQ}): max abs err {rp['max_abs_err']}, "
              f"{rp['equal_tokens']}/{REPLAY_STEPS} greedy tokens equal",
              flush=True)
    rp = cpu_replay(cfg, params, blocks=WHISPER_REPLAY_BLOCKS,
                    seq=WHISPER_REPLAY_SEQ, steps=REPLAY_STEPS,
                    frames=_whisper_frames(cfg, 1, device, SEED + 19),
                    then=replayed)
    prof = profile_whisper(session, inputs, cache)
    for what in ("prefill", "decode"):
        pr = prof[what]
        print(f"  whisper {what} profile: busy "
              f"{pr['device_busy_us'] / 1e3:.1f} of {pr['wall_us'] / 1e3:.1f} "
              f"ms; fused_bmm share {pr['fused_bmm_share']}; spans "
              + ", ".join(f"{n} {v['device_us'] / 1e3:.2f} ms (share "
                          f"{v['share']}, {v['count']} spans)"
                          for n, v in pr["spans"].items()), flush=True)
    del session, inputs, cache, params
    plan_cache.clear()
    gc.collect()
    torch.cuda.empty_cache()

    tr = run_whisper_train(kernels, device, cfg)
    print(f"phase 15 {WHISPER} training (B={tr['batch']} x S={tr['seq']} + "
          f"{tr['frames']} frames, {TRAIN_STEPS} steps) on {card}: "
          f"{tr['step_ms']:.1f} ms/step ({tr['tokens_per_s']:.0f} tokens/s, "
          f"{tr['frames_per_s']:.0f} frames/s), losses {tr['loss']}, peak "
          f"{tr['peak_gb']:.1f} GB; launches {tr['launches']}", flush=True)
    return dict(params=n_params, param_count=param_count(cfg),
                init_s=init_s, assign=sides, kernel_rows=kern_rows,
                flash_rows=flash_rows, bwd_rows=bwd_rows, serve=sv,
                replay=rp, profile=prof, train=tr)


def whisper_launches(wh, sym: str) -> dict:
    """One kernel's launches on each path of phase 15."""
    return {"whisper_large_v3_serve": wh["serve"]["launches"][sym],
            "whisper_large_v3_train": wh["train"]["launches"][sym]}


# ---------------------------------------------------------------------------
# The IC3Net learner on an (env, agent) process mesh
# ---------------------------------------------------------------------------

MESH_ITERS = 5                 # a plan refresh at the top of every one
MESH_SHAPES = ((2, 1), (1, 2), (2, 2))
MESH_PARAM_ATOL, MESH_LOSS_RTOL = 1e-5, 1e-4
MESH_TIMEOUT_S = 180
# the three shapes' 8 ranks run at once (each rank's start-up, ~8 s to
# reach the card, is most of its time), one intra-op thread each
MESH_RANK_THREADS = 1
COMPRESS_RATIO = 0.25          # 1/G
COMPRESS_TOL = 1e-6


def _mesh_config():
    env, ecfg = envs.make("predator_prey", **ENV)
    cfg = dataclasses.replace(configs.config(), flgw_groups=4,
                              flgw_path="grouped")
    return env, ecfg, cfg, train.TrainConfig(batch=BATCH)


def _state_np(model) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in
            model.state_dict().items()}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def mesh_rank(shape: tuple, compress: bool, device: str) -> dict:
    """One rank of a spawned mesh run on ``device`` (gloo): ``train`` with
    ``mesh=shape`` and every launch count at 0 first; then its shard's
    rollout shape, and with ``compress`` the compressed all-reduce of this
    rank's own gradient tree."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.optim import compressed_allreduce, compression_init
    from repro_torch.sharding import collectives
    dev = resolve_device(device)
    env, ecfg, cfg, tcfg = _mesh_config()
    kernels = port_kernels()
    rows = set()
    bmm = fm_ops.grouped_bmm

    def recording(xg, wc):
        rows.add(int(xg.shape[1]))
        return bmm(xg, wc)
    fm_ops.grouped_bmm = recording
    for k in kernels:
        k.launches = 0
    _sync(dev)
    model, hist = train.train(cfg, ecfg, dataclasses.replace(tcfg, mesh=shape),
                              iterations=MESH_ITERS, seed=SEED, env=env,
                              device=dev)
    _sync(dev)
    launches = {k.symbol: k.launches for k in kernels}
    fm_ops.grouped_bmm = bmm
    calls = {"/".join(map(str, k)): v for k, v in collectives.CALLS.items()}
    mesh = mesh_lib.make_marl_mesh(env=shape[0], agent=shape[1])
    shard = train.shard_for(mesh, BATCH, ecfg.n_agents)
    gen = train.make_generator(SEED + 30, dev)
    with torch.no_grad():
        plans = model.encode_plans()
        state = shard.take_rows(env.reset(gen, ecfg, BATCH))
        r = train.run_episode(model, env, ecfg, state,
                              train.sampler(gen, shard), plans, shard=shard)
    out = dict(rank=dist.get_rank(), params=_state_np(model),
               history=hist, launches=launches, bmm_rows=sorted(rows),
               rollout_shape=tuple(r.reward.shape), calls=calls,
               plans_sig=int(plans.sig))
    if compress:
        # this rank's own gradients (its env rows, no mesh sum): the
        # ranks' trees differ
        local = dataclasses.replace(tcfg, batch=BATCH // shape[0])
        g = train.make_generator(SEED + 31 + dist.get_rank(), dev)
        _, grads = train._loss_grads(
            model, env, ecfg, local, env.reset(g, ecfg, local.batch),
            train.sampler(g), MESH_ITERS, None, plans)
        reduced, st = compressed_allreduce(
            grads, compression_init(grads), dist.group.WORLD,
            ratio=COMPRESS_RATIO)
        _sync(dev)
        out["compress"] = dict(
            grads=dict(_grad_leaves(grads)),
            reduced=dict(_grad_leaves(reduced)),
            error=dict(_grad_leaves(st.error)),
            on_device=all(t.device == dev for _, t in
                          _grad_leaves(reduced)))
    return out


def _compress_reference(ranks: list) -> dict:
    """The compressed all-reduce of the ranks' gradient trees on the host:
    each rank's top-k scatter, their mean, and each residual."""
    from repro_torch.optim import topk_compress, topk_decompress
    worst = dict(reduced=0.0, error=0.0)
    for name in ranks[0]["grads"]:
        sent = []
        for r in ranks:
            g = torch.from_numpy(r["grads"][name])
            vals, idx, _ = topk_compress(g, COMPRESS_RATIO)
            s = topk_decompress(vals, idx, g.shape)
            sent.append(s)
            worst["error"] = max(worst["error"], float(
                (torch.from_numpy(r["error"][name]) - (g - s)).abs().max()))
        want = torch.stack(sent).sum(0) / len(ranks)
        for r in ranks:
            worst["reduced"] = max(worst["reduced"], float(
                (torch.from_numpy(r["reduced"][name]) - want).abs().max()))
    return worst


def mesh_launches(mesh, sym: str) -> dict:
    """One kernel's launches on phase 16's paths: the (1, 1) mesh in this
    process and every spawned rank of each shape."""
    return {"ic3net_mesh_1x1": mesh["1x1"]["launches"][sym],
            **{f"ic3net_mesh_{e}x{a}": sum(
                r.get(sym, 0) for r in mesh[f"{e}x{a}"]["launches"])
               for e, a in MESH_SHAPES}}


def run_mesh(kernels, device, card: str) -> dict:
    """Phase 16: (a) ``mesh=(1, 1)`` on a world-1 NCCL group in this
    process, bitwise the run without a mesh, launches exact, the gradient
    all-reduce on NCCL; (b) spawned ranks on this card (gloo) for each of
    MESH_SHAPES, all at once, against the one-process run; (c) the
    compressed all-reduce over the 2-rank group."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.sharding import collectives
    env, ecfg, cfg, tcfg = _mesh_config()
    out = {}
    model0, hist0 = train.train(cfg, ecfg, tcfg, iterations=MESH_ITERS,
                                seed=SEED, env=env, device=device)
    layers = len(list(grouped.iter_flgw_layers(model0.params)))
    want = {k.symbol: 0 for k in kernels}
    want.update(plan_assign=2 * layers * (MESH_ITERS + 1),
                grouped_bmm_f32=MESH_ITERS * layers * ecfg.max_steps)
    ref = _state_np(model0)
    ref_loss = np.array([h["loss"] for h in hist0])

    backend = "nccl" if device.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(backend, init_method=f"file://{d}/rdv",
                                world_size=1, rank=0)
        try:
            collectives.CALLS.clear()
            _zero(kernels)
            model1, hist1 = train.train(
                cfg, ecfg, dataclasses.replace(tcfg, mesh=(1, 1)),
                iterations=MESH_ITERS, seed=SEED, env=env, device=device)
            torch.cuda.synchronize()
            launches = {k.symbol: k.launches for k in kernels}
            calls = dict(collectives.CALLS)
        finally:
            dist.destroy_process_group()
    p1 = _state_np(model1)
    check(all(np.array_equal(ref[k], p1[k]) for k in ref),
          "mesh (1, 1) parameters bitwise the run without a mesh")
    check([[h[k] for k in train._METRICS] for h in hist0]
          == [[h[k] for k in train._METRICS] for h in hist1],
          "mesh (1, 1) history bitwise the run without a mesh")
    check(launches == want, f"mesh (1, 1) launches {launches} == {want}")
    check(calls == {("all_reduce", "nccl"): 2 * MESH_ITERS},
          f"mesh (1, 1): the gradient and metric all-reduces on NCCL, one "
          f"each an iteration ({calls})")
    sparse = hist1[1:]
    out["1x1"] = dict(
        launches=launches, calls={"/".join(map(str, k)): v
                                  for k, v in calls.items()},
        ms_per_iter=statistics.median(1e3 / h["steps_per_s"] for h in sparse),
        env_steps_per_s=statistics.median(h["env_steps_per_s"]
                                          for h in sparse),
        losses=[h["loss"] for h in hist1])
    print(f"  mesh (1, 1) on NCCL, one process: launches {launches}, "
          f"{out['1x1']['ms_per_iter']:.2f} ms an iteration (median after "
          f"the first), {out['1x1']['env_steps_per_s']:.1f} env-steps/s on "
          f"{card}; bitwise the run without a mesh", flush=True)

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d, \
            ThreadPoolExecutor(len(MESH_SHAPES)) as pool:
        spawned = list(pool.map(lambda shape: mesh_lib.spawn(
            mesh_rank, shape[0] * shape[1], shape, shape == (2, 1),
            str(device), backend="gloo",
            init_file=f"{d}/rdv{shape[0]}x{shape[1]}",
            timeout_s=MESH_TIMEOUT_S, torch_threads=MESH_RANK_THREADS),
            MESH_SHAPES))
    wall_s = time.perf_counter() - t0
    out["spawned_wall_s"] = wall_s
    for shape, ranks in zip(MESH_SHAPES, spawned):
        e, a = shape
        world = e * a
        name = f"{e}x{a}"
        r0 = ranks[0]["params"]
        check(all(all(np.array_equal(r["params"][k], r0[k]) for k in r0)
                  for r in ranks),
              f"mesh {shape}: every rank's parameters bitwise rank 0's")
        check(len({r["plans_sig"] for r in ranks}) == 1,
              f"mesh {shape}: every rank's plan signature equal")
        err = max(float(np.abs(r0[k] - ref[k]).max()) for k in ref)
        check(err <= MESH_PARAM_ATOL,
              f"mesh {shape}: parameters within {MESH_PARAM_ATOL} of the "
              f"one-process card run (max abs err {err})")
        losses = np.array([h["loss"] for h in ranks[0]["history"]])
        lrel = float(np.max(np.abs(losses - ref_loss) / np.abs(ref_loss)))
        check(lrel <= MESH_LOSS_RTOL,
              f"mesh {shape}: losses within rtol {MESH_LOSS_RTOL} ({lrel})")
        check(all([[h[k] for k in train._METRICS] for h in r["history"]]
                  == [[h[k] for k in train._METRICS]
                      for h in ranks[0]["history"]] for r in ranks),
              f"mesh {shape}: every rank's metrics equal")
        rows = (BATCH // e) * (ecfg.n_agents // a)
        for r in ranks:
            check(r["launches"] == want,
                  f"mesh {shape} rank {r['rank']}: launches "
                  f"{r['launches']} == {want}")
            check(r["bmm_rows"] == [rows],
                  f"mesh {shape} rank {r['rank']}: grouped_bmm_f32 on "
                  f"{rows} rows a call ({r['bmm_rows']})")
            check(r["rollout_shape"] == (BATCH // e, ecfg.max_steps,
                                         ecfg.n_agents // a),
                  f"mesh {shape} rank {r['rank']}: rollout tensors "
                  f"{r['rollout_shape']}")
        hist = ranks[0]["history"][1:]
        out[name] = dict(
            max_abs_err=err, loss_rel=lrel,
            launches=[r["launches"] for r in ranks], bmm_rows=rows,
            calls=ranks[0]["calls"],
            ms_per_iter=[statistics.median(1e3 / h["steps_per_s"]
                                           for h in r["history"][1:])
                         for r in ranks],
            env_steps_per_s=statistics.median(h["env_steps_per_s"]
                                              for h in hist),
            losses=losses.tolist())
        print(f"  mesh {shape}, {world} spawned ranks on {card} (gloo; "
              f"the three shapes' ranks at once): "
              f"launches {ranks[0]['launches']} a rank, grouped_bmm_f32 on "
              f"{rows} rows; ms an iteration by rank "
              f"{[round(x, 2) for x in out[name]['ms_per_iter']]}, "
              f"{out[name]['env_steps_per_s']:.1f} env-steps/s; params max "
              f"abs err {err:.3g}, losses rel {lrel:.3g}; collectives "
              f"{ranks[0]['calls']}", flush=True)
        if shape == (2, 1):
            c = _compress_reference([r["compress"] for r in ranks])
            check(all(r["compress"]["on_device"] for r in ranks)
                  and c["reduced"] <= COMPRESS_TOL
                  and c["error"] <= COMPRESS_TOL,
                  f"compressed_allreduce (ratio {COMPRESS_RATIO}, 2 ranks, "
                  f"CUDA tensors) equals its host reference ({c})")
            out["compress"] = c
            print(f"  compressed_allreduce over 2 ranks at ratio "
                  f"{COMPRESS_RATIO}: max abs err {c}", flush=True)
    return out


LM_MESH_SHAPES = ((2, 1), (1, 2), (2, 2))
LM_MESH_STEPS = 2
# (b) against (a): the same bf16 steps with the gradients summed over the
# ranks in other orders (float32) and each rank's rows in their own
# products; stated before the first card run
LM_MESH_RTOL = 1e-2
# (b)'s step-2 loss change (loss 2 - loss 1, about 0.016 of 27.15)
# against (a)'s, relative; stated before the first card run that read it
LM_MESH_LOSS_DELTA_RTOL = 5e-2
# (b)'s params by what the steps changed: the relative L2 error of each
# rank's shards' change (final - init) against the matching slices of
# (a)'s. A step that wrote nothing reads 1, one that wrote a neighbour's
# slices about 1.4 (both controls are computed and must fail it); stated
# before the first card run that read it
LM_MESH_DELTA_TOL = 0.3
LM_MESH_BYTES_RTOL = 0.01      # a rank's state bytes against whole / ranks
LM_MESH_TIMEOUT_S = 420
LM_MESH_RANK_THREADS = 1


def _lm_mesh_cfg():
    return registry.get_config("gemma2_2b", **TRAIN_FLGW).with_updates(
        n_layers=CKPT_LAYERS)


def _lm_mesh_train(dev, model: int = 0):
    """phase 17's run: ``train_lm`` at the training config, its depth cut
    to CKPT_LAYERS, LM_MESH_STEPS steps; every launch count at 0 first.
    Returns (state, history, launches, collectives, peak GB)."""
    from repro_torch.sharding import collectives
    kernels = port_kernels()
    _zero(kernels)
    collectives.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    state, hist = train_lm("gemma2_2b", smoke=False, steps=LM_MESH_STEPS,
                           batch=TRAIN_BATCH, seq=TRAIN_SEQ, n_layers=CKPT_LAYERS,
                           log_every=0, device=dev, model=model,
                           **TRAIN_FLGW)
    _sync(dev)
    return (state, hist, {k.symbol: k.launches for k in kernels},
            {"/".join(map(str, k)): v for k, v in collectives.CALLS.items()},
            torch.cuda.max_memory_allocated(dev) / 1e9)


def _metrics(hist) -> dict:
    return dict(losses=[float(h["loss"]) for h in hist],
                grad_norms=[float(h["grad_norm"]) for h in hist],
                step_ms=[h["step_s"] * 1e3 for h in hist])


def lm_mesh_one(device: str, d: str) -> dict:
    """(a): one rank of a world-1 group (NCCL on the card), ``train_lm``
    on its (1, 1) mesh; its losses, grad norms and final params against
    the run without a group (``{d}/ref.pt``), bitwise."""
    from repro_torch.sharding import partition
    dev = resolve_device(device)
    state, hist, launches, calls, peak = _lm_mesh_train(dev)
    ref = torch.load(f"{d}/ref.pt")
    out = dict(_metrics(hist), launches=launches, calls=calls, peak_gb=peak,
               mesh=tuple(partition.mesh_of(state).shape))
    out["bitwise"] = (out["losses"] == ref["losses"]
                      and out["grad_norms"] == ref["grad_norms"]
                      and all(torch.equal(partition.gather(leaf).cpu(),
                                          ref["params"][path])
                              for path, leaf in store.tree_paths(
                                  state.params)))
    return out


def _wait_for(path: Path, timeout_s: float) -> None:
    t0 = time.monotonic()
    while not path.exists():
        if time.monotonic() - t0 > timeout_s:
            raise TimeoutError(f"{path} did not appear in {timeout_s} s")
        time.sleep(0.2)


def _saved_slices_equal(state, d: Path) -> tuple[int, bool]:
    """Each DTensor leaf's local shard against the matching slice of the
    array saved at its path (bf16 as raw words), bitwise."""
    from repro_torch.sharding import partition
    files = {e["path"]: e for e in json.loads(
        (d / "manifest.json").read_text())["leaves"]}
    n, same = 0, True
    for path, leaf in store.tree_paths(state):
        if path.startswith(".plans"):
            continue
        e = files[path]
        arr = np.load(d / e["file"], mmap_mode="r")
        mesh = leaf.device_mesh
        for size, c, p in zip(tuple(mesh.shape), partition.mesh_coords(mesh),
                              leaf.placements):
            if p.is_shard():           # this rank's slice, read alone
                k = arr.shape[p.dim] // size
                arr = arr[(slice(None),) * p.dim + (slice(c * k,
                                                          (c + 1) * k),)]
        arr = np.array(arr)                              # 0-d stays 0-d
        want = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) \
            if e["dtype"] == "bfloat16" else torch.from_numpy(arr)
        same &= torch.equal(leaf.to_local().cpu(), want)
        n += 1
    return n, same


def _neighbour_of(final, init, placement, mesh):
    """(a)'s change (final - init) at the slice of the next rank along
    the first mesh dimension that splits the leaf (this rank's slice
    elsewhere), in float32; None for a replicated leaf."""
    from torch.distributed.tensor import Shard
    from repro_torch.sharding import partition
    first = True
    for n, c, p in zip(tuple(mesh.shape), partition.mesh_coords(mesh),
                       placement):
        if isinstance(p, Shard) and n > 1:
            c = (c + 1) % n if first else c
            first = False
            final, init = final.chunk(n, p.dim)[c], init.chunk(n, p.dim)[c]
    return None if first else final.float() - init.float()


def lm_mesh_rank(shape: tuple, device: str, d: str, role: str) -> dict:
    """(b), one rank of a ``shape`` mesh on gloo: ``train_lm`` on the
    mesh; its launches, collectives, peak memory and state bytes; its
    params, shard by shard, against the run without a group's;
    then (c): the (2, 2) shape saves its final state, the (2, 1) shape
    restores it onto its own mesh with ``shardings=``."""
    import torch.distributed as dist
    from repro_torch.sharding import partition
    from repro_torch.sharding import collectives
    dev = resolve_device(device)
    state, hist, launches, calls, peak = _lm_mesh_train(dev, model=shape[1])
    coll_bytes = {"/".join(map(str, k)): v
                  for k, v in collectives.BYTES.items()}
    rank = dist.get_rank()
    local, whole = partition.state_bytes(state)
    out = dict(_metrics(hist), rank=rank, launches=launches, calls=calls,
               coll_bytes=coll_bytes, peak_gb=peak, local_bytes=local,
               whole_bytes=whole)
    # the params against (a)'s, slice by slice: each rank's shards against
    # the matching slices (no gather), on the host; and what the steps
    # changed, against (a)'s change, beside the two controls
    torch.cuda.empty_cache()
    ref = torch.load(f"{d}/ref.pt", mmap=True)
    err, close = 0.0, True
    sq = dict.fromkeys(("err", "ref", "none", "neighbour", "neighbour_ref"),
                       0.0)
    for path, leaf in store.tree_paths(state.params):
        mesh, pl = leaf.device_mesh, leaf.placements
        got = leaf.to_local().cpu().float()
        init = partition.shard_of(ref["init"][path], pl, mesh).float()
        want = partition.shard_of(ref["params"][path], pl, mesh).float()
        err = max(err, float((got - want).abs().max()))
        close &= torch.allclose(got, want, **REPLAY_TRAIN_TOL)
        change = want - init
        sq["err"] += float(((got - init) - change).square().sum())
        sq["ref"] += float(change.square().sum())
        sq["none"] += float(change.square().sum())   # got == init
        other = _neighbour_of(ref["params"][path], ref["init"][path], pl,
                              mesh)
        if other is not None:
            sq["neighbour"] += float((other - change).square().sum())
            sq["neighbour_ref"] += float(change.square().sum())
    out.update(params_max_abs_err=err, params_close=close,
               change_err=(sq["err"] / sq["ref"]) ** 0.5,
               no_update_err=(sq["none"] / sq["ref"]) ** 0.5,
               neighbour_err=(sq["neighbour"] / sq["neighbour_ref"]) ** 0.5
               if sq["neighbour_ref"] else None)
    del ref
    ckpt = Path(d) / "ckpt"
    if role == "save":
        torch.cuda.empty_cache()
        _sync(dev)
        t0 = time.perf_counter()
        store.save_checkpoint(ckpt, LM_MESH_STEPS, state)
        out["save_s"] = time.perf_counter() - t0
    elif role == "restore":
        saved = ckpt / f"step_{LM_MESH_STEPS:08d}"
        _wait_for(saved / "manifest.json", LM_MESH_TIMEOUT_S)
        _sync(dev)
        t0 = time.perf_counter()
        state, step = state_lib.restore_state(
            ckpt, state, _lm_mesh_cfg(),
            shardings=partition.shardings_of(state))
        _sync(dev)
        out["restore_s"] = time.perf_counter() - t0
        out["restored_step"] = step
        out["restored_leaves"], out["restored_bitwise"] = \
            _saved_slices_equal(state, saved)
    return out


def lm_mesh_launches(lm, sym: str) -> dict:
    """One kernel's launches on phase 17's paths: the run without a group
    (this process), the world-1 NCCL rank and every rank of each shape."""
    return {"gemma2_mesh_none": lm["none"]["launches"][sym],
            "gemma2_mesh_1x1": lm["1x1"]["launches"][sym],
            **{f"gemma2_mesh_{a}x{b}": sum(
                r["launches"][sym] for r in lm[f"{a}x{b}"]["ranks"])
               for a, b in LM_MESH_SHAPES}}


def run_lm_mesh(device, card: str) -> dict:
    """Phase 17: gemma2-2b's training config on a ``(data, model)`` mesh
    through ``train_lm``: the run without a group in this process (the
    reference), (a) a world-1 NCCL group in a spawned process, bitwise
    it; (b) (2, 1), (1, 2) and (2, 2) as spawned gloo ranks sharing the
    card, in two waves ((a) beside (2, 2), then (2, 1) beside (1, 2)),
    within LM_MESH_RTOL (losses, grad norms), LM_MESH_LOSS_DELTA_RTOL (the
    step-2 loss change), REPLAY_TRAIN_TOL (the params, shard by shard) and
    LM_MESH_DELTA_TOL (what the steps changed in each rank's shards, which
    a no-update and a neighbour's-slices control must fail) of it, each
    rank's state bytes whole / ranks and its launches (a)'s; (c) (2, 2)'s
    final state saved once and restored onto the (2, 1) mesh with
    ``shardings=``, each rank's shards the saved arrays' slices
    bitwise."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.sharding import partition
    cfg = _lm_mesh_cfg()
    out = dict(cut=f"n_layers {CKPT_LAYERS} of 26 (one local, one global "
                   f"slot)", params=param_count(cfg), steps=LM_MESH_STEPS,
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, rtol=LM_MESH_RTOL)
    with tempfile.TemporaryDirectory(prefix="repro-lm-mesh-") as d:
        # the initial params every run starts from: train_lm's, no step
        state, _ = train_lm("gemma2_2b", smoke=False, steps=0,
                            batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                            n_layers=CKPT_LAYERS, log_every=0, device=device,
                            **TRAIN_FLGW)
        init = {p: t.cpu() for p, t in store.tree_paths(state.params)}
        del state
        torch.cuda.empty_cache()
        state, hist, launches, calls, peak = _lm_mesh_train(device)
        out["none"] = dict(_metrics(hist), launches=launches, peak_gb=peak)
        torch.save(dict(losses=out["none"]["losses"],
                        grad_norms=out["none"]["grad_norms"], init=init,
                        params={p: t.cpu() for p, t in
                                store.tree_paths(state.params)}),
                   f"{d}/ref.pt")
        del init
        del state, hist
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  lm mesh: no group, {out['params']:,} params ("
              f"{out['cut']}), {TRAIN_BATCH} x {TRAIN_SEQ}: step ms "
              f"{[round(x, 1) for x in out['none']['step_ms']]}, losses "
              f"{out['none']['losses']}, launches {launches} on {card}",
              flush=True)

        backend = "nccl" if device.type == "cuda" else "gloo"

        def run(shape, role=None):
            """One spawned group: (1, 1) is (a), the others (b)."""
            world = shape[0] * shape[1]
            fn, args = ((lm_mesh_one, (str(device), d)) if role == "a" else
                        (lm_mesh_rank, (shape, str(device), d, role)))
            t = time.perf_counter()
            ranks = mesh_lib.spawn(
                fn, world, *args, backend=backend if role == "a" else "gloo",
                init_file=f"{d}/rdv_{shape[0]}x{shape[1]}_{role}",
                timeout_s=LM_MESH_TIMEOUT_S,
                torch_threads=LM_MESH_RANK_THREADS)
            return ranks, time.perf_counter() - t

        # two waves of at most 5 processes: 8 ranks at once on one card
        # and its host (8 cores, 96 GiB) ran out of the card's memory or
        # stalled (PERF.md); (2, 2) saves in the first, (2, 1) restores
        # in the second
        waves = ((((1, 1), "a"), ((2, 2), "save")),
                 (((2, 1), "restore"), ((1, 2), None)))
        spawned, wall = {}, {}
        alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        t0 = time.perf_counter()
        try:
            for wave in waves:
                with ThreadPoolExecutor(len(wave)) as pool:
                    futures = {shape: pool.submit(run, shape, role)
                               for shape, role in wave}
                    for shape, f in futures.items():
                        spawned[shape], wall[shape] = f.result()
        finally:
            if alloc is None:
                os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
        (one,) = spawned.pop((1, 1))
        one["wall_s"] = wall[(1, 1)]
        out["1x1"] = one
        check(one["bitwise"] and one["mesh"] == (1, 1),
              "lm mesh (1, 1) on a world-1 NCCL group: losses, grad norms "
              "and final params bitwise the run without a group")
        check(one["launches"] == launches,
              f"lm mesh (1, 1): launches {one['launches']} == the run "
              f"without a group's {launches}")
        check(set(one["calls"]) == {f"{op}/{backend}" for op in (
            "all_gather", "reduce_scatter", "all_reduce")},
              f"lm mesh (1, 1): its collectives on {backend} "
              f"({one['calls']})")
        print(f"  lm mesh (1, 1), world-1 NCCL group in a spawned process "
              f"(beside (2, 2)): bitwise the run without a group; step ms "
              f"{[round(x, 1) for x in one['step_ms']]}, peak "
              f"{one['peak_gb']:.2f} GB, collectives {one['calls']} on "
              f"{card}", flush=True)
        spawned = [spawned[shape] for shape in LM_MESH_SHAPES]
        out["wave_s"] = [max(wall[s] for s, _ in w) for w in waves]
        out["spawned_wall_s"] = time.perf_counter() - t0
    ref = out["none"]
    for shape, ranks in zip(LM_MESH_SHAPES, spawned):
        world = shape[0] * shape[1]
        name = f"{shape[0]}x{shape[1]}"
        for r in ranks:
            for key in ("losses", "grad_norms"):
                rel = max(abs(a - b) / abs(b) for a, b in zip(r[key],
                                                              ref[key]))
                check(rel <= LM_MESH_RTOL,
                      f"lm mesh {shape} rank {r['rank']}: {key} within "
                      f"rtol {LM_MESH_RTOL} of (a) ({rel:.3g})")
            share = r["whole_bytes"] / world
            check(abs(r["local_bytes"] - share) <= LM_MESH_BYTES_RTOL * share,
                  f"lm mesh {shape} rank {r['rank']}: state bytes "
                  f"{r['local_bytes']:,} within {LM_MESH_BYTES_RTOL} of "
                  f"the whole {r['whole_bytes']:,} / {world}")
            check(r["launches"] == one["launches"],
                  f"lm mesh {shape} rank {r['rank']}: launches "
                  f"{r['launches']} == (a)'s {one['launches']}")
            check(r["losses"] == ranks[0]["losses"],
                  f"lm mesh {shape}: every rank's losses equal")
            step = [x[1] - x[0] for x in (r["losses"], ref["losses"])]
            rel = abs(step[0] - step[1]) / abs(step[1])
            check(rel <= LM_MESH_LOSS_DELTA_RTOL,
                  f"lm mesh {shape} rank {r['rank']}: the step-2 loss "
                  f"change {step[0]:.6g} within rtol "
                  f"{LM_MESH_LOSS_DELTA_RTOL} of (a)'s {step[1]:.6g} "
                  f"({rel:.3g})")
            check(r["change_err"] <= LM_MESH_DELTA_TOL,
                  f"lm mesh {shape} rank {r['rank']}: its shards' change "
                  f"over the steps within relative L2 {LM_MESH_DELTA_TOL} "
                  f"of (a)'s ({r['change_err']:.4g})")
            controls = [r["no_update_err"]] + (
                [r["neighbour_err"]] if r["neighbour_err"] is not None
                else [])
            check(all(c > LM_MESH_DELTA_TOL for c in controls),
                  f"lm mesh {shape} rank {r['rank']}: the controls (no "
                  f"update, a neighbour's slices) fail that limit "
                  f"({controls})")
        r0 = ranks[0]
        err = max(r["params_max_abs_err"] for r in ranks)
        check(all(r["params_close"] for r in ranks),
              f"lm mesh {shape}: the params (each rank's shards against "
              f"the matching slices of (a)'s) within {REPLAY_TRAIN_TOL} "
              f"(max abs err {err:.3g})")
        out[name] = dict(ranks=ranks)
        print(f"  lm mesh {shape}, {world} gloo ranks on {card} (in two "
              f"waves, (a) beside (2, 2), (2, 1) beside (1, 2)): step ms by rank "
              f"{[[round(x, 1) for x in r['step_ms']] for r in ranks]}, peak "
              f"GB by rank {[round(r['peak_gb'], 2) for r in ranks]}, state "
              f"bytes a rank {r0['local_bytes']:,} of {r0['whole_bytes']:,}, "
              f"launches {r0['launches']} a rank, losses {r0['losses']}, "
              f"params max abs err {err:.3g}, their change's relative L2 "
              f"error by rank {[round(r['change_err'], 5) for r in ranks]}"
              f" (controls: no update "
              f"{[round(r['no_update_err'], 4) for r in ranks]}, a "
              f"neighbour's slices "
              f"{[r['neighbour_err'] and round(r['neighbour_err'], 4) for r in ranks]}), "
              f"collectives a rank {r0['calls']}", flush=True)
    saver = out["2x2"]["ranks"]
    loader = out["2x1"]["ranks"]
    for r in loader:
        check(r["restored_step"] == LM_MESH_STEPS and r["restored_bitwise"]
              and r["restored_leaves"] > 0,
              f"lm mesh: (2, 2)'s checkpoint restored onto (2, 1) rank "
              f"{r['rank']}, its {r['restored_leaves']} shards the saved "
              f"arrays' slices bitwise")
    out["save_s"] = max(r["save_s"] for r in saver)
    out["restore_s"] = max(r["restore_s"] for r in loader)
    print(f"  lm mesh checkpoint: (2, 2) saved its state in "
          f"{out['save_s']:.1f} s, (2, 1) restored it in "
          f"{out['restore_s']:.1f} s (bitwise slices); the two waves "
          f"{[round(x, 1) for x in out['wave_s']]} s of wall on {card}",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 18: the analysis layer against the card
# ---------------------------------------------------------------------------

# the launch audit over every profile the script takes: (entry, case)
# pairs matched, launches the profiler did not record, records that
# match no prediction
_LAUNCH_AUDIT = dict(profiles=0, matched=collections.Counter(),
                     unrecorded=collections.Counter(), mismatches=[])
DRYRUN_TIMEOUT_S = 600
DRYRUN_THREADS = 2
ANALYSIS_SERVE_LAYERS = 2     # the contracts' serve run: 2 of 26 layers


def _kineto_name(name: str) -> str:
    """A demangled kernel name as the audit and ptxas name it:
    ``void (anonymous namespace)::plan_assign_kernel<128, 4>(float
    const*, ...)`` -> ``plan_assign_kernel<128, 4>``; bf16 as ``bf16``."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.removeprefix("void ").strip()
    depth = 0
    for i, ch in enumerate(name):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    return name.replace("__nv_bfloat16", "bf16").split("::")[-1]


def _recorded_kernels(prof) -> list:
    """Every kernel launch the profiler recorded: its name, grid, block
    and shared memory (static + dynamic), from the exported trace's
    kernel events (the in-memory events carry no launch config)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
    finally:
        os.unlink(path)
    out = []
    for ev in trace.get("traceEvents", []):
        a = ev.get("args") or {}
        if ev.get("cat") != "kernel" or "grid" not in a:
            continue
        out.append(dict(name=_kineto_name(ev["name"]), grid=tuple(a["grid"]),
                        block=tuple(a["block"]),
                        smem=a.get("shared memory")))
    return out


def _audit_profile(recorded: list, prof) -> None:
    """Each recorded port-kernel launch against the launch audit's
    prediction of the calls made in the same profile: the same kernel,
    grid, block and shared memory (the audit's static + dynamic). A
    profile whose (entry, shape) pairs all matched in earlier profiles
    is not read again (its trace export costs time)."""
    from repro_torch.analysis import kernel_audit
    ours = {k for s in kernel_audit.load_registry().values()
            for k in s.kernels}
    pred = collections.Counter()
    labels: dict = {}
    for sym, args in recorded:
        for c in kernel_audit.predict_recorded(sym, args):
            key = (c.kernel, c.grid, c.block, c.smem)
            pred[key] += 1
            labels.setdefault(key, []).append((sym, c.label))
    if all(pair in _LAUNCH_AUDIT["matched"] for ls in labels.values()
           for pair in ls):
        return
    for ev in _recorded_kernels(prof):
        if ev["name"].split("<")[0] not in ours:
            continue
        key = (ev["name"], ev["grid"], ev["block"], ev["smem"])
        if pred[key] > 0:
            pred[key] -= 1
            _LAUNCH_AUDIT["matched"][labels[key].pop()] += 1
        else:
            near = [k for k in pred if k[0] == ev["name"]][:3]
            _LAUNCH_AUDIT["mismatches"].append(dict(recorded=ev,
                                                    predicted=near))
    for key, n in pred.items():
        for sym, label in labels[key][:n]:
            _LAUNCH_AUDIT["unrecorded"][(sym, label)] += 1
    _LAUNCH_AUDIT["profiles"] += 1


def dryrun_phase17() -> dict:
    """Phase 18 (b), in a CPU process of its own: the dry run of phase
    17's config (gemma2-2b at full width, CKPT_LAYERS layers, B=4 x
    S=1024) on ``meta`` over fake groups of each of phase 17's mesh
    shapes and of one rank (the one-process step's roofline)."""
    from repro_torch.launch import dryrun
    cfg = _lm_mesh_cfg()
    out = {}
    for shape in ((1, 1), *LM_MESH_SHAPES):
        t0 = time.perf_counter()
        r = dryrun.run_cell("gemma2_2b", "train_4k", cfg=cfg,
                            seq=TRAIN_SEQ, batch=TRAIN_BATCH,
                            mesh_shape=shape, save=False, **TRAIN_FLGW)
        r["wall_s"] = time.perf_counter() - t0
        out[f"{shape[0]}x{shape[1]}"] = r
    return out


def start_dryrun():
    """Starts :func:`dryrun_phase17` in a spawned CPU process (no card,
    no process group: the dry run makes its own fake one)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context(
        "spawn"), initializer=torch.set_num_threads,
        initargs=(DRYRUN_THREADS,))
    return pool, pool.submit(dryrun_phase17), time.perf_counter()


def contracts_on_card(dev, card: str) -> dict:
    """Phase 18 (c): a lockstep serve run with ``debug_contracts=True``
    passes (one decode signature), and a decode loop whose batch grows
    raises ``RetraceError``."""
    from repro_torch.analysis import contracts
    from repro_torch.serving.scheduler import Engine, Request
    from repro_torch.serving.session import ServeSession
    cfg = registry.get_config("gemma2_2b", n_layers=ANALYSIS_SERVE_LAYERS,
                              **SERVE_FLGW)
    params = serve_params(cfg, dev)
    sess = ServeSession(cfg, params, debug_contracts=True)
    eng = Engine(sess, SERVE_BATCH, 32, admission="lockstep")
    reqs = [Request(rid=i, prompt=np.arange(1, 9, dtype=np.int32) + i,
                    max_new_tokens=8) for i in range(SERVE_BATCH)]
    with contracts.no_retrace(label="phase 18") as mon:
        rep = eng.run(reqs)
    check(eng.debug_contracts and mon.counts() == {"decode_step": 1},
          f"contracts: the lockstep run with debug_contracts=True ran its "
          f"decode step at one signature ({mon.counts()})")
    check(all(len(r.tokens) == 8 for r in rep.records),
          "contracts: every request generated its 8 tokens")
    raised = ""
    try:
        with contracts.no_retrace(label="a shape-unstable decode loop"):
            for b in (1, 2):
                cache = sess.new_cache(b, 16)
                tok = torch.ones((b, 1), dtype=torch.int64, device=dev)
                sess.decode(cache, tok, torch.zeros_like(tok))
    except contracts.RetraceError as e:
        raised = str(e).splitlines()[0]
    check(bool(raised), "contracts: a decode loop fed batch 1 then 2 "
          "raises RetraceError on the card")
    del params, sess, eng
    torch.cuda.empty_cache()
    print(f"  contracts on {card}: a lockstep run (gemma2-2b at "
          f"{ANALYSIS_SERVE_LAYERS} layers, {SERVE_BATCH} requests) under "
          f"debug_contracts=True ran decode_step at one signature; a decode "
          f"loop of batch 1 then 2 raised RetraceError ({raised})",
          flush=True)
    return dict(lockstep_signatures=mon.counts(), unstable_raised=raised)


def run_analysis(dev, card: str, lm_mesh: dict, dry, asy: dict) -> dict:
    """Phase 18: (a) the launch audit against every profile's records;
    (b) the dry run (started beside the card phases) against phase 17's
    counted collectives and state bytes, and the roofline fraction of
    its one-process step; (c) the runtime contracts on the card (and
    phase 8's threaded async run, which ran with ``debug_contracts``)."""
    from repro_torch.analysis import kernel_audit
    out = {}
    # (a)
    la = _LAUNCH_AUDIT
    entries = sorted(kernel_audit.load_registry())
    matched = {e: sum(n for (s, _), n in la["matched"].items() if s == e)
               for e in entries}
    pairs = {e: sorted({c for (s, c) in la["matched"] if s == e})
             for e in entries}
    unrecorded = sum(la["unrecorded"].values())
    out["launch_audit"] = dict(
        profiles=la["profiles"], matched_launches=matched,
        matched_pairs={e: len(p) for e, p in pairs.items()},
        unrecorded_launches=unrecorded,
        unrecorded_pairs=len(set(la["unrecorded"]) - set(la["matched"])),
        mismatches=la["mismatches"][:20], n_mismatches=len(la["mismatches"]))
    print(f"  launch audit over {la['profiles']} profiles on {card}: "
          f"(entry, shape) pairs matched "
          f"{out['launch_audit']['matched_pairs']} "
          f"({sum(matched.values())} launches); {unrecorded} launches "
          f"without a record; {len(la['mismatches'])} mismatches", flush=True)
    for m in la["mismatches"][:5]:
        print(f"  launch audit mismatch: {m}", flush=True)
    check(not la["mismatches"],
          f"launch audit: every recorded launch is the audit's prediction "
          f"({len(la['mismatches'])} mismatches)")
    profiled = {s for s, _ in la["matched"]} | {s for s, _ in
                                                 la["unrecorded"]}
    out["launch_audit"]["never_profiled"] = sorted(set(entries) - profiled)
    check(all(pairs[e] for e in profiled),
          f"launch audit: every entry launched inside a profile has a "
          f"matched record ({ {e: len(pairs[e]) for e in profiled} })")
    # (b)
    pool, future, t0 = dry
    try:
        dr = future.result(timeout=DRYRUN_TIMEOUT_S)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    out["dryrun_wait_s"] = time.perf_counter() - t0
    rows = {}
    for shape in LM_MESH_SHAPES:
        name = f"{shape[0]}x{shape[1]}"
        pred = dr[name]
        want = {op: (LM_MESH_STEPS * c["calls"], LM_MESH_STEPS * c["bytes"])
                for op, c in pred["collectives"].items()}
        for r in lm_mesh[name]["ranks"]:
            got = {k.split("/")[0]: (n, r["coll_bytes"][k])
                   for k, n in r["calls"].items()}
            check(got == want,
                  f"dry run {name}: rank {r['rank']}'s collectives of "
                  f"{LM_MESH_STEPS} steps {got} == the prediction {want}")
            check(r["local_bytes"] == pred["state_bytes_per_chip"],
                  f"dry run {name}: rank {r['rank']}'s state bytes "
                  f"{r['local_bytes']:,} == the prediction "
                  f"{pred['state_bytes_per_chip']:,}")
        rows[name] = dict(collectives=pred["collectives"],
                          state_bytes=pred["state_bytes_per_chip"],
                          roofline=pred["roofline"], wall_s=pred["wall_s"])
        print(f"  dry run {name} (a fake group on the CPU, beside the card "
              f"phases): a step's collectives {pred['collectives']}, state "
              f"{pred['state_bytes_per_chip']:,} bytes a rank: phase 17's "
              f"ranks counted {LM_MESH_STEPS}x those, equal", flush=True)
    one = dr["1x1"]
    step_ms = min(lm_mesh["none"]["step_ms"])
    bound_s = one["roofline"]["step_time_lower_bound_s"]
    out["dryrun"] = dict(rows, one_process=dict(
        roofline=one["roofline"], flops=one["cost"]["flops_per_chip"],
        bytes=one["cost"]["bytes_per_chip"], step_ms=step_ms,
        roofline_fraction=bound_s * 1e3 / step_ms))
    print(f"  roofline of phase 17's one-process step on {card}: dry-run "
          f"bound {bound_s * 1e3:.2f} ms ({one['roofline']['dominant']}; "
          f"compute {one['roofline']['compute_s'] * 1e3:.2f}, memory "
          f"{one['roofline']['memory_s'] * 1e3:.2f} ms by unfused bytes), "
          f"the step {step_ms:.1f} ms: {bound_s * 1e3 / step_ms:.3f} of the "
          f"bound's time; the dry runs took "
          f"{sum(r['wall_s'] for r in dr.values()):.1f} s in their process, "
          f"joined {out['dryrun_wait_s']:.1f} s after it started", flush=True)
    # (c)
    out["contracts"] = contracts_on_card(dev, card)
    check(asy["threaded"]["debug_contracts"],
          "contracts: phase 8's threaded async run ran with "
          "debug_contracts=True")
    print(f"  contracts: phase 8's threaded async run "
          f"({len(asy['threaded']['losses'])} updates) passed under "
          f"debug_contracts=True on {card}", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_script = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    gc.callbacks.append(_time_full_gcs)

    phase_s, t_phase = {}, [time.perf_counter()]

    def phase_done(n, what: str) -> None:
        """Print and record phase ``n``'s wall seconds."""
        now = time.perf_counter()
        phase_s[f"{n} {what}"] = now - t_phase[0]
        print(f"phase {n} ({what}) took {now - t_phase[0]:.1f} s; the "
              f"script so far {now - t_script:.1f} s", flush=True)
        t_phase[0] = now

    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    print(f"built {sorted(logs)} in {build_s:.2f} s", flush=True)
    phase_done(1, "build")
    ptxas = {name: ptxas_usage(log) for name, log in logs.items()}
    for name, usage in ptxas.items():
        for kernel, u in usage.items():
            print(f"  {name}: {kernel}: {u}")
    fa_usage = ptxas.get("flash_attention", {})
    fm_usage = ptxas.get("flgw_matmul", {})
    pe_usage = ptxas.get("plan_encode", {})
    all_kernels = port_kernels()

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

    assign_rows = check_assign_kernel(flgw_sides(model.params), slack)
    for r in assign_rows:
        print(f"  plan_assign {r['side']:>12} L={r['layers']} "
              f"M={r['items']}: {r['ms']:.4f} ms, {r['device_us']} "
              f"device us ({r['profiler_recorded_launches']} of "
              f"{r['profiler_calls']} recorded), plain "
              f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.2e} "
              f"({r['bound_by']}), torch.sort "
              f"{r['sort_yardstick_ms']:.4f}")
    tiled = check_tiled_route(slack, model.device)
    print(f"  past the sort limit (L, M, G = {TILED_SIDE}): plan_rank "
          f"{tiled['rank']['ms']:.4f} ms ({tiled['rank']['device_us']} device "
          f"us), plan_place {tiled['place']['ms']:.4f} ms "
          f"({tiled['place']['device_us']} device us), bitwise their plain "
          "versions; balanced_assign == the sort oracle", flush=True)
    enc_t = time_encode.measure(model.device)
    print(f"encode: IC3Net {enc_t['ic3net']}, gemma2-2b train config "
          f"{enc_t['gemma2_2b_train']}", flush=True)
    with torch.inference_mode():
        plans = model.encode_plans()
    bmm_rows = check_bmm_kernel(model, plans, BATCH * cfg.n_agents)
    for r in bmm_rows:
        print(f"  grouped_bmm_f32 {r['layer']:>7} {r['k']}x{r['n']} "
              f"({r['cols']}-column tiles): {r['ms']:.4f} ms, "
              f"{r['device_us']:.2f} device us, {r['host_us']:.1f} host us; "
              f"bmm {r['library_ms']:.4f} ms, {r['library_device_us']:.2f} "
              f"device us, {r['library_host_us']:.1f} host us")
    print("IC3Net kernels match their plain versions on the card; the plan "
          "encode kernels have no single PyTorch call to time as a library "
          "yardstick (library_ms null), grouped_bmm_f32 has torch.bmm",
          flush=True)
    phase_done(2, "IC3Net kernels")

    sl = run_slice(model, cpu_model, env, ecfg, all_kernels)
    print(f"slice 1: launches {sl['launches']}, encode {sl['encode_ms']:.3f} "
          f"ms, rollout {sl['rollout_s'] * 1e3:.2f} ms, "
          f"{sl['env_steps_per_s']:.1f} env-steps/s, replay max abs err "
          f"{sl['replay_max_abs_err']}", flush=True)
    prof = profile_path(model, env, ecfg, LEARN_KERNELS)
    print_profile("encode + rollout", prof)
    ic3_params = model.params        # the OSEL phase's IC3Net layers
    del model, cpu_model, plans
    phase_done(3, "IC3Net actor")

    # -- path 2: serving gemma2-2b -------------------------------------------
    dev = resolve_device()
    scfg = registry.get_config("gemma2_2b", n_layers=SERVE_LAYERS,
                               **SERVE_FLGW)
    params = serve_params(scfg, dev)
    n_params = sum(t.numel() for t in _leaves(params))
    # every FLGW side of the served model (L = SERVE_LAYERS / 2 stacked
    # layers a slot), then the MLP's sides with both slots' 13 layers in
    # one launch (L = 26)
    lm_slack = flgw.FLGWConfig().capacity_slack   # transformer.encode_plans'
    gen26 = torch.Generator(device=dev).manual_seed(SEED + 6)
    lm_assign_rows = check_assign_kernel(
        [*flgw_sides(params),
         *[(f"L=26 M={m} axis {axis}", torch.randn(
             (l, m, 4) if axis else (l, 4, m), generator=gen26, device=dev),
            axis) for l, m, axis in LM26_SIDES]], lm_slack)
    for r in lm_assign_rows:
        print(f"  plan_assign {r['side']:>22} L={r['layers']} "
              f"M={r['items']}: {r['ms']:.4f} ms, {r['device_us']} "
              f"device us ({r['profiler_recorded_launches']} of "
              f"{r['profiler_calls']} recorded), plain "
              f"{r['plain_ms']:.3f}, bound {r['bound_ms']:.2e} "
              f"({r['bound_by']}), torch.sort "
              f"{r['sort_yardstick_ms']:.4f}", flush=True)
    fused_rows = check_fused_kernel(params, scfg)
    flash_rows = check_flash_kernel(scfg, dev)
    for r in fused_rows:
        cold = f", cold {r['ms_cold']:.4f}" if "ms_cold" in r else ""
        print(f"  fused_bmm {r['proj']:>4} {r['rows']:>4} rows {r['dtype']}: "
              f"{r['ms']:.4f} ms{cold} ({r['tflops']:.1f} TFLOP/s, "
              f"{r['bound_share']:.3f} of the bound, {r['route']}), plain "
              f"{r['plain_ms']:.4f}, bmm {r['library_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']})")
    for r in flash_rows:
        print(f"  flash_fwd S={r['s']} window={r['window']}: {r['ms']:.4f} "
              f"ms ({r['tflops']:.1f} TFLOP/s, {r['bound_share']:.3f} of the "
              f"bound, {r['route']}; softcap 0: {r['ms_softcap0']:.4f}), "
              f"plain {r['plain_ms']:.4f}, sdpa {r['library_ms']}, bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']})")
    print(f"gemma2-2b: {n_params:,} parameters; fused_bmm matches its plain "
          f"version at {len(fused_rows)} shapes (max abs err "
          f"{max(r['max_abs_err'] for r in fused_rows):.3g}), flash_fwd at "
          f"{len(flash_rows)} (max abs err "
          f"{max(r['max_abs_err'] for r in flash_rows):.3g})", flush=True)
    calls, restore = _count_forwards()
    try:
        sv = run_serve(scfg, params, all_kernels)
    finally:
        restore()
    session = sv.pop("session")
    del sv["inputs"], sv["logits"]
    lc = sv["launches"]
    check(lc["plan_assign"] == 2 * SERVE_PROJECTIONS * scfg.period
          * sv["encodes"]
          and lc["fused_bmm"] == SERVE_PROJECTIONS * scfg.n_layers * calls[0]
          and lc["flash_fwd"] == scfg.n_layers * len(sv["prefill_s"]),
          f"gemma2-2b serving launches exact: plan_assign "
          f"{2 * SERVE_PROJECTIONS * scfg.period} an encode ({sv['encodes']} "
          f"encodes), fused_bmm {SERVE_PROJECTIONS} a layer and forward "
          f"({calls[0]} forwards), flash_fwd one a layer and prefill ({lc})")
    sv["forwards"] = calls[0]
    lk, ct = sv["lockstep"], sv["continuous"]
    print(f"slice 2 ({scfg.n_layers} of 26 layers): launches "
          f"{sv['launches']} over {calls[0]} forwards; prefill B={SERVE_BATCH} x "
          f"S={PREFILL_SEQ} {sv['prefill_ms']:.1f} ms "
          f"({sv['prefill_tokens_per_s']:.0f} tokens/s); lockstep "
          f"{lk['tokens_per_s']:.1f} tokens/s, p50 {lk['p50_s']:.3f} s, "
          f"p99 {lk['p99_s']:.3f} s; continuous {ct['tokens_per_s']:.1f} "
          f"tokens/s, p50 {ct['p50_s']:.3f} s, p99 {ct['p99_s']:.3f} s; plan "
          f"cache {sv['plan_cache']['encodes']} encodes, "
          f"{sv['plan_cache']['hits']} hits", flush=True)
    rp = cpu_replay(scfg, params, then=lambda rp: print(
        f"phase 4 gemma2-2b: CPU replay (4 layers): max abs err "
        f"{rp['max_abs_err']}, {rp['equal_tokens']}/8 greedy tokens equal "
        f"({rp['clear_steps']} with a clear top-2 margin)", flush=True))
    sprof = profile_serve(session, scfg)
    print_profile("prefill + 8 decode steps", sprof)
    check_flash_routes(sprof, "the serve profile", ("flash_fwd",))
    check_fused_routes(sprof)
    del session, params
    plan_cache.clear()
    torch.cuda.empty_cache()
    phase_done(4, "gemma2-2b serving")

    # -- path 3: training gemma2-2b ------------------------------------------
    tcfg = registry.get_config("gemma2_2b", **TRAIN_FLGW)
    bmm16_rows = check_bmm_bf16_kernel(tcfg, dev)
    bwd_rows = check_flash_bwd_kernels(tcfg, dev)
    for r in bmm16_rows:
        wm = (f", wmma {r['wmma_ms']:.4f} ms ({r['wmma_device_us']:.1f} us)"
              if "wmma_ms" in r else "")
        print(f"  grouped_bmm_bf16 {r['proj']:>10} {r['b']} rows: "
              f"{r['ms']:.4f} ms, {r['device_us']:.1f} device us "
              f"({r['tflops']:.1f} TFLOP/s, {r['bound_share']:.3f} of the "
              f"bound, {r['route']}){wm}, plain {r['plain_ms']:.4f}, bmm "
              f"{r['library_ms']:.4f} ({r['library_device_us']:.1f} us), "
              f"bound {r['bound_ms']:.4f} ({r['bound_by']})")
    for r in bwd_rows:
        print(f"  flash_bwd S={r['s']} window={r['window']}: dq "
              f"{r['dq_ms']:.4f} ms ({r['dq_tflops']:.1f} TFLOP/s, "
              f"{r['dq_bound_share']:.3f} of the bound "
              f"{r['dq_bound_ms']:.4f}, {r['dq_route']}; softcap 0: "
              f"{r['dq_ms_softcap0']:.4f}), dkv "
              f"{r['dkv_ms']:.4f} ms ({r['dkv_tflops']:.1f} TFLOP/s, "
              f"{r['dkv_bound_share']:.3f} of the bound "
              f"{r['dkv_bound_ms']:.4f}, {r['dkv_route']}), both "
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
          f"{fl['launches']}; step ms (a) "
          f"{[round(t * 1e3, 1) for t in ca['step_s']]}, (b) "
          f"{[round(t * 1e3, 1) for t in fl['step_s']]}; reserved peak (a) "
          f"{ca['peak_reserved_gb']:.1f}, (b) {fl['peak_reserved_gb']:.1f} GB; "
          f"host events (a) {ca['host_events']}, (b) {fl['host_events']}",
          flush=True)
    tp = train_replay(tr["cfg"], tr["state"].params)
    print(f"CPU replay of a training step (2 layers): card {tp['card']}, "
          f"CPU {tp['cpu']} (loss, grad norm)", flush=True)
    tprof = profile_train(tr)
    print_profile("one flash training step", tprof)
    check_flash_routes(tprof, "the flash training profile",
                       ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    check_bmm_routes(tprof)
    train_out = dict(chunked=ca, flash=fl, attn_grad_rel=tr["attn_grad_rel"],
                     tol=dict(loss_rtol=TRAIN_LOSS_RTOL,
                              gnorm_rtol=TRAIN_GNORM_RTOL,
                              attn_grad_rtol=TRAIN_ATTN_GRAD_RTOL))
    del tr
    torch.cuda.empty_cache()
    phase_done(5, "gemma2-2b training")

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

    phase_done(6, "OSEL")

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
    # phase 8 and the Fig. 9 runs go on in processes of their own (each
    # host-bound) while phase 9 runs in this one
    fig9_runs = start_learning_check(dev)
    async_run = in_process(async_phase, str(dev), threads=ASYNC_THREADS,
                           timeout_s=ASYNC_TIMEOUT_S)
    phase_done(7, "IC3Net learner; phase 8 and the Fig. 9 runs started")

    # -- path 6: checkpoints and the fault-tolerant LM loop ----------------
    ck = run_checkpoint(all_kernels, dev)
    print(f"slice 10: gemma2-2b at full width, {ck['cut']}, "
          f"{ck['params']:,} params, {ck['ckpt_bytes']:,} bytes a "
          f"checkpoint ({ck['leaves']} leaves); (a) losses {ck['a']['loss']}, "
          f"(b) stopped at {ck['b']['end']} by SIGTERM, (c) resumed at "
          f"{CKPT_SIGTERM_STEP}, loss {ck['c']['loss']}; (a)'s step-"
          f"{CKPT_STEPS} state and (c)'s checkpoint equal hash for hash; "
          f"launches (a) "
          f"{ck['a']['launches']}, restore {ck['restore_launches']}, (c) "
          f"{ck['c']['launches']}; a corrupted {ck['corrupted']} raised "
          f"IOError, target untouched; the launcher process stopped at 3 "
          f"by SIGTERM and resumed 3->6", flush=True)
    print(f"checkpoint I/O on {card}: {ck['ckpt_bytes'] / 1e9:.3f} GB a "
          f"checkpoint; save {ck['save_s']:.2f} s ({ck['save_gb_s']:.2f} "
          f"GB/s); restore {ck['restore_s']:.2f} s ({ck['restore_gb_s']:.2f} "
          f"GB/s; hashing a state alone {ck['hash_s']:.2f} s); "
          f"phase {ck['wall_s']:.1f} s", flush=True)
    plan_cache.clear()
    torch.cuda.empty_cache()
    phase_done(9, "checkpoints, beside phase 8 and the Fig. 9 runs")

    # -- path 5: the async actor/learner pipeline ---------------------------
    asy = async_run.result()
    an, op, th = asy["anchor"], asy["off_policy"], asy["threaded"]
    print(f"slice 9: async anchor (depth 1, no correction) losses "
          f"{[round(x, 6) for x in an['losses']]} against train's "
          f"{[round(x, 6) for x in an['sync_losses']]}, max parameter "
          f"relative difference {an['param_rel_max']:.3g}; V-trace run "
          f"({op['windows']} windows, {ASYNC_UPDATES} updates): launches "
          f"{op['launches']}, staleness {op['staleness']}; actor rollout "
          f"launches {asy['actor_rollout']['launches']}; CPU replay loss "
          f"{asy['replay']['loss']}, max gradient relative difference "
          f"{max(asy['replay']['grad_rel'].values()):.3g}", flush=True)
    print(f"async throughput on {card}: deterministic driver "
          f"{op['updates_per_s']:.3f} updates/s, {op['env_steps_per_s']:.1f} "
          f"env-steps/s (actor clock); threaded driver "
          f"{th['updates_per_s']:.3f} updates/s, {th['env_steps_per_s']:.1f} "
          f"env-steps/s, staleness {th['staleness']}, {th['windows']} "
          f"windows", flush=True)
    bd = asy["breakdown"]
    print("async update pieces (synchronised wall ms, median of 3): "
          + ", ".join(f"{k} {v:.2f}" for k, v in bd["ms"].items()),
          flush=True)
    print_profile("one async update cycle", bd["profile"])
    print(f"async pipeline (beside phase 9): {asy['wall_s']:.1f} s in its "
          f"own process", flush=True)
    phase_done(8, "async pipeline, joined after phase 9")

    fig9 = learning_check(fig9_runs)
    print(f"Fig. 9 runs (beside phases 8 and 9) joined "
          f"{fig9['wall_s']:.1f} s after they started", flush=True)
    phase_done("7-9", "the Fig. 9 runs joined")

    # -- path 7: the rest of the dense family, served ----------------------
    fam, (g3_cfg, g3_params) = run_dense_family(all_kernels, dev, card)
    phase_done(10, "dense family")
    # -- path 8: paligemma-3b's prefix-LM prefill, gemma3-12b banded -------
    pre = run_prefix(all_kernels, dev, card)
    band = run_banded(g3_cfg, g3_params, all_kernels, card)
    del g3_params
    plan_cache.clear()
    torch.cuda.empty_cache()
    phase_done(11, "prefix-LM and banded prefills")
    # -- path 9: the sync IC3Net launcher ------------------------------------
    sync = run_sync_launcher(all_kernels, dev, card)
    # phase 18 (b)'s dry run goes on on the CPU beside phases 13-17
    dry = start_dryrun()
    phase_done(12, "sync launcher; the dry run started")
    # -- path 10: the MoE family served -------------------------------------
    moe = run_moe(all_kernels, dev, card)
    phase_done(13, "MoE family")
    # -- path 11: the SSM and hybrid families, the grouped MoE trained -----
    ssm_fam = run_ssm_family(all_kernels, dev, card)
    phase_done(14, "SSM and hybrid families, grouped MoE training")
    # -- path 12: whisper-large-v3, the encoder stack and cross-attention --
    wh = run_whisper(all_kernels, dev, card)
    phase_done(15, "whisper-large-v3")
    # -- path 13: the IC3Net learner on an (env, agent) process mesh -------
    torch.cuda.empty_cache()
    mesh_out = run_mesh(all_kernels, dev, card)
    phase_done(16, "IC3Net learner on a process mesh")
    # -- path 14: gemma2-2b trained on a (data, model) process mesh --------
    torch.cuda.empty_cache()
    lm_mesh = run_lm_mesh(dev, card)
    phase_done(17, "gemma2-2b on a (data, model) process mesh")
    # -- phase 18: the analysis layer against the card ---------------------
    analysis = run_analysis(dev, card, lm_mesh, dry, asy)
    phase_done(18, "analysis: launch audit, dry run, contracts")
    replay_wait_s = join_replays()
    print(f"the CPU replays' second halves joined, {replay_wait_s:.1f} s "
          f"after phase 18", flush=True)
    wall_by_function = {k: dict(calls=n, s=t) for k, (n, t) in sorted(
        _WALL.items(), key=lambda kv: -kv[1][1])}
    print("wall s by function (inclusive, this process): " + ", ".join(
        f"{k} {v['s']:.1f} ({v['calls']}x)"
        for k, v in wall_by_function.items()), flush=True)

    def total(rows, key):
        return sum(r[key] for r in rows)

    def path_launches(sym):
        return {"ic3net_actor": sl["launches"][sym],
                "gemma2_serve": sv["launches"][sym],
                "gemma2_train_chunked": ca["launches"][sym],
                "gemma2_train_flash": fl["launches"][sym],
                "osel": os_["launches"] if sym == "osel_encode" else 0,
                "ic3net_learner": learner_out["launches"][sym],
                "ic3net_async": op["launches"][sym],
                "gemma2_ckpt": ck["launches"][sym],
                **family_launches(fam, pre, band, sync, sym),
                **moe_launches(moe, sym), **ssm_launches(ssm_fam, sym),
                **whisper_launches(wh, sym), **mesh_launches(mesh_out, sym),
                **lm_mesh_launches(lm_mesh, sym)}

    def launches(sym):
        return sum(path_launches(sym).values())

    prefill_layer = [r for r in fused_rows if r["rows"] == 4096]
    decode_layer = [r for r in fused_rows
                    if r["rows"] == 4 and "bfloat16" in r["dtype"]]
    prefill_flops = sum(2 * r["g"] * r["rows"] * r["cap_m"] * r["cap_n"]
                        for r in prefill_layer)
    train_layer = [r for r in bmm16_rows if r["b"] == TRAIN_BATCH * TRAIN_SEQ]
    train_flops = sum(2 * r["g"] * r["b"] * r["k"] * r["n"]
                      for r in train_layer)
    bwd_timed = (f"one call at B={TRAIN_BATCH}, Hq=8, Hkv=4, S={TRAIN_SEQ}, "
                 "D=256, causal, window 0, softcap 50, bf16; bound: dq "
                 "6 D, dkv 8 D flops per allowed (query, key) pair at 989 "
                 "TFLOP/s (bf16 tensor cores); f32_cores_bound_ms: the same "
                 "flops at 67 TFLOP/s (the FP32 FMA route of f32 calls); "
                 "dq's ms_softcap0 at softcap 0; plain ms and library ms "
                 "(SDPA's backward, softcap 0) compute dq, dk and dv "
                 "together")
    per_encode = "one encode: its calls at the path's 10 FLGW layer sides"
    fk = family_kernel_rows(fam, pre)
    family_tiled = fk["tiled"]

    def per_side(rows):
        return [{k: r[k] for k in (
            "side", "layers", "items", "groups", "ms", "device_us",
            "profiler_recorded_launches", "plain_ms", "bound_ms",
            "bound_share", "sort_yardstick_ms")}
            for r in rows]

    def whisper_bwd(r, name):
        return dict({k: r[k] for k in ("b", "hq", "hkv", "d", "s", "window",
                                        "softcap", "plain_ms", "library_ms")},
                    max_abs_err=r["max_abs_err"], ms=r[f"{name}_ms"],
                    bound_ms=r[f"{name}_bound_ms"],
                    bound_by=r[f"{name}_bound_by"],
                    bound_share=r[f"{name}_bound_share"],
                    tflops=r[f"{name}_tflops"], route=r[f"{name}_route"])

    jamba = ssm_fam["jamba_1_5_large"]
    mamba = ssm_fam["mamba2_1_3b"]
    moe_train = ssm_fam["mixtral_8x22b_train"]

    def timed_sides(rows, name):
        return [dict(side=r["side"], layers=r["layers"], items=r["items"],
                     **{k: r[name][k] for k in (
                         "ms", "plain_ms", "bound_ms", "device_us")})
                for r in rows if name in r]

    def tiled_entry(name, line):
        t = tiled[name]
        on_path = timed_sides(family_tiled, name)
        return dict(name=f"plan_{name}", route="cuda",
                    source="src/repro_torch/csrc/plan_encode.cu",
                    replaces=f"src/repro/kernels/plan_encode/plan_encode.py:"
                             f"{line}",
                    launches=launches(f"plan_{name}"),
                    launches_by_path=path_launches(f"plan_{name}"),
                    max_abs_err=t["max_abs_err"], ms=t["ms"],
                    plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                    bound_by=t["bound_by"], library_ms=None,
                    device_us_per_launch=t["device_us"],
                    profiler_recorded_launches=t[
                        "profiler_recorded_launches"],
                    gemma2_27b_sides=on_path,
                    jamba_sides=timed_sides(jamba["assign"]["tiled"], name),
                    timed_over=f"one call at L, M, G = {TILED_SIDE} (past "
                               "the sort route's limit, the tiled route); "
                               "bound by bytes at 3.35 TB/s; "
                               "gemma2_27b_sides: the d_ff sides of the "
                               "gemma2-27b serving path (L = 2 a slot)")

    kernels_line = {"kernels": [
        dict(name="plan_assign", route="cuda",
             source="src/repro_torch/csrc/plan_encode.cu",
             replaces="src/repro/kernels/plan_encode/plan_encode.py:50 and "
                      ":81 (_rank_kernel + _place_kernel, one launch)",
             launches=launches("plan_assign"),
             launches_by_path=path_launches("plan_assign"),
             max_abs_err=max(r["max_abs_err"]
                             for r in assign_rows + lm_assign_rows),
             ms=total(assign_rows, "ms"),
             plain_ms=total(assign_rows, "plain_ms"),
             bound_ms=total(assign_rows, "bound_ms"), bound_by="bytes",
             library_ms=None,
             device_us_per_launch=statistics.mean(
                 r["device_us"] for r in assign_rows
                 if r["device_us"] is not None),
             profiler_recorded_launches=sum(
                 r["profiler_recorded_launches"] for r in assign_rows),
             profiler_calls=sum(r["profiler_calls"] for r in assign_rows),
             sort_yardstick_ms=total(assign_rows, "sort_yardstick_ms"),
             ic3net_sides=per_side(assign_rows),
             lm_sides=per_side(lm_assign_rows),
             dense_family_sides=fk["sort"],
             moe_sides=[dict(arch=a, **{k: r[k] for k in (
                 "side", "layers", "items", "axis", "ms", "device_us",
                 "plain_ms", "bound_ms")}) for a, f in moe.items()
                 for r in f["assign"]["sort"] if "ms" in r],
             ssm_sides=[dict(arch=a, **{k: r[k] for k in (
                 "side", "layers", "items", "axis", "ms", "device_us",
                 "plain_ms", "bound_ms")})
                 for a, f in (("mamba2_1_3b", mamba),
                              ("jamba_1_5_large", jamba))
                 for r in f["assign"]["sort"] if "ms" in r],
             whisper_sides=[{k: r[k] for k in (
                 "side", "layers", "items", "axis", "ms", "device_us",
                 "plain_ms", "bound_ms")}
                 for r in wh["assign"]["sort"] if "ms" in r],
             encode=enc_t,
             ptxas={f"plan_assign_kernel<{tier}>": pe_usage.get(
                 f"plan_assign_kernel<{tier}>") for tier in ASSIGN_TIERS},
             timed_over=per_encode + " (ms, plain ms, bound, sort "
                        "yardstick: sums over the 10, each timed at its "
                        "side; device us: the mean over the 10 of the "
                        "profiler's over 20 calls each); lm_sides: "
                        "gemma2-2b's sides, one call each; bound by bytes "
                        "(scores read once, ids and group written once) at "
                        "3.35 TB/s; sort_yardstick_ms: torch.sort(stable) "
                        "of an (L, M) int64 key, the sort step alone, no "
                        "library call computes the function"),
        tiled_entry("rank", 50),
        tiled_entry("place", 81),
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
             device_us_per_launch=total(bmm_rows, "device_us") / len(bmm_rows),
             library_device_us=total(bmm_rows, "library_device_us")
             / len(bmm_rows),
             host_us_per_call=dict(
                 ours=total(bmm_rows, "host_us") / len(bmm_rows),
                 library=total(bmm_rows, "library_host_us") / len(bmm_rows)),
             compute_route="fp32 fma, 32-row x 32/64-column tiles",
             ptxas={name: fm_usage.get(name) for name in (
                 "grouped_bmm_f32_kernel<32>", "grouped_bmm_f32_kernel<64>")},
             timed_over="one policy step: its calls at the path's 5 FLGW "
                        "layers; device and host us: means over the 5 "
                        "(the profiler's device time a call; host: the "
                        "time for a call to return); library = torch.bmm"),
        dict(name="grouped_bmm_bf16", route="cuda",
             source="src/repro_torch/csrc/flgw_matmul.cu",
             replaces="src/repro/kernels/flgw_matmul/flgw_matmul.py:38",
             launches=launches("grouped_bmm_bf16"),
             launches_by_path=path_launches("grouped_bmm_bf16"),
             max_abs_err=max([r["max_abs_err"] for r in bmm16_rows] + [
                 r["grouped_bmm_bf16"]["max_abs_err"]
                 for r in mamba["train_rows"] + moe_train["kernel_rows"]
                 + wh["kernel_rows"] if "grouped_bmm_bf16" in r]),
             ms=total(train_layer, "ms"),
             plain_ms=total(train_layer, "plain_ms"),
             bound_ms=total(train_layer, "bound_ms"),
             bound_by=max(train_layer,
                          key=lambda r: r["bound_ms"])["bound_by"],
             library_ms=total(train_layer, "library_ms"),
             device_us_per_launch=total(train_layer, "device_us")
             / len(train_layer),
             library_device_us=total(train_layer, "library_device_us")
             / len(train_layer),
             tflops=train_flops / total(train_layer, "ms") / 1e9,
             bound_share=(total(train_layer, "bound_ms")
                          / total(train_layer, "ms")),
             tensor_core_route=BMM16_ROUTES[fm_ops.TMA],
             wmma=dict(ms=total(train_layer, "wmma_ms"),
                       device_us_per_launch=total(train_layer,
                                                  "wmma_device_us")
                       / len(train_layer)),
             ptxas={name: fm_usage.get(name) for name in (
                 "grouped_bmm_tma_kernel", "grouped_bmm_bf16_kernel<128>")},
             moe=[dict(proj=r["proj"], tiles=r["tiles"], rows=r["rows"],
                       cap_m=r["cap_m"], cap_n=r["cap_n"],
                       **r["grouped_bmm_bf16"])
                  for f in moe.values() for r in f["kernel_rows"]
                  if "grouped_bmm_bf16" in r],
             ssm_train=[dict(arch=r["arch"], proj=r["proj"], tiles=r["tiles"],
                             rows=r["rows"], cap_m=r["cap_m"],
                             cap_n=r["cap_n"], **r["grouped_bmm_bf16"])
                        for r in mamba["train_rows"] + moe_train["kernel_rows"]],
             whisper_train=[dict(proj=r["proj"], tiles=r["tiles"],
                                 rows=r["rows"], cap_m=r["cap_m"],
                                 cap_n=r["cap_n"], **r["grouped_bmm_bf16"])
                            for r in wh["kernel_rows"]
                            if "grouped_bmm_bf16" in r],
             timed_over="one training layer's forward: its 3 MLP products "
                        "(up, gate, down) at 4096 rows, bf16; bound at 989 "
                        "TFLOP/s (bf16 tensor cores); device us a launch: "
                        "the mean of the 3; library = torch.bmm on the same "
                        "compact operands; wmma = the first design on the "
                        "same calls"),
        dict(name="fused_bmm", route="cuda",
             source="src/repro_torch/csrc/flgw_matmul.cu",
             replaces="src/repro/kernels/flgw_matmul/flgw_matmul.py:93",
             launches=launches("fused_bmm"),
             launches_by_path=path_launches("fused_bmm"),
             max_abs_err=max(r["max_abs_err"] for r in fused_rows + [
                 r for f in moe.values() for r in f["kernel_rows"]]
                 + mamba["kernel_rows"] + jamba["kernel_rows"]
                 + wh["kernel_rows"]),
             ms=total(prefill_layer, "ms"),
             plain_ms=total(prefill_layer, "plain_ms"),
             bound_ms=total(prefill_layer, "bound_ms"),
             bound_by=max(prefill_layer,
                          key=lambda r: r["bound_ms"])["bound_by"],
             library_ms=total(prefill_layer, "library_ms"),
             tflops=prefill_flops / total(prefill_layer, "ms") / 1e9,
             bound_share=(total(prefill_layer, "bound_ms")
                          / total(prefill_layer, "ms")),
             tensor_core_route=FUSED_ROUTES["prefill"],
             decode=dict(ms=total(decode_layer, "ms"),
                         ms_cold=total(decode_layer, "ms_cold"),
                         plain_ms=total(decode_layer, "plain_ms"),
                         bound_ms=total(decode_layer, "bound_ms"),
                         bound_by=max(decode_layer, key=lambda r: r[
                             "bound_ms"])["bound_by"],
                         library_ms=total(decode_layer, "library_ms"),
                         route=FUSED_ROUTES["decode"]),
             ptxas={name: fm_usage.get(name) for name in (
                 "fused_bmm_wgmma_kernel", "fused_bmm_stream_kernel<4>")},
             dense_family_down=fk["fused_down"],
             moe=[{k: v for k, v in r.items() if k != "grouped_bmm_bf16"}
                  for f in moe.values() for r in f["kernel_rows"]],
             ssm_family=mamba["kernel_rows"] + jamba["kernel_rows"],
             whisper=[{k: v for k, v in r.items() if k != "grouped_bmm_bf16"}
                      for r in wh["kernel_rows"]],
             timed_over="one prefill layer: its 7 projections at 4096 rows, "
                        "bf16; bound at 989 TFLOP/s (bf16 tensor cores); "
                        "library = torch.bmm on pre-gathered operands, "
                        "gather not counted; decode: the same 7 at 4 rows, "
                        "ms on one wc each (in L2), ms_cold over a ring of "
                        "wc copies larger than L2, bound by wc's bytes at "
                        "3.35 TB/s"),
        dict(name="flash_fwd", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/"
                      "flash_attention.py:67",
             launches=launches("flash_fwd"),
             launches_by_path=path_launches("flash_fwd"),
             max_abs_err=max(r["max_abs_err"]
                             for r in flash_rows + wh["flash_rows"]),
             ms=flash_rows[1]["ms"], plain_ms=flash_rows[1]["plain_ms"],
             bound_ms=flash_rows[1]["bound_ms"],
             bound_by=flash_rows[1]["bound_by"],
             library_ms=flash_rows[1]["library_ms"],
             ms_softcap0=flash_rows[1]["ms_softcap0"],
             tflops=flash_rows[1]["tflops"],
             bound_share=flash_rows[1]["bound_share"],
             tensor_core_route=flash_rows[1]["route"],
             ptxas=fa_usage.get("flash_fwd_wgmma_kernel<256>"),
             ptxas_d128=fa_usage.get("flash_fwd_wgmma_kernel<128>"),
             ptxas_d64=fa_usage.get("flash_fwd_wgmma_kernel<64>"),
             dense_family=fk["flash"],
             moe=[dict(arch=a, **{k: r[k] for k in (
                 "hq", "hkv", "d", "s", "window", "softcap", "max_abs_err",
                 "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                 "bound_share", "tflops", "route")})
                  for a, f in moe.items() for r in f["flash_rows"]],
             jamba=[{k: r[k] for k in (
                 "b", "hq", "hkv", "d", "s", "window", "softcap",
                 "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                 "bound_by", "bound_share", "tflops", "route")}
                 for r in jamba["flash_rows"]],
             whisper=[{k: r[k] for k in (
                 "b", "hq", "hkv", "d", "s", "window", "softcap",
                 "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                 "bound_by", "bound_share", "tflops", "route")}
                 for r in wh["flash_rows"]],
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
             max_abs_err=max(r["max_abs_err"]["dq"]
                             for r in bwd_rows + wh["bwd_rows"]),
             ms=bwd_rows[1]["dq_ms"], plain_ms=bwd_rows[1]["plain_ms"],
             bound_ms=bwd_rows[1]["dq_bound_ms"],
             bound_by=bwd_rows[1]["dq_bound_by"],
             f32_cores_bound_ms=bwd_rows[1]["dq_f32_cores_bound_ms"],
             library_ms=bwd_rows[1]["library_ms"],
             ms_softcap0=bwd_rows[1]["dq_ms_softcap0"],
             tflops=bwd_rows[1]["dq_tflops"],
             bound_share=bwd_rows[1]["dq_bound_share"],
             tensor_core_route=bwd_rows[1]["dq_route"],
             ptxas=fa_usage.get("flash_bwd_dq_mma_kernel<256>"),
             ptxas_d64=fa_usage.get("flash_bwd_dq_mma_kernel<64>"),
             whisper=[whisper_bwd(r, "dq") for r in wh["bwd_rows"]],
             timed_over=bwd_timed),
        dict(name="flash_bwd_dkv", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/"
                      "flash_attention.py:205",
             launches=launches("flash_bwd_dkv"),
             launches_by_path=path_launches("flash_bwd_dkv"),
             max_abs_err=max(max(r["max_abs_err"]["dk"],
                                 r["max_abs_err"]["dv"])
                             for r in bwd_rows + wh["bwd_rows"]),
             ms=bwd_rows[1]["dkv_ms"], plain_ms=bwd_rows[1]["plain_ms"],
             bound_ms=bwd_rows[1]["dkv_bound_ms"],
             bound_by=bwd_rows[1]["dkv_bound_by"],
             f32_cores_bound_ms=bwd_rows[1]["dkv_f32_cores_bound_ms"],
             library_ms=bwd_rows[1]["library_ms"],
             tflops=bwd_rows[1]["dkv_tflops"],
             bound_share=bwd_rows[1]["dkv_bound_share"],
             tensor_core_route=bwd_rows[1]["dkv_route"],
             ptxas=fa_usage.get("flash_bwd_dkv_mma_kernel<256>"),
             ptxas_d64=fa_usage.get("flash_bwd_dkv_mma_kernel<64>"),
             whisper=[whisper_bwd(r, "dkv") for r in wh["bwd_rows"]],
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
        build_s=build_s, build_logs=logs, assign_rows=assign_rows,
        lm_assign_rows=lm_assign_rows, tiled_route=tiled, encode=enc_t,
        bmm_rows=bmm_rows, slice=sl, profile=prof, serve_params=n_params,
        fused_rows=fused_rows, flash_rows=flash_rows, serve=sv, replay=rp,
        serve_profile=sprof, bmm16_rows=bmm16_rows, flash_bwd_rows=bwd_rows,
        train=train_out, train_replay=tp, train_profile=tprof,
        osel=os_, fpga_model=fpga, learner=learner_out,
        learner_replay=lrep, learner_profile=lprof, learning_check=fig9,
        async_pipeline=asy, checkpoint=ck, dense_family=fam,
        prefix_lm=pre, banded=band, sync_launcher=sync, moe_family=moe,
        ssm_family=ssm_fam, whisper=wh, mesh=mesh_out, lm_mesh=lm_mesh,
        analysis=analysis,
        phase_s=phase_s,
        wall_by_function=wall_by_function,
        script_s=time.perf_counter() - t_script,
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
