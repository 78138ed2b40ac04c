"""Serving step factories: the building blocks of ``ServeSession``.

Port of ``repro.serving.steps``. PyTorch runs eagerly, so the factories
return plain functions. The one policy knob is ``plan_policy``:

* ``"certify"``: cached PlanStates are signature-checked at request
  boundaries and re-encoded iff the grouping layout moved;
* ``"trust"``: cached PlanStates are consumed unconditionally;
* ``"off"``: no plan caching; grouped projections re-encode per call.
"""
from __future__ import annotations

import torch

from repro_torch.core import encoder as planenc
from repro_torch.models import transformer
from repro_torch.models.layers import softcap, unembed

PLAN_POLICIES = ("certify", "trust", "off")


def check_plan_policy(plan_policy: str) -> str:
    if plan_policy not in PLAN_POLICIES:
        raise ValueError(
            f"plan_policy must be one of {PLAN_POLICIES}, got "
            f"{plan_policy!r}")
    return plan_policy


def pick_q_chunk(s: int, pref: int = 512) -> int:
    """Largest divisor of ``s`` that is <= pref and a multiple of 128 (or
    s); a copy of ``repro.train.step.pick_q_chunk``."""
    if s <= pref:
        return s
    for c in range(pref, 127, -128):
        if s % c == 0:
            return c
    for c in range(pref, 0, -1):
        if s % c == 0:
            return c
    return s


def make_decode_step(cfg, *, banded: bool = False):
    """Returns ``decode_step(params, cache, tokens, positions) ->
    (next_tok (B, 1) int32, cache)``: one greedy token against the KV
    caches, lockstep or per-slot. ``banded`` is accepted and changes
    nothing: a decode step attends its ring buffer, as in JAX."""

    @torch.inference_mode()
    def decode_step(params, cache, tokens, positions):
        logits, _, cache = transformer.lm_apply(
            params, cfg, tokens, positions, cache=cache, banded=banded)
        next_tok = logits[:, -1:].argmax(-1).to(torch.int32)
        return next_tok, cache

    return decode_step


def make_prefill_step(cfg, *, plan_policy: str = "certify",
                      banded: bool = False, q_chunk: int | None = None):
    """Returns ``prefill(params, batch, plans=None) -> last logits``
    (B, 1, vocab) float32: the full-sequence forward, its MoE slots
    dropless (every expert takes t·k rows, as in JAX). ``batch`` holds
    ``tokens`` and ``positions``, for a VLM ``patch_embeds`` and for an
    encoder-decoder (whisper) ``frames``. As in JAX, only the last
    logits come back: the encoder's output does not outlive the call (a
    decode conditioned on the audio starts from ``lm_apply(frames=...,
    cache=...)``, which writes it into the cache).
    ``banded`` and ``q_chunk`` (default :func:`pick_q_chunk` of the token
    count) go to the chunked attention core. A model with SSM slots
    prefills in ``min(cfg.ssm_chunk, S)``-token chunks, which must divide
    S (``models.ssm`` raises otherwise, as the JAX package asserts).

    ``certify`` checks caller-supplied plans against the params (one
    signature pass, a re-encode iff the layout moved), ``trust`` takes
    them as they are, and both encode once when given none; ``off``
    ignores them and re-encodes per projection.
    """
    check_plan_policy(plan_policy)

    @torch.inference_mode()
    def prefill_step(params, batch, plans=None):
        qc = q_chunk or pick_q_chunk(batch["tokens"].shape[1])
        if plan_policy == "off":
            plans = None
        elif plans is None:
            plans = transformer.encode_plans(params, cfg)
        elif (plan_policy == "certify"
              and isinstance(plans, planenc.PlanState) and plans.plans):
            plans = planenc.refresh_if_stale(
                params, plans, lambda: transformer.encode_plans(params, cfg))
        hidden, _, _ = transformer.lm_apply(
            params, cfg, batch["tokens"], batch["positions"],
            patch_embeds=batch.get("patch_embeds"),
            frames=batch.get("frames"), q_chunk=qc,
            banded=banded, return_hidden=True, moe_dropless=True,
            plans=plans)
        # only the last position's logits are needed to start decoding
        logits = unembed(params["embed"], hidden[:, -1:])
        return softcap(logits.float(), cfg.logit_softcap)

    return prefill_step
