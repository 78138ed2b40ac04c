"""Serving step factories: the building blocks of ``ServeSession``.

Port of ``repro.serving.steps``. PyTorch runs eagerly, so the factories
return plain functions. The one policy knob is ``plan_policy``:

* ``"certify"``: cached PlanStates are signature-checked at request
  boundaries and re-encoded iff the grouping layout moved;
* ``"trust"``: cached PlanStates are consumed unconditionally;
* ``"off"``: no plan caching; grouped projections re-encode per call.

On a ``(data, model)`` mesh (``mesh=``, ``global_batch=``) the params
are DTensors (``partition.distribute`` by ``train.state.param_specs``)
and a decode cache is ``transformer.init_cache(mesh=)``'s. Each rank
takes its rows of the global batch, split over ``data`` only
(``partition.batch_rows(spread=False)``), so the ``model`` ranks hold
the same rows; each layer slot's weights are gathered whole just before
it computes (``partition.gatherer``), the top-level ``embed`` and norms
once a call; the plans are certified or encoded from the gathered
grouping matrices, the same on every rank. The ``model`` ranks split
three pieces of work, each put back together with a counted collective:
the compact products' capN columns (``core.grouped._core_matmul``
under ``partition.use_constraints``), the decode cache's KV sequence
(``models.attention``, combined by log-sum-exp) and an SSM state's heads
and conv channels (``models.ssm``). A one-rank mesh gives the no-mesh
step's result bitwise.
"""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor

from repro_torch.analysis import contracts

from repro_torch.core import encoder as planenc
from repro_torch.models import transformer
from repro_torch.models.layers import softcap, unembed
from repro_torch.sharding import partition

PLAN_POLICIES = ("certify", "trust", "off")
# the param tree's top-level leaves a mesh step gathers once a call (the
# layer slots gather their own as they compute)
_TOP = ("embed", "final_norm", "enc_norm")


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


class _OnMesh:
    """What a mesh step does around ``lm_apply`` (see the module
    docstring): this rank's rows, the weights as local shards with the
    gather hook and the top-level leaves whole, the plans' view of the
    params (whole grouping matrices beside the weights' shards), and the
    constraint mesh of the compact products' column split."""

    def __init__(self, cfg, mesh, global_batch):
        if global_batch is None:
            raise ValueError("a mesh step needs global_batch")
        self.mesh = mesh
        self.grouped = cfg.flgw_groups > 1 and cfg.flgw_path == "grouped"
        self.lo, self.hi, _ = partition.batch_rows(mesh, global_batch,
                                                   spread=False)

    def check_rows(self, tokens) -> None:
        if tokens.shape[0] != self.hi - self.lo:
            raise ValueError(
                f"a mesh step takes this rank's {self.hi - self.lo} rows "
                f"[{self.lo}, {self.hi}) of the global batch, got "
                f"{tokens.shape[0]}")

    def params(self, sharded):
        """(local params, top-level leaves whole; the gather hook)."""
        gather = partition.gatherer(sharded)
        params = partition.local(sharded)
        return dict(params, **{k: gather(params[k], (k,))
                               for k in _TOP if k in params}), gather

    def view(self, sharded, params):
        """What a plan encode or certification reads: the grouping
        matrices whole beside the weights' shards, on the grouped path
        (``params`` off it)."""
        return partition.gather_grouping(sharded, weights=True) \
            if self.grouped else params

    def constraints(self):
        return partition.use_constraints(self.mesh)


def _last_logits(params, cfg, hidden):
    """The last position's logits (B, 1, vocab) in float32: the
    unembedding of that row only."""
    return softcap(unembed(params["embed"], hidden[:, -1:]).float(),
                   cfg.logit_softcap)


def make_decode_step(cfg, *, banded: bool = False, mesh=None,
                     global_batch: int | None = None,
                     return_logits: bool = False):
    """Returns ``decode_step(params, cache, tokens, positions) ->
    (next_tok (B, 1) int32, cache)``: one greedy token against the KV
    caches, lockstep or per-slot; with ``return_logits`` also the last
    position's logits (B, 1, vocab) float32, ``(next_tok, cache,
    logits)``. The logits are the unembedding of the last position only.
    ``banded`` is accepted and changes nothing: a decode step attends its
    ring buffer, as in JAX.

    ``mesh``: a ``(data, model)`` DeviceMesh; ``params`` and ``cache``
    then DTensors (``transformer.init_cache(mesh=)``), ``tokens`` and
    ``positions`` this rank's rows of ``global_batch``
    (``partition.batch_rows(spread=False)``), and the step returns this
    rank's rows' tokens with the sharded cache, its shards written in
    place (see the module docstring)."""
    on = None if mesh is None else _OnMesh(cfg, mesh, global_batch)

    @torch.inference_mode()
    def decode_step(params, cache, tokens, positions):
        contracts.record("decode_step", params, cache, tokens, positions)
        kw, sharded = {}, cache
        if on is not None:
            on.check_rows(tokens)
            params, kw["gather"] = on.params(params)
            kw["cache_split"] = transformer.cache_groups(cache)
            cache = partition.local(cache)
        with on.constraints() if on else contextlib.nullcontext():
            hidden, _, cache = transformer.lm_apply(
                params, cfg, tokens, positions, cache=cache, banded=banded,
                return_hidden=True, **kw)
            logits = _last_logits(params, cfg, hidden)
        next_tok = logits.argmax(-1).to(torch.int32)
        if on is not None:
            # the shards were written in place; the new offset is this
            # rank's part of the cache's pos
            pos = sharded["pos"]
            cache = dict(sharded, pos=DTensor.from_local(
                cache["pos"], pos.device_mesh, list(pos.placements),
                run_check=False, shape=pos.shape, stride=pos.stride()))
        return (next_tok, cache, logits) if return_logits else \
            (next_tok, cache)

    return decode_step


def make_prefill_step(cfg, *, plan_policy: str = "certify",
                      banded: bool = False, q_chunk: int | None = None,
                      mesh=None, global_batch: int | None = None):
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

    ``mesh``: a ``(data, model)`` DeviceMesh; ``params`` (and given
    ``plans``, e.g. a mesh cache's) then DTensors, ``batch`` this rank's
    rows of ``global_batch``; it returns those rows' last logits (see
    the module docstring).
    """
    check_plan_policy(plan_policy)
    on = None if mesh is None else _OnMesh(cfg, mesh, global_batch)

    @torch.inference_mode()
    def prefill_step(params, batch, plans=None):
        contracts.record("prefill_step", params, batch, plans)
        qc = q_chunk or pick_q_chunk(batch["tokens"].shape[1])
        gather, sharded = None, params
        if on is not None:
            on.check_rows(batch["tokens"])
            params, gather = on.params(params)
            plans = partition.local(plans)

        def view():
            return params if on is None else on.view(sharded, params)
        if plan_policy == "off":
            plans = None
        elif plans is None:
            plans = transformer.encode_plans(view(), cfg)
        elif (plan_policy == "certify"
              and isinstance(plans, planenc.PlanState) and plans.plans):
            v = view()
            plans = planenc.refresh_if_stale(
                v, plans, lambda: transformer.encode_plans(v, cfg))
        with on.constraints() if on else contextlib.nullcontext():
            hidden, _, _ = transformer.lm_apply(
                params, cfg, batch["tokens"], batch["positions"],
                patch_embeds=batch.get("patch_embeds"),
                frames=batch.get("frames"), q_chunk=qc,
                banded=banded, return_hidden=True, moe_dropless=True,
                plans=plans, gather=gather)
            # only the last position's logits are needed to start decoding
            return _last_logits(params, cfg, hidden)

    return prefill_step
