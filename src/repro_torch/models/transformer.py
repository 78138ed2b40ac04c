"""Pattern-stacked transformer assembly: dense, MoE, SSM and hybrid.

Port of ``repro.models.transformer``. The stack is ``n_blocks`` blocks of
the ``period`` slots of ``cfg.pattern``; per-slot parameters, plans and
KV caches are stacked on axis 0 as in the JAX package (so a param tree
converts one to one), and a Python loop over the blocks takes the place
of ``lax.scan``, slicing every stacked leaf.

Ported: the dense family (attention mixers, MLP FFNs), the MoE family
(``moe`` FFNs and ``moe_dense``, a MoE beside a parallel dense MLP
residual; ``models.moe``), the SSM mixers (``models.ssm``; with
``ffn="none"`` a slot is a pure Mamba2 block, as mamba2-1.3b's; jamba
interleaves attention, SSM, MLP and MoE slots), the VLM's prefix-LM
backbone (``patch_embeds`` ahead of the tokens, attended both ways),
whisper-large-v3's encoder-decoder (an ``encoder`` stack of
bidirectional attention + MLP layers run over ``frames``, and a
cross-attention layer in every decoder slot reading its output), the
banded prefill (``banded``) and ``remat`` (each layer slot under a
non-reentrant ``torch.utils.checkpoint``, so the backward recomputes one
layer at a time from its input, as ``jax.checkpoint`` around the JAX
package's block body). ``unroll_blocks``, ``attn_identity`` and
``ssd_unroll``, the JAX package's dry-run cost variants, which eager
PyTorch has no use for, raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.core import encoder as planenc
from repro_torch.core.flgw import FLGWConfig
from repro_torch.core.grouped import GroupPlan
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig, SlotSpec
from repro_torch.models.layers import (embed, embed_init, embed_specs, mlp,
                                       mlp_init, mlp_specs, plan_of, rmsnorm,
                                       rmsnorm_init, rmsnorm_specs, softcap,
                                       unembed)
from repro_torch.sharding import partition

_UNPORTED = "is not ported to repro_torch yet (ROADMAP, Queue 1)"


def _unported(what: str):
    return NotImplementedError(f"{what} {_UNPORTED}")


# the encoder stack's layer (whisper's): bidirectional attention + MLP
ENC_SLOT = SlotSpec(mixer="attn", window=0, ffn="mlp", causal=False)


def _check_supported(cfg: ModelConfig) -> None:
    for slot in cfg.pattern:
        if slot.mixer not in ("attn", "ssm"):
            raise _unported(f"the {slot.mixer!r} mixer")
        if slot.ffn not in ("mlp", "moe", "moe_dense", "none"):
            raise _unported(f"the {slot.ffn!r} FFN")


def needs_frames(cfg: ModelConfig) -> bool:
    """Whether the model's decoder cross-attends to an encoder's output
    (whisper's), which only ``frames`` or a decode cache can give."""
    return any(slot.cross for slot in cfg.pattern)


def no_frames_error(cfg: ModelConfig, where: str = "lm_apply") -> ValueError:
    """The refusal of a cross-attending model run without frames. The JAX
    package runs on there: its cross layer, given ``kv_x=None``, takes k
    and v from the decoder's own stream with RoPE and no causal mask
    (src/repro/models/attention.py:103-112), so every position sees the
    later tokens (ROADMAP, Queue 3). The port does not mirror that."""
    return ValueError(
        f"{where}: {cfg.name} cross-attends to its audio encoder's output, "
        "and no frames were given (frames=, or a decode cache holding "
        "encoder_out). The JAX reference runs on without them, its cross "
        "layer then attending the decoder's own tokens with no causal mask "
        "(src/repro/models/attention.py:103-112), so each position sees "
        "later tokens; the port refuses instead")


def _flgw_cfg(cfg: ModelConfig, target: str) -> Optional[FLGWConfig]:
    if not cfg.flgw_on(target):
        return None
    return FLGWConfig(groups=cfg.flgw_groups, path=cfg.flgw_path)


def encode_plans(params: dict, cfg: ModelConfig) -> planenc.PlanState:
    """One encode pass over the stack's FLGW projections; plans of the
    stacked blocks come back stacked on the same leading axis. The empty
    state unless the compact ``grouped`` path is on."""
    if cfg.flgw_groups <= 1 or cfg.flgw_path != "grouped":
        return planenc.empty_state(params["embed"]["embedding"].device)
    return planenc.encode_plans(
        params, FLGWConfig(groups=cfg.flgw_groups, path=cfg.flgw_path))


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _slot_init(generator, cfg: ModelConfig, slot: SlotSpec, n: int) -> dict:
    lead = (n,)
    dev = generator.device
    p = {"norm1": rmsnorm_init(cfg.d_model, device=dev, lead=lead)}
    if slot.mixer == "attn":
        p["mixer"] = attn_mod.attn_init(generator, cfg,
                                        flgw=_flgw_cfg(cfg, "attn"),
                                        lead=lead)
    else:
        p["mixer"] = ssm_mod.ssm_init(generator, cfg,
                                      flgw=_flgw_cfg(cfg, "ssm"), lead=lead)
    if slot.cross:
        p["norm_x"] = rmsnorm_init(cfg.d_model, device=dev, lead=lead)
        p["cross"] = attn_mod.attn_init(generator, cfg,
                                        flgw=_flgw_cfg(cfg, "attn"),
                                        lead=lead)
    if slot.ffn == "none":     # a pure SSM block (mamba2) has no FFN
        return p
    p["norm2"] = rmsnorm_init(cfg.d_model, device=dev, lead=lead)
    if slot.ffn != "mlp":
        p["moe"] = moe_mod.moe_init(generator, cfg,
                                    flgw=_flgw_cfg(cfg, "moe"), lead=lead)
    if slot.ffn != "moe":     # mlp, or moe_dense's parallel dense residual
        p["ffn"] = mlp_init(generator, cfg.d_model, cfg.d_ff,
                            gated=cfg.gated_mlp, flgw=_flgw_cfg(cfg, "mlp"),
                            dtype=cfg.dtype, lead=lead)
    return p


def lm_init(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Random params on ``generator``'s device, laid out as the JAX
    package's ``lm_init`` tree (:func:`lm_specs` gives its specs). Weights are
    N(0, 1/fan_in) in ``cfg.dtype``; grouping matrices and norms f32. An
    encoder-decoder adds ``encoder`` (``encoder_layers`` stacked
    ENC_SLOT layers) and ``enc_norm``."""
    _check_supported(cfg)
    params = {
        "embed": embed_init(generator, cfg.vocab, cfg.d_model, cfg.dtype),
        "blocks": {f"slot{i}": _slot_init(generator, cfg, slot, cfg.n_blocks)
                   for i, slot in enumerate(cfg.pattern)},
        "final_norm": rmsnorm_init(cfg.d_model, device=generator.device),
    }
    if cfg.encoder_layers:
        params["encoder"] = {"slot0": _slot_init(generator, cfg, ENC_SLOT,
                                                 cfg.encoder_layers)}
        params["enc_norm"] = rmsnorm_init(cfg.d_model,
                                          device=generator.device)
    return params


def _slot_specs(cfg: ModelConfig, slot: SlotSpec) -> dict:
    """One slot's spec tree, its leaves led by the stacking ``"layers"``
    axis (the JAX package prepends it after the vmap)."""
    s = {"norm1": rmsnorm_specs()}
    if slot.mixer == "attn":
        s["mixer"] = attn_mod.attn_specs(flgw=_flgw_cfg(cfg, "attn"))
    else:
        s["mixer"] = ssm_mod.ssm_specs(flgw=_flgw_cfg(cfg, "ssm"))
    if slot.cross:
        s["norm_x"] = rmsnorm_specs()
        s["cross"] = attn_mod.attn_specs(flgw=_flgw_cfg(cfg, "attn"))
    if slot.ffn != "none":
        s["norm2"] = rmsnorm_specs()
        if slot.ffn != "mlp":
            s["moe"] = moe_mod.moe_specs(flgw=_flgw_cfg(cfg, "moe"))
        if slot.ffn != "moe":
            s["ffn"] = mlp_specs(gated=cfg.gated_mlp,
                                 flgw=_flgw_cfg(cfg, "mlp"))
    return _lead_specs(s, "layers")


def _lead_specs(tree, axis):
    if isinstance(tree, dict):
        return {k: _lead_specs(v, axis) for k, v in tree.items()}
    return (axis, *tree)


def lm_specs(cfg: ModelConfig) -> dict:
    """The logical-axis spec tree of :func:`lm_init`'s params (the JAX
    package's ``lm_init`` specs), built without a tensor."""
    _check_supported(cfg)
    specs = {"embed": embed_specs(),
             "blocks": {f"slot{i}": _slot_specs(cfg, slot)
                        for i, slot in enumerate(cfg.pattern)},
             "final_norm": rmsnorm_specs()}
    if cfg.encoder_layers:
        specs["encoder"] = {"slot0": _slot_specs(cfg, ENC_SLOT)}
        specs["enc_norm"] = rmsnorm_specs()
    return specs


def _plan_specs_of(specs, compact: bool):
    """A GroupPlan of replicated specs at every FLGW projection of a
    param spec tree (a dict holding ``ig``), its other branches
    dropped."""
    out = {}
    for name, s in specs.items():
        if not isinstance(s, dict):
            continue
        if "ig" in s:
            lead = len(s["ig"]) - 2
            ids, per_item = (None,) * (lead + 2), (None,) * (lead + 1)
            out[name] = GroupPlan(ids, ids, ids, ids, per_item, per_item,
                                  (None,) * (lead + 3) if compact else None)
        else:
            sub = _plan_specs_of(s, compact)
            if sub:
                out[name] = sub
    return out


def plan_specs(cfg: ModelConfig, *, compact: bool = False):
    """Spec tree of the stack's cached PlanState: every leaf replicated
    (the compact metadata is small and consumed whole by every shard).
    ``()`` off the grouped path. ``compact=True`` mirrors a state with
    the compact weights attached (``init_cache(params=...)``'s)."""
    if cfg.flgw_groups <= 1 or cfg.flgw_path != "grouped":
        return ()
    return planenc.PlanState(_plan_specs_of(lm_specs(cfg), compact), ())


def cache_specs(cfg: ModelConfig, *, per_slot: bool = False) -> dict:
    """Spec tree of :func:`init_cache`: KV buffers split over their
    sequence dim on the model axis (``"seq_kv"``), SSM states by heads
    and conv rings by channel; the plans' as :func:`plan_specs` with
    compact weights."""
    blocks = {}
    for i, slot in enumerate(cfg.pattern):
        if slot.mixer == "attn":
            kv = ("layers", "batch", "seq_kv", "kv_heads", None)
            blocks[f"slot{i}"] = {"k": kv, "v": kv}
        else:
            blocks[f"slot{i}"] = {
                "state": ("layers", "batch", "heads", None, None),
                "conv": ("layers", "batch", None, "ffn")}
    specs = {"pos": ("batch",) if per_slot else (), "blocks": blocks,
             "plans": plan_specs(cfg, compact=True)}
    if cfg.encoder_layers:
        specs["encoder_out"] = ("batch", None, None)
    return specs


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def _index(tree, i: int):
    """Block ``i`` of a tree of stacked leaves (tensors or GroupPlans)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree[i]
    if isinstance(tree, GroupPlan):
        return GroupPlan(*(None if t is None else t[i] for t in tree))
    return {k: _index(v, i) for k, v in tree.items()}


def _unstack(tree, n: int) -> list:
    """The ``n`` blocks of a tree of stacked tensors, as views from one
    ``unbind`` per leaf: the backward stacks the blocks' gradients into
    the stacked leaf's once, where ``n`` separate ``_index`` views would
    each add a full-size zero-padded gradient."""
    if isinstance(tree, torch.Tensor):
        return list(tree.unbind(0))
    parts = {k: _unstack(v, n) for k, v in tree.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _slot_apply(p, x, positions, cfg: ModelConfig, slot: SlotSpec, *,
                cache=None, pos=None, encoder_out=None, prefix_len=0,
                q_chunk=512, banded=False, moe_dropless=False, plans=None,
                cache_split=None):
    """One layer -> (x, aux), aux the MoE's load-balancing loss (None
    for an MLP slot or none); a decode step writes ``cache``'s KV buffers
    or SSM state and conv ring in place. A MoE slot is dropless whenever
    a cache is given. A cross slot attends ``encoder_out`` between its
    mixer and its FFN. ``cache_split``: the slot's entry of
    :func:`cache_groups` (a mesh's cache shards), else None."""
    split = cache_split or {}
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if slot.mixer == "attn":
        c = None if cache is None else {"k": cache["k"], "v": cache["v"],
                                        "pos": pos,
                                        "seq_group": split.get("k")}
        h, _ = attn_mod.attention(
            p["mixer"], h, positions, cfg, window=slot.window,
            causal=slot.causal, prefix_len=prefix_len, cache=c,
            q_chunk=q_chunk, banded=banded, flash=cfg.use_flash,
            flgw=_flgw_cfg(cfg, "attn"), plans=plan_of(plans, "mixer"))
    else:
        c = None if cache is None else dict(
            cache, heads_group=split.get("state"),
            conv_group=split.get("conv"))
        h = ssm_mod.ssm(p["mixer"], h, cfg, cache=c,
                        chunk=cfg.ssm_chunk, flgw=_flgw_cfg(cfg, "ssm"),
                        plans=plan_of(plans, "mixer"))
    x = x + h
    if slot.cross:
        h = rmsnorm(p["norm_x"], x, cfg.norm_eps)
        h, _ = attn_mod.attention(
            p["cross"], h, positions, cfg, causal=False, kv_x=encoder_out,
            q_chunk=q_chunk, flgw=_flgw_cfg(cfg, "attn"),
            plans=plan_of(plans, "cross"))
        x = x + h
    if slot.ffn == "none":     # a pure SSM block (mamba2) has no FFN
        return x, None
    h = rmsnorm(p["norm2"], x, cfg.norm_eps)
    if slot.ffn == "mlp":
        return x + mlp(p["ffn"], h, _flgw_cfg(cfg, "mlp"),
                       plans=plan_of(plans, "ffn")), None
    out, aux = moe_mod.moe(p["moe"], h, cfg, flgw=_flgw_cfg(cfg, "moe"),
                           dropless=moe_dropless or cache is not None,
                           plans=plan_of(plans, "moe"))
    if slot.ffn == "moe_dense":       # the parallel dense residual branch
        out = out + mlp(p["ffn"], h, _flgw_cfg(cfg, "mlp"),
                        plans=plan_of(plans, "ffn"))
    return x + out, aux


def _gathered_slot_apply(p, x, positions, cfg: ModelConfig, slot: SlotSpec,
                         *, gather=None, path=(), **kw):
    """:func:`_slot_apply` on ``p`` built whole by ``gather`` first (a
    mesh step's weights, see ``lm_apply``)."""
    if gather is not None:
        p = gather(p, path, lead=1)
    return _slot_apply(p, x, positions, cfg, slot, **kw)


def _apply_blocks(blocks, cfg: ModelConfig, pattern, n_blocks: int, x,
                  positions, *, block_plans=None, caches=None, remat=False,
                  gather=None, path=("blocks",), cache_split=None, **kw):
    """The stack of ``n_blocks`` blocks of ``pattern``'s slots over x ->
    (x, aux summed over the MoE slots). ``caches``: the decode caches'
    ``blocks``; ``gather``, ``path``, ``cache_split``: see ``lm_apply``;
    ``kw`` goes to every ``_slot_apply``."""
    aux = torch.zeros((), device=x.device)
    per_block = _unstack(blocks, n_blocks)
    for i in range(n_blocks):
        block_pl = _index(block_plans, i)
        for j, slot in enumerate(pattern):
            name = f"slot{j}"
            c = None if caches is None else _index(caches[name], i)
            kw_j = dict(kw, cache=c, plans=plan_of(block_pl, name))
            if cache_split is not None:
                kw_j["cache_split"] = cache_split.get(name)
            if gather is not None:
                kw_j.update(gather=gather, path=(*path, name))
            if remat:
                # the plans are inputs: the recompute consumes them as the
                # forward did, never re-encoding; a mesh step's gather runs
                # again in the recompute
                x, a = checkpoint(_gathered_slot_apply, per_block[i][name], x,
                                  positions, cfg, slot, use_reentrant=False,
                                  **kw_j)
            else:
                x, a = _gathered_slot_apply(per_block[i][name], x, positions,
                                            cfg, slot, **kw_j)
            if a is not None:
                aux = aux + a
    return x, aux


def lm_apply(params, cfg: ModelConfig, tokens, positions, *, cache=None,
             q_chunk: int = 512, banded: bool = False, remat=None,
             return_hidden: bool = False, unroll_blocks: bool = False,
             attn_identity: bool = False, plans=None,
             patch_embeds=None, frames=None, moe_dropless: bool = False,
             ssd_unroll: bool = False, gather=None, cache_split=None):
    """Forward pass. Returns (logits, aux_loss, new_cache).

    tokens, positions: (B, S) integer. ``patch_embeds``: (B, P, d) VLM
    prefix embeddings (prefill only), placed before the tokens and
    attended both ways; the positions become the plain ramp over the P + S
    stream, and ``return_hidden`` drops the prefix. ``frames``: (B, T, d)
    audio frame embeddings (whisper's stub front end): the encoder stack
    runs over them (positions 0..T-1, the same ``q_chunk`` and remat) and
    every cross slot attends its normed output; without frames a decode
    step reads the cache's ``encoder_out``, and the returned cache
    carries the encoder output used. A cross-attending model given
    neither raises ``ValueError`` (:func:`no_frames_error`). ``banded``:
    each query chunk of a sliding-window layer attends only its reachable KV
    band (exact). ``cache``: decode caches from :func:`init_cache`. ``plans``: cached FLGW metadata (PlanState or its
    raw dict); when None, a ``plans`` entry riding the decode cache is
    consumed, and with neither the grouped path re-encodes per
    projection. ``return_hidden`` skips the unembedding. ``remat``
    (default ``cfg.remat``) checkpoints every layer slot when autograd
    records and there is no cache. ``aux_loss`` is the MoE slots'
    load-balancing losses summed over the stack (0 without MoE).
    ``moe_dropless``: every expert takes t·k rows, so no token is dropped
    (the serving prefill); a decode step (a cache) is dropless always.
    ``gather(tree, path, lead)``: a mesh step's (``partition.gatherer``),
    called on each layer slot's params, one block's slice of the stacked
    shards at ``path`` (``lead=1``: the block axis is gone), just before
    the slot computes and inside its remat; it returns them whole. The
    top-level leaves (``embed``, the norms) the caller passes whole. A
    serving step on a mesh passes ``cache`` as this rank's local shards
    with ``cache_split`` (:func:`cache_groups` of the sharded cache): the
    groups that split each slot's KV sequence, SSM heads and conv
    channels.
    """
    _check_supported(cfg)
    if unroll_blocks or attn_identity or ssd_unroll:
        raise _unported("unroll_blocks, attn_identity and ssd_unroll")
    if plans is None and cache is not None:
        plans = cache.get("plans")
    if isinstance(plans, planenc.PlanState):
        plans = plans.plans
    plans = plans or {}
    # remat only where autograd records (serving runs under
    # inference_mode); the decoder's only without a cache, as in JAX
    remat = (cfg.remat if remat is None else remat) and \
        torch.is_grad_enabled()
    x = embed(params["embed"], tokens, cfg.d_model).to(cfg.dtype)
    prefix_len = 0
    if patch_embeds is not None:
        x = torch.cat([patch_embeds.to(cfg.dtype), x], dim=1)
        positions = torch.arange(x.shape[1], device=x.device).expand(
            x.shape[:2])
        prefix_len = patch_embeds.shape[1]

    encoder_out = None
    if cfg.encoder_layers and frames is not None:
        t = frames.shape[1]
        eo, _ = _apply_blocks(
            params["encoder"], cfg, (ENC_SLOT,), cfg.encoder_layers,
            frames.to(cfg.dtype),
            torch.arange(t, device=x.device).expand(frames.shape[0], t),
            block_plans=plans.get("encoder"), remat=remat, q_chunk=q_chunk,
            gather=gather, path=("encoder",))
        encoder_out = rmsnorm(params["enc_norm"], eo, cfg.norm_eps)
    elif cfg.encoder_layers and cache is not None:
        encoder_out = cache["encoder_out"]
    if needs_frames(cfg) and encoder_out is None:
        # the reference runs on here with kv_x=None: a cross layer that
        # sees the future (src/repro/models/attention.py:103-112)
        raise no_frames_error(cfg)

    pos = None if cache is None else cache["pos"]
    x, aux = _apply_blocks(
        params["blocks"], cfg, cfg.pattern, cfg.n_blocks, x, positions,
        block_plans=plans.get("blocks"),
        caches=None if cache is None else cache["blocks"],
        remat=remat and cache is None, gather=gather, pos=pos,
        cache_split=cache_split, encoder_out=encoder_out,
        prefix_len=prefix_len, q_chunk=q_chunk, banded=banded,
        moe_dropless=moe_dropless)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if return_hidden:
        out = x[:, prefix_len:]
    else:
        out = softcap(unembed(params["embed"], x).float(), cfg.logit_softcap)

    new_cache = None
    if cache is not None:
        # the KV buffers and SSM states were written in place
        # (models.attention, models.ssm); plans ride the cache unchanged
        new_cache = dict(cache, pos=pos + tokens.shape[1])
        if encoder_out is not None:
            new_cache["encoder_out"] = encoder_out
    return out, aux, new_cache


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------

def _cache_len(slot: SlotSpec, max_seq: int) -> int:
    """Sliding-window slots keep a ring of ``window`` positions."""
    if slot.window > 0:
        return min(max_seq, slot.window)
    return max_seq


def serve_plans(params, cfg: ModelConfig) -> planenc.PlanState:
    """The serving PlanState of ``params``: one encode with the compact
    weights attached (:func:`encode_plans`, ``attach_compact``). On a
    mesh (DTensor params) every rank encodes the same plans from the
    gathered grouping matrices and gathers each FLGW layer's weight
    whole for its own ``wc`` only, so the plans come out whole and equal
    on every rank. The empty state off the grouped path."""
    if partition.mesh_of(params) is None:
        state = encode_plans(params, cfg)
        return planenc.attach_compact(state, params) if state.plans \
            else state
    if cfg.flgw_groups <= 1 or cfg.flgw_path != "grouped":
        return planenc.empty_state(partition.local(
            params["embed"]["embedding"]).device)
    view = partition.gather_grouping(params, weights=True)
    return planenc.attach_compact(encode_plans(view, cfg), view)


def cache_shardings(cfg: ModelConfig, cache: dict, mesh, *,
                    per_slot: bool = False) -> dict:
    """The placements of ``cache``'s leaves on ``mesh`` (a tree of its
    structure): :func:`cache_specs` resolved by
    ``partition.constrained_shardings`` on the leaves' shapes, so a mesh
    axis that does not divide a dim is dropped, that dim replicated (a
    KV ring whose ``model`` width does not divide it, ``long_500k``'s
    batch of 1 on ``data``). ``cache`` may hold ``meta`` tensors."""
    specs = cache_specs(cfg, per_slot=per_slot)
    if not cache.get("plans"):
        specs["plans"] = ()
    return partition.constrained_shardings(specs, cache, mesh)


def cache_groups(cache: dict) -> dict:
    """``{slot: {leaf: group}}`` of a mesh cache's ``blocks`` (DTensors):
    the process group that splits each KV buffer's sequence dim, each
    SSM state's heads and each conv ring's channels, None where that dim
    is whole; what ``lm_apply(cache_split=)`` takes."""
    dims = {"k": 2, "v": 2, "state": 2, "conv": 3}
    return {name: {leaf: partition.split_group(x, dims[leaf])
                   for leaf, x in c.items()}
            for name, c in cache["blocks"].items()}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *, params=None,
               per_slot: bool = False, device=None, mesh=None) -> dict:
    """Decode caches, stacked (n_blocks, ...) per slot: an attention
    slot's KV ring buffers ``k``/``v`` in ``cfg.dtype``, an SSM slot's
    recurrent ``state`` (float32) and ``conv`` ring (``cfg.dtype``); an
    encoder-decoder's ``encoder_out``, zeros (batch, ``num_frames``,
    d_model) in ``cfg.dtype`` until a step with frames writes it, as in
    JAX.

    ``params``: encode a PlanState beside the KV buffers
    (``cache["plans"]``) on the FLGW grouped path, with the compact
    weights attached; without params (or off the grouped path)
    ``cache["plans"]`` is ``()``. ``per_slot``:
    ``cache["pos"]`` is a (batch,) vector, one stream offset per row (the
    continuous-batching layout), else a scalar. ``device`` defaults to
    the params' device, else the card.

    ``mesh``: a ``(data, model)`` DeviceMesh (a serving mesh; ``params``
    then DTensors, as ``partition.distribute`` places them): every leaf
    a DTensor placed by :func:`cache_shardings`, each rank allocating
    only its shard: KV buffers' batch over ``data`` and sequence over
    ``model``, SSM states' heads and conv rings' channels over
    ``model``, ``encoder_out`` and a per-slot ``pos`` over ``data``, the
    scalar ``pos`` and the plans (:func:`serve_plans`, whole on every
    rank) replicated.
    """
    _check_supported(cfg)
    if device is None:
        device = (partition.local(params["embed"]["embedding"]).device
                  if params is not None else resolve_device())
    if mesh is not None:
        shapes = init_cache(cfg, batch, max_seq, per_slot=per_slot,
                            device="meta")
        cache = partition.map_tree(
            lambda x, pl: partition.zeros(x.shape, x.dtype, pl, mesh,
                                          device),
            shapes, cache_shardings(cfg, shapes, mesh, per_slot=per_slot))
        plans = () if params is None else serve_plans(params, cfg)
        cache["plans"] = partition.replicate(plans, mesh) if plans else ()
        return cache
    dtype = cfg.dtype
    nb = cfg.n_blocks
    blocks = {}
    for i, slot in enumerate(cfg.pattern):
        if slot.mixer == "attn":
            kv = (nb, batch, _cache_len(slot, max_seq), cfg.n_kv_heads,
                  cfg.head_dim)
            blocks[f"slot{i}"] = {
                "k": torch.zeros(kv, dtype=dtype, device=device),
                "v": torch.zeros(kv, dtype=dtype, device=device)}
        else:
            conv_ch = cfg.d_inner + 2 * cfg.ssm_state
            blocks[f"slot{i}"] = {
                "state": torch.zeros((nb, batch, cfg.ssm_heads,
                                      cfg.ssm_head_dim, cfg.ssm_state),
                                     dtype=torch.float32, device=device),
                "conv": torch.zeros((nb, batch, cfg.conv_width - 1,
                                     conv_ch), dtype=dtype, device=device)}
    pos_shape = (batch,) if per_slot else ()
    cache = {"pos": torch.zeros(pos_shape, dtype=torch.int64, device=device),
             "blocks": blocks}
    plans = ()
    if params is not None:
        state = encode_plans(params, cfg)
        if state.plans:
            plans = planenc.attach_compact(state, params)
    cache["plans"] = plans
    if cfg.encoder_layers:
        cache["encoder_out"] = torch.zeros(
            (batch, cfg.num_frames, cfg.d_model), dtype=dtype, device=device)
    return cache


def refresh_cache_plans(params, cfg: ModelConfig, cache: dict) -> dict:
    """Request-boundary staleness check of the cache's PlanState: one
    signature pass, a re-encode only if the grouping layout moved (and
    the compact weights re-gathered either way). Caches without a
    PlanState pass through."""
    plans = cache.get("plans")
    if not isinstance(plans, planenc.PlanState) or not plans.plans:
        return cache
    fresh = planenc.refresh_if_stale(params, plans,
                                     lambda: encode_plans(params, cfg))
    return dict(cache, plans=fresh)


def reset_slots(cache: dict, mask) -> dict:
    """Recycle batch rows of a per-slot decode cache for fresh requests.

    ``mask``: (batch,) bool; True rows return to stream offset 0, which
    invalidates every ring index of theirs (each maps to a negative
    absolute position until rewritten), so the KV buffers need no
    clearing; their SSM ``state`` and ``conv`` rows are zeroed in place
    (the state integrates every step, so the previous request would leak
    into the next). False rows pass through bitwise untouched.
    """
    pos = cache["pos"]
    if pos.dim() != 1:
        raise ValueError(
            "reset_slots needs a per-slot cache (init_cache(per_slot=True)); "
            "this cache has a scalar shared position")
    mask = torch.as_tensor(mask, dtype=torch.bool, device=pos.device)
    for c in cache["blocks"].values():
        for leaf in ("state", "conv"):
            if leaf in c:
                c[leaf][:, mask] = 0
    return dict(cache, pos=torch.where(mask, 0, pos))
