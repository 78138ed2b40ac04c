"""GQA attention: RoPE, sliding window, logit softcap, KV-cache decode,
cross-attention.

Port of ``repro.models.attention``. Three regimes of self-attention, as
in the JAX package:

* prefill with ``flash=True``: the flash-attention kernel
  (``repro_torch.kernels.flash_attention``), which never stores the
  (S, T) logits;
* prefill without it, or with a bidirectional prefix (``prefix_len``,
  the VLM's patches, as in JAX) or no causal mask (an encoder stack):
  the plain core, query-chunked so the logit tile is (B, Hkv, q_per_kv,
  Cq, T) (a Python loop where JAX scans); ``banded=True`` gives each
  chunk of a sliding-window layer only its reachable KV band, which is
  exact;
* decode: one token per step written into a ring buffer of length
  ``min(max_seq, window)`` and attended with the plain core (plain
  ``einsum`` in JAX too). The KV buffers are updated in place: the
  returned cache shares them with the one passed in.

Cross-attention (``kv_x``, whisper's decoder): q from ``x``, k and v
projected from ``kv_x`` (the encoder's output), neither rotated, no
mask, no cache: a decode step projects k and v from ``kv_x`` again, as
in JAX. It always takes the plain core (JAX's flash branch excludes it).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.flgw import FLGWConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import (dense_init, dense_specs, plan_of, proj,
                                       rope, softcap)

NEG_INF = -2.3819763e38


def attn_init(generator: torch.Generator, cfg, *,
              flgw: Optional[FLGWConfig] = None, lead: tuple = ()) -> dict:
    d, h = cfg.d_model, cfg.head_dim
    kw = dict(flgw=flgw, dtype=cfg.dtype, lead=lead)
    return {"q": dense_init(generator, d, cfg.n_heads * h, **kw),
            "k": dense_init(generator, d, cfg.n_kv_heads * h, **kw),
            "v": dense_init(generator, d, cfg.n_kv_heads * h, **kw),
            "o": dense_init(generator, cfg.n_heads * h, d, **kw)}


def attn_specs(*, flgw: Optional[FLGWConfig] = None) -> dict:
    """Spec tree of :func:`attn_init`: q ("embed", "heads"), k and v
    ("embed", "kv_heads"), o ("heads", "embed")."""
    return {"q": dense_specs(("embed", "heads"), flgw=flgw),
            "k": dense_specs(("embed", "kv_heads"), flgw=flgw),
            "v": dense_specs(("embed", "kv_heads"), flgw=flgw),
            "o": dense_specs(("heads", "embed"), flgw=flgw)}


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
          window: int, prefix_len: int = 0,
          k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., Sq, Sk) bool allowed-attention mask from position vectors;
    the first ``prefix_len`` positions see each other both ways."""
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    if causal:
        allowed = k <= q
        if prefix_len > 0:
            allowed = allowed | ((k < prefix_len) & (q < prefix_len))
    else:
        allowed = torch.ones(torch.broadcast_shapes(q.shape, k.shape),
                             dtype=torch.bool, device=q.device)
    if window > 0:
        allowed = allowed & (k > q - window)
    if k_valid is not None:
        allowed = allowed & k_valid[..., None, :]
    return allowed


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor, cfg) -> torch.Tensor:
    """q: (B, Sq, G, Q, D); k/v: (B, Sk, G, D); mask (B, Sq, Sk) or
    (Sq, Sk). JAX's dtype sequence: f32 logits, softcap, NEG_INF mask,
    f32 softmax, probabilities cast to q's dtype for the PV product."""
    scale = cfg.head_dim ** -0.5
    logits = torch.einsum("bsgqd,btgd->bgqst", q.float(), k.float()) * scale
    if cfg.attn_softcap > 0:
        logits = softcap(logits, cfg.attn_softcap)
    if mask.dim() == 2:
        mask = mask[None]
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bgqst,btgd->bsgqd", probs, v)


def _decode(k, v, cache, positions, b, s, window, causal, prefix_len):
    """Write this step's k/v into the ring buffers (in place) and return
    (k buffer, v buffer, mask, new pos)."""
    pos = cache["pos"]
    ck, cv = cache["k"], cache["v"]
    t = ck.shape[1]
    idx = torch.arange(t, device=ck.device)
    if pos.dim() == 0:
        # lockstep cache: every batch row shares one stream offset; the
        # write start clamps so the s tokens fit, as dynamic_update_slice
        start = torch.clamp(pos % t, max=t - s)
        at = start + torch.arange(s, device=ck.device)
        ck.index_copy_(1, at, k.to(ck.dtype))
        cv.index_copy_(1, at, v.to(cv.dtype))
        # absolute position held by each ring slot after the write: the
        # largest p <= pos with p == idx (mod t); negative: never written
        k_pos = (pos - torch.remainder(pos - idx, t))[None]
    else:
        # per-slot cache: pos is (B,), each row its own request stream
        if s != 1:
            raise ValueError(
                "per-slot decode caches take single-token steps "
                f"(got {s} tokens); multi-token prefill goes through the "
                "cache-free path one token at a time")
        rows = torch.arange(b, device=ck.device)
        write = pos % t
        ck[rows, write] = k[:, 0].to(ck.dtype)
        cv[rows, write] = v[:, 0].to(cv.dtype)
        k_pos = pos[:, None] - torch.remainder(pos[:, None] - idx[None], t)
    mask = _mask(positions, k_pos, causal=causal, window=window,
                 prefix_len=prefix_len, k_valid=k_pos >= 0)
    return ck, cv, mask, pos + s


def attention(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg, *,
              window: int = 0, causal: bool = True, prefix_len: int = 0,
              kv_x: Optional[torch.Tensor] = None,
              cache: Optional[dict] = None, q_chunk: int = 512,
              banded: bool = False, flash: bool = False,
              flgw: Optional[FLGWConfig] = None, plans=None):
    """Returns (out, new_cache).

    * prefill: ``cache is None``, full sequence;
    * decode: ``cache = {"k", "v", "pos"}``, insert the step's token at
      ``pos`` and attend over the cache;
    * cross-attention: ``kv_x`` (B, T, d) given, keys and values from it
      at key positions 0..T-1, no RoPE, no causal mask, no cache.

    ``plans``: this layer's entry of a cached PlanState, one GroupPlan per
    q/k/v/o projection on the FLGW grouped path (None re-encodes per
    call inside ``proj``).
    """
    b, s, _ = x.shape
    hd, n_kv, qpk = cfg.head_dim, cfg.n_kv_heads, cfg.q_per_kv
    src = x if kv_x is None else kv_x
    t = src.shape[1]
    q = proj(p["q"], x, flgw, plan=plan_of(plans, "q")
             ).reshape(b, s, n_kv, qpk, hd)
    k = proj(p["k"], src, flgw, plan=plan_of(plans, "k")
             ).reshape(b, t, n_kv, hd)
    v = proj(p["v"], src, flgw, plan=plan_of(plans, "v")
             ).reshape(b, t, n_kv, hd)
    if kv_x is None:
        q = rope(q.reshape(b, s, n_kv * qpk, hd), positions,
                 cfg.rope_theta).reshape(b, s, n_kv, qpk, hd)
        k = rope(k, positions, cfg.rope_theta)
        k_pos = positions
    else:
        if cache is not None:
            raise ValueError("cross-attention takes no KV cache: a decode "
                             "step projects k and v from kv_x again")
        # the memory's own positions; no query is masked from any of them
        k_pos = torch.arange(t, device=x.device)[None]
        causal = False

    def out_proj(o):
        return proj(p["o"], o.reshape(b, s, -1), flgw, plan=plan_of(plans, "o"))

    if cache is not None:
        ck, cv, mask, new_pos = _decode(k, v, cache, positions, b, s, window,
                                        causal, prefix_len)
        out = _attend(q, ck, cv, mask, cfg)
        return out_proj(out), {"k": ck, "v": cv, "pos": new_pos}

    if flash and prefix_len == 0 and causal and kv_x is None:
        # the kernel masks by absolute position 0..S-1, so positions must
        # be that plain ramp, as in the JAX package's flash branch; a
        # bidirectional prefix takes the chunked core below, as in JAX
        qf = q.reshape(b, s, n_kv * qpk, hd).transpose(1, 2)
        of = flash_attention(qf, k.transpose(1, 2), v.transpose(1, 2),
                             causal=True, window=window,
                             softcap=float(cfg.attn_softcap))
        return out_proj(of.transpose(1, 2)), None

    if s <= q_chunk:
        mask = _mask(positions, k_pos, causal=causal, window=window,
                     prefix_len=prefix_len)
        return out_proj(_attend(q, k, v, mask, cfg)), None

    if s % q_chunk:     # e.g. a VLM prefix extends S: a clean divisor
        q_chunk = next(c for c in range(q_chunk, 0, -1) if s % c == 0)
    # banded: the KV band one query chunk can reach, window + chunk rounded
    # to the chunk (exact: outside it everything is masked)
    use_band = banded and window > 0 and kv_x is None
    band = min(t, (-(-window // q_chunk) + 1) * q_chunk) if use_band else t
    outs = []
    for c0 in range(0, s, q_chunk):
        k0 = max(c0 + q_chunk - band, 0) if use_band else 0
        m = _mask(positions[:, c0:c0 + q_chunk], k_pos[:, k0:k0 + band],
                  causal=causal, window=window, prefix_len=prefix_len)
        outs.append(_attend(q[:, c0:c0 + q_chunk], k[:, k0:k0 + band],
                            v[:, k0:k0 + band], m, cfg))
    return out_proj(torch.cat(outs, dim=1)), None
