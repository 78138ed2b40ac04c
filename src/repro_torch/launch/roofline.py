"""Roofline terms of a step on an NVIDIA H100, from counted costs.

Port of ``repro.launch.roofline``. Three terms, in seconds a chip:

    compute    = flops             / peak_FLOP/s
    memory     = bytes             / HBM_bw
    collective = link bytes        / link_bw

The reference reads flops and bytes from XLA's cost analysis of a
compiled program, and its collective and fused bytes by parsing the
optimized HLO (``collective_bytes_from_hlo``, ``fused_bytes_from_hlo``).
Eager PyTorch compiles no program, so those two have no counterpart
here: the dry run (``repro_torch.launch.dryrun``) counts what each rank
runs instead, flops and bytes by a dispatch mode over every op and the
collectives and their bytes in ``sharding.collectives``, where each one
runs.

The card's numbers (NVIDIA's data sheet of the H100 SXM) live here and
nowhere else: ``chip_smoke.py``'s bounds take them from this module.
"""
from __future__ import annotations

from typing import Dict

HBM_BW = 3.35e12             # bytes/s, H100 SXM HBM3
PEAK_FLOPS = 989e12          # FLOP/s, bf16 tensor cores, dense
F32_FLOPS = 67e12            # FLOP/s, f32 outside the tensor cores
LINK_BW = 450e9              # bytes/s, NVLink, each direction a card


def bound_ms(nbytes: float, ops: float,
             peak: float = F32_FLOPS) -> tuple[float, str]:
    """The least time in ms the card could take for work that moves
    ``nbytes`` of device memory and does ``ops`` operations at ``peak``,
    and which of the two bounds it (``"bytes"`` or ``"operations"``)."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def roofline_terms(*, flops_per_chip: float, bytes_per_chip: float,
                   collective_bytes_per_chip: float,
                   model_flops_total: float, chips: int,
                   fused_bytes_per_chip: float = None) -> Dict[str, float]:
    """The three terms, the dominant one, the step's lower bound and the
    roofline fraction (the model's useful flops a chip at peak over the
    bound). ``fused_bytes_per_chip``, where given, replaces the bytes in
    the decision (a lower bound on the memory term)."""
    compute = flops_per_chip / PEAK_FLOPS
    memory = bytes_per_chip / HBM_BW
    collective = collective_bytes_per_chip / LINK_BW
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    if fused_bytes_per_chip is not None:
        terms["memory_fused_s"] = fused_bytes_per_chip / HBM_BW
        decide = {"compute_s": compute,
                  "memory_s": terms["memory_fused_s"],
                  "collective_s": collective}
    else:
        decide = terms
    dominant = max(decide, key=decide.get)
    bound = max(decide.values())
    useful = model_flops_total / chips / PEAK_FLOPS
    return {
        **terms,
        "dominant": dominant,
        "step_time_lower_bound_s": bound,
        "model_flops_total": model_flops_total,
        "hlo_flops_per_chip": flops_per_chip,
        "useful_flops_ratio": (model_flops_total / chips) / flops_per_chip
        if flops_per_chip else float("nan"),
        "roofline_fraction": useful / bound if bound else float("nan"),
        "roofline_fraction_upper_bound_terms":
            useful / max(terms["compute_s"], terms["memory_s"], collective)
            if max(terms.values()) else float("nan"),
        "chips": chips,
    }


def flash_attention_cost(cfg, *, batch: int, seq: int, kind: str,
                         bq: int = 512, bk: int = 512) -> Dict[str, float]:
    """Analytic flops and HBM bytes of the fused attention cores of one
    step, the reference's model unchanged (used by ``dryrun --flash`` in
    place of the plain core's counted cost):

    * pairs: the exact allowed (q, k) pairs, block-rounded;
    * matmul units of 2·pairs·D flops: forward 2 (qk, pv); training adds
      the remat recompute (+2) and the backward's dq (3) and dkv (4):
      11; softmax and rescale ~8 vector flops a pair (forward), ~20
      (training);
    * bytes: q, o (and do, dq) once a pass; k and v once a live
      (q-block row, head).
    """
    per_layer = []
    for slot in cfg.pattern:
        if slot.mixer != "attn":
            per_layer.append((0.0, 0.0))
            continue
        w = slot.window
        s = seq
        if slot.causal:
            if w and w < s:
                pairs = w * s - w * (w - 1) / 2  # ramp then band
            else:
                pairs = s * (s + 1) / 2
        else:
            pairs = float(s) * s
        # block rounding: partial tiles compute fully
        pairs = min(pairs * 1.15 + bq * bk, float(s) * s)
        hq = cfg.n_heads
        hkv = cfg.n_kv_heads
        d = cfg.head_dim
        mm_units = 11 if kind == "train" else 2
        vec = 20 if kind == "train" else 8
        flops = batch * hq * (mm_units * 2 * pairs * d + vec * pairs)
        dt = 2  # bf16 operands
        passes = 3 if kind == "train" else 1          # fwd, dq, dkv
        qo_tensors = 8 if kind == "train" else 2
        live_blocks = pairs / (bq * bk)
        bytes_qo = batch * hq * s * d * dt * qo_tensors
        bytes_kv = (batch * hkv * live_blocks * bk * d * dt * 2 * passes)
        per_layer.append((flops, bytes_qo + bytes_kv))
    nb = cfg.n_blocks
    flops = nb * sum(f for f, _ in per_layer)
    bytes_ = nb * sum(b for _, b in per_layer)
    return {"flops": flops, "bytes": bytes_}


def model_flops(cfg, n_tokens: int, *, kind: str = "train") -> float:
    """6·N_active·D for training, 2·N_active·D for a forward or a
    decode."""
    from repro_torch.models.config import active_param_count
    n = active_param_count(cfg)
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * n_tokens
