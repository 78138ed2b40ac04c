"""Model configuration of the LM stack: the port of ``repro.models.config``.

Layer heterogeneity (local/global attention, MoE cadence, Mamba/attention
interleave) is a repeating *pattern* of ``period`` slots; the stack runs
``n_layers // period`` blocks of it. The fields are the JAX package's, so
a config converts one to one; ``dtype`` is a ``torch.dtype``. The port's
transformer runs the dense, MoE, SSM and hybrid families and raises on
cross-attention and encoder stacks (``repro_torch.models.transformer``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SlotSpec:
    """Static type of one layer slot inside the repeating pattern."""
    mixer: str = "attn"          # "attn" | "ssm"
    window: int = 0              # 0 = global attention; >0 = sliding window
    ffn: str = "mlp"             # "mlp" | "moe" | "moe_dense" (residual MoE)
    cross: bool = False          # add cross-attention (decoder of enc-dec)
    causal: bool = True          # False for encoder (bidirectional) stacks


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    pattern: Tuple[SlotSpec, ...] = (SlotSpec(),)
    # attention details
    logit_softcap: float = 0.0   # final-logit softcap (gemma2)
    attn_softcap: float = 0.0    # attention-logit softcap (gemma2)
    rope_theta: float = 10000.0
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # ssm (mamba2 / jamba)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 256
    # enc-dec (whisper)
    encoder_layers: int = 0
    num_frames: int = 0
    # vlm (paligemma)
    prefix_len: int = 0
    # activation / norm
    gated_mlp: bool = True
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    dtype: Any = torch.bfloat16
    # FLGW (the paper's technique)
    flgw_groups: int = 1
    flgw_path: str = "masked"    # dense | masked | grouped
    flgw_targets: Tuple[str, ...] = ("mlp",)   # mlp | attn | moe | ssm
    # training
    remat: bool = True           # checkpoint each layer slot under autograd
    use_flash: bool = False      # fused flash-attention core (prefill, train)

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_blocks(self) -> int:
        assert self.n_layers % self.period == 0, \
            f"{self.name}: {self.n_layers} % {self.period} != 0"
        return self.n_layers // self.period

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def flgw_on(self, target: str) -> bool:
        return self.flgw_groups > 1 and self.flgw_path != "dense" \
            and target in self.flgw_targets

    def with_updates(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def _count(cfg: ModelConfig, experts_per_moe: int) -> int:
    """Parameter count with MoE slots counted as ``experts_per_moe``
    FFNs, as ``repro.models.config._count``."""
    d, h = cfg.d_model, cfg.head_dim
    total = cfg.vocab * d
    if not cfg.tie_embeddings:
        total += cfg.vocab * d
    attn = d * h * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * h * d

    def mlp(ff):
        return d * ff * (3 if cfg.gated_mlp else 2)

    def ssm():
        di, ns = cfg.d_inner, cfg.ssm_state
        return (d * (2 * di + 2 * ns + cfg.ssm_heads)
                + cfg.conv_width * (di + 2 * ns) + di * d + 3 * cfg.ssm_heads)

    per_block = 0
    for slot in cfg.pattern:
        per_block += attn if slot.mixer == "attn" else ssm()
        if slot.cross:
            per_block += attn
        if slot.ffn == "mlp":
            per_block += mlp(cfg.d_ff)
        elif slot.ffn != "none":                     # moe | moe_dense
            per_block += experts_per_moe * mlp(cfg.moe_d_ff or cfg.d_ff)
            per_block += d * cfg.n_experts           # router
            if slot.ffn == "moe_dense":
                per_block += mlp(cfg.d_ff)           # dense residual branch
        per_block += 4 * d
    total += cfg.n_blocks * per_block
    if cfg.encoder_layers:
        total += cfg.encoder_layers * (attn + mlp(cfg.d_ff) + 4 * d)
    return int(total)


def param_count(cfg: ModelConfig) -> int:
    """Total parameters (every expert counted)."""
    return _count(cfg, cfg.n_experts)


def active_param_count(cfg: ModelConfig) -> int:
    """Active parameters a token (MoE: only ``top_k`` experts fire)."""
    return _count(cfg, cfg.top_k if cfg.n_experts else 0)
