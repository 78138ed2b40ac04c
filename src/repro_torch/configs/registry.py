"""Architecture registry of the LM stack: ``get_config(name)`` lookup.

Port of ``repro.configs.registry``'s lookup half. Each architecture
registers its published config and a reduced smoke config (same family,
tiny dims). The dense family (gemma2-2b, gemma2-27b, gemma3-12b,
internlm2-20b and paligemma-3b's prefix-LM backbone), the MoE family
(mixtral-8x22b, arctic-480b), the SSM mamba2-1.3b, the hybrid
jamba-1.5-large and the audio encoder-decoder whisper-large-v3 are
registered: every LM architecture of the JAX package's registry
(``ic3net``, the paper's own network, has its config in
``repro_torch.configs.ic3net``). The configs are the JAX package's,
with its simplifications (one ``rope_theta`` a model, the attention
scale ``head_dim ** -0.5``, no qk-norm; whisper's RoPE, stub frame
embeddings and RMSNorm), not every detail of the published models.

The shape cells (``SHAPES``, ``cells``, ``all_cells``) and
``input_specs`` are the reference's: the dry run
(``repro_torch.launch.dryrun``) sizes every (arch, shape) cell with
them.
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict

import torch

from repro_torch.models.config import ModelConfig

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: Dict[str, Callable[[], ModelConfig]] = {}

ARCH_IDS = ("gemma2_2b", "gemma2_27b", "gemma3_12b", "internlm2_20b",
            "paligemma_3b", "mixtral_8x22b", "arctic_480b", "mamba2_1_3b",
            "jamba_1_5_large", "whisper_large_v3")

# Shape cells: name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k":    (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k":  (32_768, 128, "decode"),
    "long_500k":   (524_288, 1, "decode"),
}

# long_500k: sub-quadratic or bounded-KV architectures only
LONG_OK = {"mamba2_1_3b", "jamba_1_5_large", "mixtral_8x22b", "gemma3_12b"}
# ic3net, the paper's own network, has MARL shapes only; it is not in
# ARCH_IDS, so the set only mirrors the reference's
NO_LM_SHAPES = {"ic3net"}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def register_smoke(name: str):
    def deco(fn):
        _SMOKE[name] = fn
        return fn
    return deco


def _load(name: str) -> None:
    if name not in ARCH_IDS:
        raise KeyError(f"unknown LM architecture {name!r} (registered: "
                       f"{ARCH_IDS})")
    if name not in _REGISTRY:
        importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str, **overrides) -> ModelConfig:
    _load(name)
    cfg = _REGISTRY[name]()
    return cfg.with_updates(**overrides) if overrides else cfg


def get_smoke_config(name: str, **overrides) -> ModelConfig:
    _load(name)
    cfg = _SMOKE[name]()
    return cfg.with_updates(**overrides) if overrides else cfg


def cells(arch: str) -> list[str]:
    """The shape cells that apply to ``arch``."""
    if arch in NO_LM_SHAPES:
        return []
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_OK:
        out.append("long_500k")
    return out


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCH_IDS for s in cells(a)]


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """``meta`` tensors of every model input of one cell: the tokens
    (with ``targets`` for training), their positions, and a VLM's
    ``patch_embeds`` or an encoder-decoder's ``frames`` stub. A decode
    cell's inputs are one new token a row (its cache is built apart).
    Nothing is allocated."""
    seq, batch, kind = SHAPES[shape_name]

    def ints(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    if kind == "decode":
        return {"tokens": ints(batch, 1), "positions": ints(batch, 1)}
    specs = {"tokens": ints(batch, seq)}
    if kind == "train":
        specs["targets"] = ints(batch, seq)
    specs["positions"] = ints(batch, seq)
    if cfg.prefix_len:
        specs["patch_embeds"] = torch.empty(
            (batch, cfg.prefix_len, cfg.d_model), dtype=cfg.dtype,
            device="meta")
    if cfg.encoder_layers:
        specs["frames"] = torch.empty(
            (batch, cfg.num_frames, cfg.d_model), dtype=cfg.dtype,
            device="meta")
    return specs
