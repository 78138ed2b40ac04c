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
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict

from repro_torch.models.config import ModelConfig

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: Dict[str, Callable[[], ModelConfig]] = {}

ARCH_IDS = ("gemma2_2b", "gemma2_27b", "gemma3_12b", "internlm2_20b",
            "paligemma_3b", "mixtral_8x22b", "arctic_480b", "mamba2_1_3b",
            "jamba_1_5_large", "whisper_large_v3")


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
