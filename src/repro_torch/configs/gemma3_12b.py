"""gemma3-12b [dense]: 48L d=3840 16H (GQA kv=8) d_ff=15360 vocab=262144.
5:1 local(1024):global attention pattern, 128k context.
[hf:google/gemma-3-12b-pt; unverified tier] -- the same two
configs as ``repro.configs.gemma3_12b``."""
from repro_torch.configs.registry import register, register_smoke
from repro_torch.models.config import ModelConfig, SlotSpec

_LOCAL = SlotSpec(mixer="attn", window=1024, ffn="mlp")
_GLOBAL = SlotSpec(mixer="attn", window=0, ffn="mlp")
_PATTERN = (_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL)


@register("gemma3_12b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3_12b", family="dense", n_layers=48, d_model=3840,
        n_heads=16, n_kv_heads=8, head_dim=256, d_ff=15360, vocab=262_144,
        pattern=_PATTERN, rope_theta=1_000_000.0)


@register_smoke("gemma3_12b")
def smoke() -> ModelConfig:
    l = SlotSpec(mixer="attn", window=16, ffn="mlp")
    g = SlotSpec(mixer="attn", window=0, ffn="mlp")
    return ModelConfig(
        name="gemma3_12b_smoke", family="dense", n_layers=6, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
        pattern=(l, l, l, l, l, g))
