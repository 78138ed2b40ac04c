"""mixtral-8x22b [moe]: 56L d=6144 48H (GQA kv=8) vocab=32768,
MoE 8 experts top-2 (expert d_ff=16384), sliding-window attention.
[arXiv:2401.04088; hf:mistralai/Mixtral-8x22B-v0.1] -- the same two
configs as ``repro.configs.mixtral_8x22b``."""
from repro_torch.configs.registry import register, register_smoke
from repro_torch.models.config import ModelConfig, SlotSpec


@register("mixtral_8x22b")
def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral_8x22b", family="moe", n_layers=56, d_model=6144,
        n_heads=48, n_kv_heads=8, head_dim=128, d_ff=16384, vocab=32_768,
        pattern=(SlotSpec(mixer="attn", window=4096, ffn="moe"),),
        n_experts=8, top_k=2, moe_d_ff=16384)


@register_smoke("mixtral_8x22b")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral_8x22b_smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
        pattern=(SlotSpec(mixer="attn", window=16, ffn="moe"),),
        n_experts=4, top_k=2, moe_d_ff=128)
