"""arctic-480b [moe]: 35L d=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 PLUS a parallel dense-residual FFN branch.
[hf:Snowflake/snowflake-arctic-base] -- the same two configs as
``repro.configs.arctic_480b``."""
from repro_torch.configs.registry import register, register_smoke
from repro_torch.models.config import ModelConfig, SlotSpec


@register("arctic_480b")
def config() -> ModelConfig:
    return ModelConfig(
        name="arctic_480b", family="moe", n_layers=35, d_model=7168,
        n_heads=56, n_kv_heads=8, head_dim=128, d_ff=4864, vocab=32_000,
        pattern=(SlotSpec(mixer="attn", window=0, ffn="moe_dense"),),
        n_experts=128, top_k=2, moe_d_ff=4864)


@register_smoke("arctic_480b")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="arctic_480b_smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96, vocab=512,
        pattern=(SlotSpec(mixer="attn", window=0, ffn="moe_dense"),),
        n_experts=8, top_k=2, moe_d_ff=96)
