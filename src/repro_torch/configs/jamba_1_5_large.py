"""jamba-1.5-large-398b [hybrid]: 72L d=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16 experts top-2, Mamba:attention 7:1 interleave (1 attn +
7 SSM per 8-layer block), MoE every other layer. SSM state 128.
[arXiv:2403.19887; hf:ai21labs/AI21-Jamba-1.5-Large] -- the same two
configs as ``repro.configs.jamba_1_5_large``."""
from repro_torch.configs.registry import register, register_smoke
from repro_torch.models.config import ModelConfig, SlotSpec


def _pattern():
    slots = []
    for i in range(8):
        mixer = "attn" if i == 0 else "ssm"
        ffn = "moe" if i % 2 == 1 else "mlp"
        slots.append(SlotSpec(mixer=mixer, window=0, ffn=ffn))
    return tuple(slots)


@register("jamba_1_5_large")
def config() -> ModelConfig:
    return ModelConfig(
        name="jamba_1_5_large", family="hybrid", n_layers=72, d_model=8192,
        n_heads=64, n_kv_heads=8, head_dim=128, d_ff=24576, vocab=65_536,
        pattern=_pattern(), n_experts=16, top_k=2, moe_d_ff=24576,
        ssm_state=128, ssm_head_dim=128, expand=2)


@register_smoke("jamba_1_5_large")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="jamba_1_5_large_smoke", family="hybrid", n_layers=8,
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
        vocab=512, pattern=_pattern(), n_experts=4, top_k=2, moe_d_ff=128,
        ssm_state=16, ssm_head_dim=16, expand=2)
