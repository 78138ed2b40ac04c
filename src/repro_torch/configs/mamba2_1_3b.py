"""mamba2-1.3b [ssm]: 48L d=2048 attn-free, vocab=50280, ssm_state=128,
SSD (state-space duality), d_inner=2*d, head_dim=64 (64 SSM heads). Pure
mamba blocks -- no FFN (d_ff=0 per assignment). [arXiv:2405.21060] --
the same two configs as ``repro.configs.mamba2_1_3b``."""
from repro_torch.configs.registry import register, register_smoke
from repro_torch.models.config import ModelConfig, SlotSpec


@register("mamba2_1_3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2_1_3b", family="ssm", n_layers=48, d_model=2048,
        n_heads=1, n_kv_heads=1, head_dim=64, d_ff=0, vocab=50_280,
        pattern=(SlotSpec(mixer="ssm", ffn="none"),),
        ssm_state=128, ssm_head_dim=64, expand=2)


@register_smoke("mamba2_1_3b")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2_1_3b_smoke", family="ssm", n_layers=4, d_model=64,
        n_heads=1, n_kv_heads=1, head_dim=16, d_ff=0, vocab=512,
        pattern=(SlotSpec(mixer="ssm", ffn="none"),),
        ssm_state=16, ssm_head_dim=16, expand=2)
