"""gemma2-27b [dense]: 46L d=4608 32H (GQA kv=16) d_ff=36864 vocab=256000.
Local+global alternating attention, logit softcaps. [arXiv:2408.00118; hf] -- the same two
configs as ``repro.configs.gemma2_27b``."""
from repro_torch.configs.registry import register, register_smoke
from repro_torch.models.config import ModelConfig, SlotSpec

_PATTERN = (SlotSpec(mixer="attn", window=4096, ffn="mlp"),
            SlotSpec(mixer="attn", window=0, ffn="mlp"))


@register("gemma2_27b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2_27b", family="dense", n_layers=46, d_model=4608,
        n_heads=32, n_kv_heads=16, head_dim=128, d_ff=36864, vocab=256_000,
        pattern=_PATTERN, attn_softcap=50.0, logit_softcap=30.0)


@register_smoke("gemma2_27b")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma2_27b_smoke", family="dense", n_layers=4, d_model=64,
        n_heads=8, n_kv_heads=4, head_dim=8, d_ff=192, vocab=512,
        pattern=(SlotSpec(mixer="attn", window=16, ffn="mlp"),
                 SlotSpec(mixer="attn", window=0, ffn="mlp")),
        attn_softcap=50.0, logit_softcap=30.0)
