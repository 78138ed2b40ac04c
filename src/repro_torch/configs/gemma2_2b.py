"""gemma2-2b [dense]: 26L d=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
Local+global alternating attention (window 4096), attn/final logit softcaps.
[arXiv:2408.00118; hf:google/gemma-2-2b] -- the same two configs as
``repro.configs.gemma2_2b``."""
from repro_torch.configs.registry import register, register_smoke
from repro_torch.models.config import ModelConfig, SlotSpec

_PATTERN = (SlotSpec(mixer="attn", window=4096, ffn="mlp"),
            SlotSpec(mixer="attn", window=0, ffn="mlp"))


@register("gemma2_2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2_2b", family="dense", n_layers=26, d_model=2304,
        n_heads=8, n_kv_heads=4, head_dim=256, d_ff=9216, vocab=256_000,
        pattern=_PATTERN, attn_softcap=50.0, logit_softcap=30.0)


@register_smoke("gemma2_2b")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma2_2b_smoke", family="dense", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
        pattern=(SlotSpec(mixer="attn", window=16, ffn="mlp"),
                 SlotSpec(mixer="attn", window=0, ffn="mlp")),
        attn_softcap=50.0, logit_softcap=30.0)
