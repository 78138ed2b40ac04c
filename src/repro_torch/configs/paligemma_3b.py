"""paligemma-3b [vlm]: 18L d=2048 8H (GQA kv=1) d_ff=16384 vocab=257216.
SigLIP vision frontend is a STUB: the caller passes 256 precomputed patch
embeddings (``patch_embeds``); the backbone runs prefix-LM attention over [patches; text].
[arXiv:2407.07726; hf:google/paligemma-3b-pt-224] -- the same two
configs as ``repro.configs.paligemma_3b``."""
from repro_torch.configs.registry import register, register_smoke
from repro_torch.models.config import ModelConfig, SlotSpec


@register("paligemma_3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="paligemma_3b", family="vlm", n_layers=18, d_model=2048,
        n_heads=8, n_kv_heads=1, head_dim=256, d_ff=16384, vocab=257_216,
        pattern=(SlotSpec(),), prefix_len=256)


@register_smoke("paligemma_3b")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="paligemma_3b_smoke", family="vlm", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128, vocab=512,
        pattern=(SlotSpec(),), prefix_len=8)
