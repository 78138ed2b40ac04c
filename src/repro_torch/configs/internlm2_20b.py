"""internlm2-20b [dense]: 48L d=6144 48H (GQA kv=8) d_ff=16384 vocab=92544.
Full (global) attention, GQA. [arXiv:2403.17297; hf:internlm/internlm2-20b] -- the same two
configs as ``repro.configs.internlm2_20b``."""
from repro_torch.configs.registry import register, register_smoke
from repro_torch.models.config import ModelConfig, SlotSpec


@register("internlm2_20b")
def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2_20b", family="dense", n_layers=48, d_model=6144,
        n_heads=48, n_kv_heads=8, head_dim=128, d_ff=16384, vocab=92_544,
        pattern=(SlotSpec(),), rope_theta=1_000_000.0)


@register_smoke("internlm2_20b")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="internlm2_20b_smoke", family="dense", n_layers=2, d_model=96,
        n_heads=6, n_kv_heads=2, head_dim=16, d_ff=192, vocab=512,
        pattern=(SlotSpec(),))
