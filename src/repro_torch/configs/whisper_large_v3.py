"""whisper-large-v3 [audio]: enc-dec, 32L each, d=1280 20H (kv=20) d_ff=5120
vocab=51866. Conv/mel frontend is a STUB: input_specs provides 1500
precomputed frame embeddings. Decoder: causal self-attn + cross-attn.
Deviations (DESIGN.md): RoPE instead of learned/sinusoidal positions so long
decode shapes are well-defined; non-gated GELU MLP as published.
[arXiv:2212.04356; unverified tier] -- the same two configs as
``repro.configs.whisper_large_v3``."""
from repro_torch.configs.registry import register, register_smoke
from repro_torch.models.config import ModelConfig, SlotSpec


@register("whisper_large_v3")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper_large_v3", family="audio", n_layers=32, d_model=1280,
        n_heads=20, n_kv_heads=20, head_dim=64, d_ff=5120, vocab=51_866,
        pattern=(SlotSpec(mixer="attn", window=0, ffn="mlp", cross=True),),
        encoder_layers=32, num_frames=1500, gated_mlp=False)


@register_smoke("whisper_large_v3")
def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper_large_v3_smoke", family="audio", n_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
        vocab=512,
        pattern=(SlotSpec(mixer="attn", window=0, ffn="mlp", cross=True),),
        encoder_layers=2, num_frames=24, gated_mlp=False)
