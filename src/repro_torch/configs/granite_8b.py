"""Granite-8B code model [arXiv:2405.04324]: llama-architecture dense GQA."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    source="llama-arch, code [arXiv:2405.04324]",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    pos_type="rope",
    rope_theta=1e4,
    fed_mode="parallel",
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=512, vocab_size=512, dtype="float32")
