"""Qwen1.5-4B: dense decoder with QKV bias, MHA (kv = q heads)
[hf:Qwen/Qwen1.5-0.5B family scaled per assignment]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    source="QKV bias [hf:Qwen/Qwen1.5-0.5B]",
    num_layers=40,
    d_model=2560,
    num_heads=20,          # NOTE: 20 % 16 != 0 — sharded on the flat qkv dim
    num_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    pos_type="rope",
    rope_theta=1e6,
    fed_mode="parallel",
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
        head_dim=64, d_ff=512, vocab_size=512, dtype="float32")
