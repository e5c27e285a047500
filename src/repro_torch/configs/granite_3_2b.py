"""Granite-3.0-2B base: dense GQA [hf:ibm-granite/granite-3.0-2b-base].

vocab 49155 is NOT divisible by the model axis (16) — the embedding shards on
d_model instead (dist/sharding.py handles the fallback automatically)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    source="GQA [hf:ibm-granite/granite-3.0-2b-base]",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49155,
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
        head_dim=64, d_ff=512, vocab_size=515, dtype="float32")
