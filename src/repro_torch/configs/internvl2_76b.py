"""InternVL2-76B language backbone [arXiv:2404.16821].

InternViT-6B vision encoder + projector are the STUB frontend (the assignment
carve-out): ``input_specs`` feeds precomputed patch embeddings
``vision_embeds (B, vision_tokens, d_model)`` spliced into the token prefix.
The config below is the InternLM2-76B decoder trunk.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    source="InternViT + InternLM2 [arXiv:2404.16821]",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,        # GQA
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    vision_tokens=256,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    pos_type="rope",
    rope_theta=1e6,
    fed_mode="sequential",  # 152 GB bf16 params: cannot replicate per client group
)


def smoke_config() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=512, vocab_size=512, vision_tokens=8,
        dtype="float32", fed_mode="parallel")
