"""Architecture & run configuration schema (a copy of the JAX package's
``configs/base.py``; the two are held field by field equal by
``tests/test_torch_configs.py``).

Every assigned architecture gets a ``configs/<id>.py`` exporting
``CONFIG`` (the exact published shape) and ``smoke_config()`` (a reduced
variant of the same family for CPU tests).  ``registry.py`` provides lookup.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str = "unnamed"
    family: str = "dense"            # dense | moe | ssm | hybrid | encdec | vlm
    source: str = ""                 # citation (paper/model card)

    # transformer trunk
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 1024

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0          # 0 = full causal attention
    mlp_type: str = "swiglu"         # swiglu | gelu
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    pos_type: str = "rope"           # rope | learned | sinusoidal | none
    max_position: int = 524288       # for learned/sinusoidal tables
    logit_softcap: float = 0.0

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_mode: str = "dense"          # dense (compute-all) | dispatch (capacity)
    capacity_factor: float = 1.25

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    ssm_conv: int = 4
    ssm_groups: int = 1

    # hybrid (RecurrentGemma): layer pattern repeated; tail = leftover layers
    block_pattern: tuple = ()        # e.g. ("rglru", "rglru", "attn")
    lru_width: int = 0
    local_window: int = 2048

    # encoder-decoder (whisper backbone)
    encoder_layers: int = 0
    encoder_seq: int = 0             # stub frontend sequence length (frames)

    # vlm (stub vision frontend)
    vision_tokens: int = 0           # patch embeddings prepended to the text

    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # distribution / federated execution
    fed_mode: str = "parallel"       # parallel | sequential (DESIGN.md §3.2)
    # role of the mesh "model" axis in parallel-mode training:
    #   "tp" = tensor parallelism (weights sharded; default)
    #   "dp" = extra data parallelism within each client group (weights
    #          replicated over the model axis; right choice for small models
    #          where TP collectives dwarf per-device compute — see §Perf)
    model_axis_role: str = "tp"
    # constrain padded logits' vocab dim over the model axis (disable in "dp")
    shard_logits_vocab: bool = True
    micro_batches: int = 1           # grad-accumulation microbatches per local step
    optimizer: str = "adam"          # local client optimizer (adam | sgd | sgd_momentum)
    # blocked (online-softmax) attention: O(S*block) memory instead of O(S^2)
    # — the XLA-level mirror of kernels/flash_attention (see §Perf)
    attn_blocked: bool = False
    attn_block_k: int = 2048
    # ZeRO-1 in dp-mode: optimizer state sharded over the (idle) model axis;
    # params stay replicated for compute, grads reduce-scatter into the shard
    zero_opt_over_model: bool = False
    remat: bool = True               # activation checkpointing per layer
    scan_layers: bool = True
    scan_unroll: bool = False        # fully unroll layer scans (cost calibration)

    # serving variant: force sliding-window serving for long-context decode on
    # otherwise full-attention archs (DESIGN.md decode-shape policy)
    serve_swa_window: int = 4096

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    def num_params(self) -> int:
        """Analytic parameter count (embedding + trunk), for roofline 6ND."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.pos_type == "learned":
            emb += self.max_position * d
        if self.family == "ssm":
            din = self.ssm_inner
            nh, st = self.ssm_heads, self.ssm_state
            conv_ch = din + 2 * self.ssm_groups * st
            per = (d * (2 * din + 2 * self.ssm_groups * st + nh)  # in_proj
                   + conv_ch * self.ssm_conv                       # conv
                   + 3 * nh                                        # A_log, D, dt_bias
                   + din                                           # gated norm
                   + din * d + d)                                  # out_proj + ln
            return emb + self.num_layers * per
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qkv_bias:
            attn += self.q_dim + 2 * self.kv_dim
        if self.mlp_type == "swiglu":
            mlp = 3 * d * ff
        else:
            mlp = 2 * d * ff + ff + d
        norms = 2 * d
        per_dense = attn + mlp + norms
        if self.family == "moe":
            per = attn + norms + d * self.num_experts + self.num_experts * 3 * d * ff
            return emb + self.num_layers * per
        if self.family == "hybrid":
            pat = self.block_pattern or ("rglru",)
            n_attn = sum(1 for _ in range(self.num_layers)
                         if pat[_ % len(pat)] == "attn")
            n_rec = self.num_layers - n_attn
            w = self.lru_width or d
            rec = (2 * d * w          # x/y branches
                   + w * self.ssm_conv
                   + 3 * w            # lambda + gates biases-ish
                   + 2 * w * w // max(1, w // w)  # gate projections (diagonal-block approx)
                   + w * d) + norms + mlp
            # use explicit accounting instead of the approx above:
            rec = (2 * d * w + w * self.ssm_conv + w + 2 * (w * w + w)
                   + w * d) + norms + mlp
            att = per_dense
            return emb + n_rec * rec + n_attn * att
        if self.family == "encdec":
            dec_per = per_dense + (d * self.q_dim + 2 * d * self.kv_dim
                                   + self.q_dim * d + d)  # + cross attn
            return emb + self.encoder_layers * per_dense + self.num_layers * dec_per
        return emb + self.num_layers * per_dense

    def num_active_params(self) -> int:
        """Active params per token (MoE top-k)."""
        if self.family != "moe":
            return self.num_params()
        d, ff = self.d_model, self.d_ff
        total = self.num_params()
        all_exp = self.num_layers * self.num_experts * 3 * d * ff
        act_exp = self.num_layers * self.experts_per_token * 3 * d * ff
        return total - all_exp + act_exp


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
