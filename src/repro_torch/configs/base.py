"""Configuration schema: model architecture, run shapes, mesh, training.

Every assigned architecture is a ``ModelConfig`` in its own module
(``repro_torch/configs/<id>.py``) with the exact published
hyper-parameters; the registry in ``repro_torch.configs`` resolves
``--arch <id>``.

A copy of the JAX package's ``configs/base.py``, field for field, so that
the port never imports that package (its ``configs/__init__.py`` imports
JAX).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    shared_experts: int = 0          # deepseek-style always-on experts
    dense_residual_d_ff: int = 0     # arctic-style parallel dense FFN
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba2"             # "mamba2" | "xlstm"
    state_dim: int = 64
    expand: int = 2
    conv_dim: int = 4
    chunk: int = 256                 # chunkwise-parallel scan chunk
    # xlstm: one sLSTM block every ``slstm_period`` blocks (rest mLSTM)
    slstm_period: int = 8
    # zamba2: one *shared* full-attention block applied every period blocks
    shared_attn_period: int = 6


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|encdec|vlm
    num_layers: int
    d_model: int
    num_heads: int
    kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 → d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # encoder-decoder (seamless): encoder layer count; frontend stub
    encoder_layers: int = 0
    frontend: str = "none"           # none|audio|vision
    mrope: bool = False              # qwen2-vl M-RoPE
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    # memory/precision policy (production knobs)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "block"             # none|block|full
    # dry-run probes: fully unroll layer scans so cost_analysis counts
    # every layer (XLA counts while bodies once) — see benchmarks/roofline
    unroll: bool = False
    # attention context policy for sub-quadratic archs
    sub_quadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    mode: str                        # train|prefill|decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    optimizer: str = "adamw"          # adamw|adafactor
    opt_state_dtype: str = "float32"  # bfloat16 for memory-tight giants
    microbatches: int = 1             # gradient accumulation
    grad_compression: bool = False    # int8 error-feedback DP compression
    z_loss: float = 1e-4


def shapes_for(cfg: ModelConfig):
    """The shape cells this architecture runs (harness skip rules)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.sub_quadratic:
        out.append(LONG_500K)
    return out
