"""Training launcher: for now only the reduced configs, which the serve
launcher and the card checks share.

``reduced_config`` is the JAX package's (``launch/train.py``);
``tiny_config`` is the smallest variant its smoke tests run
(``tests/test_smoke_archs.py`` ``reduce_config``), for every family. The
training launcher itself (optimizers, data pipeline, train step,
checkpointed resume) is a later slice of the port.
"""
from __future__ import annotations

from repro_torch.configs.base import MLAConfig, MoEConfig, SSMConfig


def reduced_config(cfg, d_model: int = 512, layers: int = 8):
    """~100M-class variant of the same family (the tests use a tinier
    one)."""
    kw = dict(num_layers=layers, d_model=d_model,
              num_heads=max(4, d_model // 128), kv_heads=4,
              d_ff=d_model * 3, vocab_size=32000,
              compute_dtype="float32", param_dtype="float32")
    if cfg.family == "ssm":
        kw["num_layers"] = (layers // cfg.ssm.slstm_period + 1) \
            * cfg.ssm.slstm_period
        kw["kv_heads"] = kw["num_heads"]
    if cfg.family == "hybrid":
        kw["kv_heads"] = kw["num_heads"]
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(num_experts=8, top_k=2,
                              expert_d_ff=d_model,
                              shared_experts=min(cfg.moe.shared_experts, 1),
                              dense_residual_d_ff=d_model
                              if cfg.moe.dense_residual_d_ff else 0)
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=128, q_lora_rank=192,
                              rope_head_dim=32, nope_head_dim=64,
                              v_head_dim=64)
    if cfg.mrope:
        hd = d_model // kw["num_heads"]
        kw["mrope_sections"] = (hd // 4, hd // 8, hd // 8)
    if cfg.family in ("encdec", "audio"):
        kw["encoder_layers"] = layers
    return cfg.replace(**kw)


def tiny_config(cfg):
    """The smallest variant of a config that keeps its family's
    structure: d_model 64, 2 layers, 4 query heads over 2 KV heads, d_ff
    128, vocab 256, float32; xlstm 4 layers in groups of 2, zamba2 5 (two
    groups of 2 and a tail), 8 experts top-2, MLA of ranks 16 / 24."""
    kw = dict(num_layers=2, d_model=64, num_heads=4, kv_heads=2,
              d_ff=128, vocab_size=256, compute_dtype="float32",
              param_dtype="float32", remat="none")
    if cfg.family == "ssm":      # xlstm: layers % slstm_period == 0
        kw.update(num_layers=4, kv_heads=4,
                  ssm=SSMConfig(kind="xlstm", expand=2, conv_dim=4,
                                chunk=8, slstm_period=2))
    if cfg.family == "hybrid":   # zamba2: groups of period + tail
        kw.update(num_layers=5, kv_heads=4,
                  ssm=SSMConfig(kind="mamba2", state_dim=8, expand=2,
                                conv_dim=4, chunk=8, shared_attn_period=2))
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            num_experts=8, top_k=2, expert_d_ff=32,
            shared_experts=min(cfg.moe.shared_experts, 1),
            dense_residual_d_ff=32 if cfg.moe.dense_residual_d_ff else 0)
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=16, q_lora_rank=24,
                              rope_head_dim=4, nope_head_dim=8,
                              v_head_dim=8)
    if cfg.mrope:
        kw["mrope_sections"] = (2, 3, 3)   # head_dim 16 -> half 8
    if cfg.family in ("encdec", "audio"):
        kw["encoder_layers"] = 2
    return cfg.replace(**kw)
