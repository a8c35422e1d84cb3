"""Zamba2-7B [arXiv:2411.15242]: Mamba2 backbone with a *shared*
full-attention block applied every 6 layers. Sub-quadratic -> long_500k."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid", num_layers=81, d_model=3584,
    num_heads=32, kv_heads=32, d_ff=14336, vocab_size=32000,
    rope_theta=10000.0,
    ssm=SSMConfig(kind="mamba2", state_dim=64, expand=2, conv_dim=4,
                  chunk=256, shared_attn_period=6),
    sub_quadratic=True)
