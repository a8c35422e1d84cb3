"""Snowflake Arctic-480B [hf:Snowflake/snowflake-arctic-base]:
128-expert top-2 MoE in parallel with a dense residual FFN."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe", num_layers=35, d_model=7168,
    num_heads=56, kv_heads=8, d_ff=4864, vocab_size=32000,
    rope_theta=10000.0,
    moe=MoEConfig(num_experts=128, top_k=2, expert_d_ff=4864,
                  dense_residual_d_ff=4864),
    param_dtype="bfloat16")
