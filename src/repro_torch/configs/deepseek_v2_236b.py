"""DeepSeek-V2-236B [arXiv:2405.04434]: MLA (kv_lora=512) + MoE
(2 shared + 160 routed, top-6); first layer dense."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe", num_layers=60, d_model=5120,
    num_heads=128, kv_heads=128, d_ff=12288, vocab_size=102400,
    rope_theta=10000.0,
    moe=MoEConfig(num_experts=160, top_k=6, expert_d_ff=1536,
                  shared_experts=2),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    param_dtype="bfloat16")
