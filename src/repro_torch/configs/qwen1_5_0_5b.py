"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B]: small dense, QKV bias, MHA."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense", num_layers=24, d_model=1024,
    num_heads=16, kv_heads=16, d_ff=2816, vocab_size=151936,
    qkv_bias=True, rope_theta=1000000.0, tie_embeddings=True)
