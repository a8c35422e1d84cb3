"""Qwen2.5-3B [hf:Qwen]: GQA kv=2, QKV bias."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense", num_layers=36, d_model=2048,
    num_heads=16, kv_heads=2, d_ff=11008, vocab_size=151936,
    qkv_bias=True, rope_theta=1000000.0, tie_embeddings=True)
