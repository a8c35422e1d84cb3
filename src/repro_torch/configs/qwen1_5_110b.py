"""Qwen1.5-110B [hf:Qwen]: dense GQA with QKV bias."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense", num_layers=80, d_model=8192,
    num_heads=64, kv_heads=8, d_ff=49152, vocab_size=152064,
    qkv_bias=True, rope_theta=1000000.0,
    param_dtype="bfloat16")   # memory policy for the giant (DESIGN.md §5)
