"""Qwen2-VL-7B [arXiv:2409.12191]: GQA kv=4 backbone, M-RoPE; the vision
frontend is a STUB — input_specs provides precomputed patch embeddings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm", num_layers=28, d_model=3584,
    num_heads=28, kv_heads=4, d_ff=18944, vocab_size=152064,
    qkv_bias=True, rope_theta=1000000.0, mrope=True,
    mrope_sections=(16, 24, 24), frontend="vision")
