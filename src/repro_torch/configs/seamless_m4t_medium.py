"""SeamlessM4T-medium [arXiv:2308.11596]: encoder-decoder; the speech
frontend is a STUB — input_specs provides precomputed frame embeddings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec", num_layers=12,
    encoder_layers=12, d_model=1024, num_heads=16, kv_heads=16, d_ff=4096,
    vocab_size=256206, frontend="audio", rope_theta=10000.0)
