"""xLSTM-1.3B [arXiv:2405.04517]: mLSTM blocks with periodic sLSTM
(7:1 ratio). Sub-quadratic -> runs long_500k."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm", num_layers=48, d_model=2048,
    num_heads=4, kv_heads=4, d_ff=0, vocab_size=50304,
    ssm=SSMConfig(kind="xlstm", expand=2, conv_dim=4, chunk=256,
                  slstm_period=8),
    sub_quadratic=True)
