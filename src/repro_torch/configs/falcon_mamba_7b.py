"""falcon-mamba-7b [ssm]: 64 layers, d_model 4096, attention-free,
ssm_state 16 — the Mamba-1 architecture [arXiv:2410.05355]."""
from .base import ModelConfig, SsmConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm", n_layers=64, d_model=4096,
    n_heads=1, n_kv=1, d_ff=0, vocab=65024, d_head=64,
    ssm=SsmConfig(d_state=16, d_conv=4, expand=2), sub_quadratic=True)

SMOKE = ModelConfig(
    name="falcon-mamba-7b-smoke", family="ssm", n_layers=4, d_model=128,
    n_heads=1, n_kv=1, d_ff=0, vocab=512, d_head=32,
    ssm=SsmConfig(d_state=8, d_conv=4, expand=2), sub_quadratic=True)
