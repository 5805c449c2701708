"""jamba-v0.1-52b [hybrid]: 32 layers, d_model 4096, 32 heads over 8 kv
heads, d_ff 14336, vocab 65536, MoE of 16 experts top-2 on every other
layer, Mamba and attention interleaved 7:1 [arXiv:2403.19887]. A block is
ssm×4, attn, ssm×3 (attention mid-block), repeated 4 times; the MoE sits
at pattern positions 1, 3, 5 and 7, dense SwiGLU FFNs at the others."""
from .base import ModelConfig, MoeConfig, SsmConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
    n_heads=32, n_kv=8, d_ff=14336, vocab=65536, d_head=128,
    attn_period=8,
    moe=MoeConfig(n_experts=16, top_k=2, every=2),
    ssm=SsmConfig(d_state=16, d_conv=4, expand=2), sub_quadratic=True)

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid", n_layers=8, d_model=128, n_heads=4,
    n_kv=2, d_ff=256, vocab=512, d_head=32, attn_period=4,
    moe=MoeConfig(n_experts=4, top_k=2, every=2),
    ssm=SsmConfig(d_state=8, d_conv=4, expand=2), sub_quadratic=True)
