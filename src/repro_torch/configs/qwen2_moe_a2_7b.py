"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, 60 routed top-4 + shared expert (4x1408 wide)
[hf:Qwen/Qwen1.5-MoE-A2.7B]. On one device the 60 experts are not padded,
and 16 kv heads against 16 q-heads stay 16 (``pad_heads``' kv ≥ h branch)."""
from .base import ModelConfig, MoeConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe", n_layers=24, d_model=2048,
    n_heads=16, n_kv=16, d_ff=5632, vocab=151936, d_head=128, qkv_bias=True,
    moe=MoeConfig(n_experts=60, top_k=4, n_shared=4, d_ff_expert=1408,
                  every=1))

SMOKE = ModelConfig(
    name="qwen2-moe-smoke", family="moe", n_layers=4, d_model=128, n_heads=4,
    n_kv=4, d_ff=256, vocab=512, d_head=32, qkv_bias=True,
    moe=MoeConfig(n_experts=8, top_k=2, n_shared=1, d_ff_expert=64, every=1))
