"""qwen2-1.5b [dense]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936
— GQA, QKV bias [arXiv:2407.10671; hf]. The port has no tensor-parallel
mesh, so its 12 q-heads stay 12 (2 kv heads, groups of 6)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense", n_layers=28, d_model=1536, n_heads=12,
    n_kv=2, d_ff=8960, vocab=151936, d_head=128, qkv_bias=True,
    tie_embeddings=True, rope_theta=1e6)

SMOKE = ModelConfig(
    name="qwen2-1.5b-smoke", family="dense", n_layers=4, d_model=128,
    n_heads=4, n_kv=2, d_ff=256, vocab=512, d_head=32, qkv_bias=True,
    tie_embeddings=True)
