"""qwen3-0.6b [dense]: 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936 — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense", n_layers=28, d_model=1024, n_heads=16,
    n_kv=8, d_ff=3072, vocab=151936, d_head=128, qk_norm=True,
    tie_embeddings=True, rope_theta=1e6)

SMOKE = ModelConfig(
    name="qwen3-0.6b-smoke", family="dense", n_layers=4, d_model=128,
    n_heads=4, n_kv=2, d_ff=256, vocab=512, d_head=32, qk_norm=True,
    tie_embeddings=True)
