"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936
— qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="dense", n_layers=36, d_model=2560, n_heads=32,
    n_kv=8, d_ff=9728, vocab=151936, d_head=128, qk_norm=True,
    rope_theta=1e6)

SMOKE = ModelConfig(
    name="qwen3-4b-smoke", family="dense", n_layers=4, d_model=128, n_heads=4,
    n_kv=2, d_ff=256, vocab=512, d_head=32, qk_norm=True)
