"""granite-3-2b [dense]: 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155 — GQA [hf:ibm-granite/granite-3.0-2b-base; hf].
vocab pads 49155 -> 49280 (a multiple of 128)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b", family="dense", n_layers=40, d_model=2048,
    n_heads=32, n_kv=8, d_ff=8192, vocab=49155, d_head=64,
    tie_embeddings=True)

SMOKE = ModelConfig(
    name="granite-3-2b-smoke", family="dense", n_layers=4, d_model=128,
    n_heads=4, n_kv=2, d_ff=256, vocab=515, d_head=32, tie_embeddings=True)
