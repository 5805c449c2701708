"""llava-next-34b [vlm]: 60 layers, d_model 7168, 56 heads over 8 kv heads
of 128, d_ff 20480, vocab 64000, anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf]. The vision frontend is a stub:
the model takes precomputed patch embeddings (the anyres tiling happens
upstream), prepended to the text."""
from .base import ModelConfig

N_IMG_TOKENS = 2880  # anyres: base 576 + 4 tiles x 576

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm", n_layers=60, d_model=7168,
    n_heads=56, n_kv=8, d_ff=20480, vocab=64000, d_head=128,
    n_img_tokens=N_IMG_TOKENS)

SMOKE = ModelConfig(
    name="llava-smoke", family="vlm", n_layers=4, d_model=128, n_heads=4,
    n_kv=2, d_ff=256, vocab=512, d_head=32, n_img_tokens=16)
