"""whisper-small [audio]: 12 encoder and 12 decoder layers, d_model 768,
12 heads of 64, d_ff 3072, vocab 51865 [arXiv:2212.04356]. The
convolutional audio frontend is a stub: the encoder takes precomputed
frame embeddings, 1500 frames (30 s of audio)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec", n_layers=12, d_model=768,
    n_heads=12, n_kv=12, d_ff=3072, vocab=51865, d_head=64,
    n_enc_layers=12, enc_seq=1500)

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec", n_layers=2, d_model=128,
    n_heads=4, n_kv=4, d_ff=256, vocab=512, d_head=32,
    n_enc_layers=2, enc_seq=64)
