"""deepseek-v2-236b [moe]: 60 layers, d_model 5120, 128 heads of d_head
192 (128 without RoPE + 64 with), MLA with kv_lora 512 and q_lora 1536,
v_head_dim 128, vocab 102400, 2 shared + 160 routed experts top-6 of
width 1536 [arXiv:2405.04434]. As in the reference, the model's first
dense layer (first_k_dense_replace=1) is an MoE layer like the others."""
from .base import MlaConfig, ModelConfig, MoeConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe", n_layers=60, d_model=5120,
    n_heads=128, n_kv=128, d_ff=12288, vocab=102400, d_head=192,
    mla=MlaConfig(kv_lora=512, q_lora=1536, rope_head_dim=64,
                  v_head_dim=128, nope_head_dim=128),
    moe=MoeConfig(n_experts=160, top_k=6, n_shared=2, d_ff_expert=1536,
                  every=1))

SMOKE = ModelConfig(
    name="deepseek-v2-smoke", family="moe", n_layers=4, d_model=128,
    n_heads=4, n_kv=4, d_ff=256, vocab=512, d_head=48,
    mla=MlaConfig(kv_lora=64, q_lora=96, rope_head_dim=16, v_head_dim=32,
                  nope_head_dim=32),
    moe=MoeConfig(n_experts=8, top_k=2, n_shared=1, d_ff_expert=64, every=1))
