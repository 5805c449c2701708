"""Model and input-shape configuration (the port's own copy of
``repro.configs.base``).

One ``ModelConfig`` dataclass covers every architecture family of the JAX
package (dense GQA, MoE, MLA, SSM, hybrid, enc-dec, VLM-stub), so that
``param_count``, ``active_param_count`` and the layer pattern are the
reference's for any config. The port runs every family (MLA included);
each architecture file exports ``CONFIG`` (full size) and ``SMOKE``
(reduced, runs on the CPU). ``SHAPES`` are the reference's input-shape
cells, which the dry run (``launch/dryrun.py``) counts.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    n_experts: int            # routed experts
    top_k: int
    n_shared: int = 0         # always-on shared experts
    d_ff_expert: int = 0      # per-expert FFN width (0 -> use model d_ff)
    every: int = 1            # MoE every Nth layer (others dense)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MlaConfig:
    kv_lora: int              # compressed KV dim (c_kv)
    q_lora: int = 0           # 0 -> no query compression
    rope_head_dim: int = 64   # decoupled RoPE key/query dim
    v_head_dim: int = 128
    nope_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SsmConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0          # 0 -> ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int = 0                 # 0 -> d_model // n_heads
    qk_norm: bool = False           # qwen3-style per-head RMSNorm on q/k
    qkv_bias: bool = False          # qwen2-style
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: MoeConfig | None = None
    mla: MlaConfig | None = None
    ssm: SsmConfig | None = None
    # hybrid (jamba): one attention layer per `attn_period` layers, rest SSM
    attn_period: int = 0            # 0 -> all layers attention (or all SSM)
    # enc-dec (whisper): encoder depth + stub frontend sequence length
    n_enc_layers: int = 0
    enc_seq: int = 1500             # precomputed audio-frame embeddings
    # vlm (llava): stub frontend provides precomputed patch embeddings
    n_img_tokens: int = 0
    sub_quadratic: bool = False     # can run long_500k

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def layer_pattern(self) -> tuple[str, ...]:
        """Kinds of the layers inside one repeated block."""
        if self.family == "ssm":
            return ("ssm",)
        if self.family == "hybrid":
            assert self.attn_period > 0
            pat = ["ssm"] * self.attn_period
            pat[self.attn_period // 2] = "attn"   # jamba puts attn mid-block
            return tuple(pat)
        return ("attn",)

    @property
    def block_repeats(self) -> int:
        pat = len(self.layer_pattern)
        assert self.n_layers % pat == 0, (self.n_layers, pat)
        return self.n_layers // pat

    def moe_at(self, layer_idx: int) -> bool:
        """Is this layer's FFN an MoE block?"""
        if self.moe is None:
            return False
        return (layer_idx % self.moe.every) == (self.moe.every - 1)

    def ffn_kind(self, layer_idx: int) -> str:
        """'moe' | 'dense' | 'none' for this layer's FFN component."""
        if self.moe_at(layer_idx):
            return "moe"
        return "dense" if self.d_ff > 0 else "none"

    def param_count(self) -> int:
        """Analytic parameter count (embedding, head and every layer)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        h, kv, dh = self.n_heads, self.n_kv, self.head_dim
        total = v * d * (1 if self.tie_embeddings else 2)
        for li in range(self.n_layers):
            kind = self.layer_pattern[li % len(self.layer_pattern)]
            if kind == "ssm":
                s = self.ssm or SsmConfig()
                d_in = s.expand * d
                dt_rank = s.dt_rank or -(-d // 16)
                total += (d * 2 * d_in + d_in * s.d_conv
                          + d_in * (dt_rank + 2 * s.d_state)
                          + dt_rank * d_in + d_in * s.d_state + d_in
                          + d_in * d)
            elif self.mla is not None:
                m = self.mla
                q_in = m.q_lora or d
                total += d * m.kv_lora + d * m.rope_head_dim
                if m.q_lora:
                    total += d * m.q_lora
                total += q_in * h * (m.nope_head_dim + m.rope_head_dim)
                total += m.kv_lora * h * (m.nope_head_dim + m.v_head_dim)
                total += h * m.v_head_dim * d
            else:
                total += d * h * dh + 2 * d * kv * dh + h * dh * d
            fk = self.ffn_kind(li)
            if fk == "moe":
                mo = self.moe
                fe = mo.d_ff_expert or f
                total += d * mo.n_experts  # router
                total += (mo.n_experts + mo.n_shared) * 3 * d * fe
            elif fk == "dense":
                total += 3 * d * f
        # encoder layers (whisper): bidirectional attn + dense FFN; decoder
        # layers above additionally carry cross-attention
        if self.n_enc_layers:
            total += self.n_enc_layers * (d * h * dh + 2 * d * kv * dh
                                          + h * dh * d + 3 * d * f)
            total += self.n_layers * (d * h * dh + 2 * d * kv * dh
                                      + h * dh * d)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared only)."""
        if self.moe is None:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        total = self.param_count()
        mo = self.moe
        fe = mo.d_ff_expert or f
        n_moe_layers = sum(1 for li in range(self.n_layers) if self.moe_at(li))
        inactive = n_moe_layers * (mo.n_experts - mo.top_k) * 3 * d * fe
        return total - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: a step of ``kind`` over ``global_batch``
    sequences of ``seq_len`` positions (decode: one new token against
    caches of ``seq_len``)."""
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524288, 1, "decode"),
}
