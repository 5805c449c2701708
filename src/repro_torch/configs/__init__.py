"""Config registry: the configurations of every architecture of the JAX
package's registry, each the reference's field for field. An id whose
module is not in ``PORTED`` raises ``NotImplementedError``."""
from __future__ import annotations

import importlib

from .base import (SHAPES, MlaConfig, ModelConfig, MoeConfig,  # noqa: F401
                   ShapeConfig, SsmConfig)

#: Canonical external ids (``--arch <id>``) -> module name.
ARCH_IDS = {
    "jamba-v0.1-52b": "jamba_v01_52b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "qwen3-4b": "qwen3_4b",
    "qwen2-1.5b": "qwen2_1_5b",
    "granite-3-2b": "granite_3_2b",
    "qwen3-0.6b": "qwen3_0_6b",
    "llava-next-34b": "llava_next_34b",
    "whisper-small": "whisper_small",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "deepseek-v2-236b": "deepseek_v2_236b",
}
#: The modules this package ports.
PORTED = ("falcon_mamba_7b", "jamba_v01_52b", "qwen3_0_6b", "qwen2_1_5b",
          "granite_3_2b", "qwen3_4b", "qwen2_moe_a2_7b", "deepseek_v2_236b",
          "whisper_small", "llava_next_34b")


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod_name = ARCH_IDS.get(arch, arch)
    if mod_name not in ARCH_IDS.values():
        raise KeyError(f"unknown architecture {arch!r}; known: "
                       f"{', '.join(ARCH_IDS)}")
    if mod_name not in PORTED:
        raise NotImplementedError(
            f"{arch}: not ported to repro_torch yet (see ROADMAP.md, queue 1, "
            f"\"Modules to port\"); ported: {', '.join(PORTED)}")
    mod = importlib.import_module(f"{__name__}.{mod_name}")
    return mod.SMOKE if smoke else mod.CONFIG


def all_archs() -> list[str]:
    """Every architecture id, in the reference's order."""
    return list(ARCH_IDS)
