"""Architecture registry: ``get_config(arch_id)``, for the same archs, in the
same order, as the reference registry (``repro.configs.ARCHS``)."""
from __future__ import annotations

import importlib
from typing import Tuple

ARCHS: Tuple[str, ...] = (
    "llama3-8b", "olmo-1b", "yi-34b", "phi4-mini-3.8b", "deepseek-v3-671b",
    "olmoe-1b-7b", "whisper-tiny", "jamba-v0.1-52b", "mamba2-130m",
    "qwen2-vl-2b",
)


def get_config(arch: str):
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; known: {', '.join(ARCHS)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")
    return mod.get_config()
