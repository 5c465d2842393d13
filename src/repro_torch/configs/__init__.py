"""Architecture registry: ``get_config(arch_id)`` for the archs the port runs.

``ARCHS`` lists only what ``repro_torch`` can run so far. The reference
registry (``repro.configs.ARCHS``) has more; asking for one of those raises
``NotImplementedError`` until a later slice ports its family.
"""
from __future__ import annotations

import importlib
from typing import Tuple

ARCHS: Tuple[str, ...] = (
    "llama3-8b", "mamba2-130m", "olmo-1b", "phi4-mini-3.8b", "yi-34b",
    "olmoe-1b-7b", "jamba-v0.1-52b", "deepseek-v3-671b",
)

# The reference registry's archs, so that an unported one is told apart
# from a name that does not exist at all.
REFERENCE_ARCHS: Tuple[str, ...] = (
    "llama3-8b", "olmo-1b", "yi-34b", "phi4-mini-3.8b", "deepseek-v3-671b",
    "olmoe-1b-7b", "whisper-tiny", "jamba-v0.1-52b", "mamba2-130m",
    "qwen2-vl-2b",
)


def get_config(arch: str):
    if arch not in ARCHS:
        if arch in REFERENCE_ARCHS:
            raise NotImplementedError(
                f"{arch!r} is not yet ported to repro_torch (ported: {', '.join(ARCHS)})")
        raise ValueError(f"unknown arch {arch!r}; known: {', '.join(REFERENCE_ARCHS)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")
    return mod.get_config()
