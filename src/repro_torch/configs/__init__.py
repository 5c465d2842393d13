"""Architecture registry: ``get_config(arch_id)``, for the same archs, in the
same order, as the reference registry (``repro.configs.ARCHS``), then the
port's own (``PORT_ARCHS``: models the reference does not register), and the
assigned shape set (``SHAPES``, ``shape_cells``)."""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict, List, Tuple

ARCHS: Tuple[str, ...] = (
    "llama3-8b", "olmo-1b", "yi-34b", "phi4-mini-3.8b", "deepseek-v3-671b",
    "olmoe-1b-7b", "whisper-tiny", "jamba-v0.1-52b", "mamba2-130m",
    "qwen2-vl-2b",
)
# resolved by get_config beside ARCHS, which stays the reference's registry
PORT_ARCHS: Tuple[str, ...] = ("deepseek-v2-lite-16b",)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str               # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def get_config(arch: str):
    if arch not in ARCHS + PORT_ARCHS:
        raise ValueError(f"unknown arch {arch!r}; known: {', '.join(ARCHS + PORT_ARCHS)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")
    return mod.get_config()


def shape_cells(arch: str) -> List[str]:
    """Shapes assigned to this arch (long_500k only for sub-quadratic)."""
    cfg = get_config(arch)
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if not cfg.is_quadratic:
        cells.append("long_500k")
    return cells
