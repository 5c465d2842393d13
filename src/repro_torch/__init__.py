"""PyTorch / CUDA port of the ``repro`` model stack, for NVIDIA Hopper.

The package mirrors the layout and names of the JAX package ``repro`` (the
reference), so each module here has a counterpart there:
``repro_torch/models/attention.py`` <-> ``repro/models/attention.py`` and so
on. It imports ``torch`` and numpy only; it never imports ``jax`` nor any
module of ``repro``.

Device rule: entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``, or ``--device cpu`` on a CLI). There is no silent CPU path:
asking for ``cuda`` on a host without a card raises :class:`DeviceUnavailable`.
"""
from __future__ import annotations

import os

import torch

DEFAULT_DEVICE = "cuda"


class DeviceUnavailable(RuntimeError):
    """Raised when an entry point is asked for a device this host lacks."""


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``cpu`` is asked for."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            "repro_torch runs on a CUDA device by default and this host has none; "
            "pass device='cpu' (or --device cpu) to run the plain CPU path")
    if dev.type not in ("cuda", "cpu"):
        raise DeviceUnavailable(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def deterministic(device: str | torch.device) -> None:
    """Bit-for-bit repeatable training on ``device``: deterministic
    algorithms, TF32 off and, on a card, cuBLAS's fixed workspace (whose
    variable is read when a cuBLAS call is made, so set it before the
    first one; an already-set value is kept)."""
    if torch.device(device).type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


__all__ = ["DEFAULT_DEVICE", "DeviceUnavailable", "deterministic", "resolve_device"]
