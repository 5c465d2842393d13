"""Production and local meshes, and the card's peak rates.

Counterpart of ``repro.launch.mesh``. ``make_production_mesh`` returns the
reference's production meshes as :class:`LogicalMesh` objects: axis names
and sizes for shape and byte accounting over 256 or 512 chips that need not
exist (the dry run). ``make_local_mesh`` returns a ``DeviceMesh`` over the
ranks of the initialised process group.

The reference's TPU constants have no counterpart. The roofline here is the
NVIDIA H100 80GB HBM3's (NVIDIA's data sheet, SXM part, dense rates at the
700 W power limit), which ``chip_smoke.py`` also reads.
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.parallel.sharding import LogicalMesh

H100_PEAK_BF16_FLOPS = 989e12       # per card, bf16 tensor cores
H100_PEAK_F32_FLOPS = 67e12         # per card, float32 outside the tensor cores
H100_HBM_BYTES_S = 3.35e12          # HBM3 bytes/s per card
H100_HBM_BYTES = 80e9               # the data sheet's 80 GB


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return LogicalMesh(axes, shape)


def make_local_mesh(axes=("data", "model"), device_type: str = "cuda"):
    """A DeviceMesh over every rank of the initialised process group, shaped
    (world, 1, ...) (one rank: (1, 1))."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    return init_device_mesh(device_type, (n,) + (1,) * (len(axes) - 1),
                            mesh_dim_names=tuple(axes))
