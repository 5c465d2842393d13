"""Plain PyTorch oracles for the SSD scan kernels: the model's chunked scan
and its three passes.

Counterpart of ``repro.kernels.ssd_scan.ref``. They are what ``ops`` runs for
tensors on the CPU, and what the CUDA kernels are held against on the card:
the whole scan against :func:`ssd_reference`, each ``sm90`` and ``tf32x3``
pass against its own pass.
"""
from repro_torch.models.ssm import chunk_scan as chunk_scan_reference  # noqa: F401
from repro_torch.models.ssm import chunk_state as chunk_state_reference  # noqa: F401
from repro_torch.models.ssm import ssd_chunked as ssd_reference  # noqa: F401
from repro_torch.models.ssm import state_pass as state_pass_reference  # noqa: F401
