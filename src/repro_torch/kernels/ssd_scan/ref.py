"""Plain PyTorch oracle for the SSD scan kernel: the model's chunked scan.

Counterpart of ``repro.kernels.ssd_scan.ref``. It is what ``ops.ssd_scan``
runs for tensors on the CPU, and what the CUDA kernel is held against on the
card.
"""
from repro_torch.models.ssm import ssd_chunked as ssd_reference  # noqa: F401
