from .ops import chunk_scan, chunk_state, ssd_scan, state_pass, variant
from .ref import ssd_reference

__all__ = ["ssd_scan", "ssd_reference", "chunk_state", "state_pass", "chunk_scan", "variant"]
