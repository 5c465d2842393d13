from .ops import ssd_scan
from .ref import ssd_reference

__all__ = ["ssd_scan", "ssd_reference"]
