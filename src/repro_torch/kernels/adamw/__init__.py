from .ops import adamw_, takes
from .ref import adamw_reference

__all__ = ["adamw_", "takes", "adamw_reference"]
