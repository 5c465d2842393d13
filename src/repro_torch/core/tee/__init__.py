from .detectors import LOF, NeighborProfile, DTWKNNCluster, LogDetector
from .service import TEEService, TEEVerdict
from .trainer import OfflineTrainer, ModelRegistry
from .traces import TaskTrace, TraceGenerator, FAULT_CATEGORIES

__all__ = [
    "LOF", "NeighborProfile", "DTWKNNCluster", "LogDetector",
    "TEEService", "TEEVerdict", "OfflineTrainer", "ModelRegistry",
    "TaskTrace", "TraceGenerator", "FAULT_CATEGORIES",
]
