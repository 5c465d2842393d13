"""The port's TOL (``repro.core.tol`` is the reference): the launcher FSM,
the lease server, the cluster view, the warm-up and error-check task suites
on an explicit device, and the closed-loop ``TransomOperator``."""
from .fsm import JobState, LauncherFSM
from .server import TransomServer, Lease
from .cluster import ClusterSim, Node, NodeState, FaultInjector
from .tasks import warmup_tasks, error_check_tasks, TaskResult
from .orchestrator import TransomOperator, JobConfig, JobReport

__all__ = [
    "JobState", "LauncherFSM", "TransomServer", "Lease",
    "ClusterSim", "Node", "NodeState", "FaultInjector",
    "warmup_tasks", "error_check_tasks", "TaskResult",
    "TransomOperator", "JobConfig", "JobReport",
]
