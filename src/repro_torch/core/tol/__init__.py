"""The port's TOL control plane (``repro.core.tol`` is the reference): the
launcher FSM, the lease server, the cluster view and the warm-up and
error-check task suites. The closed-loop ``TransomOperator`` comes with the
TCE engine and the TEE."""
from .fsm import JobState, LauncherFSM
from .server import TransomServer, Lease
from .cluster import ClusterSim, Node, NodeState, FaultInjector
from .tasks import warmup_tasks, error_check_tasks, TaskResult

__all__ = [
    "JobState", "LauncherFSM", "TransomServer", "Lease",
    "ClusterSim", "Node", "NodeState", "FaultInjector",
    "warmup_tasks", "error_check_tasks", "TaskResult",
]
