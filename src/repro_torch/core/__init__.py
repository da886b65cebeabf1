"""The paper's contribution: unprivileged container late-binding for dHTC
pilots, adapted to a PyTorch/CUDA fleet (port of ``repro.core``).

Map (paper -> here): pod -> PilotSlice; pilot container -> Pilot; payload
container -> PayloadExecutor; container image -> PayloadImage (model bundle
and its CUDA kernel libraries); pod patch -> PayloadExecutor.patch_image
(pod-scoped capability); shared volume -> SharedArena; process namespace +
uid -> ProcessTable; startup wrapper -> run_wrapper; task repository ->
TaskRepo; Kubernetes -> ClusterSim.
"""

from repro_torch.core.arena import SharedArena
from repro_torch.core.cluster import ClusterSim, Fleet, PilotSlice
from repro_torch.core.images import (
    Executable, ExecutableRegistry, PLACEHOLDER, PayloadImage,
)
from repro_torch.core.latebind import (
    PayloadExecutor, PermissionError_, PodPatchCapability,
)
from repro_torch.core.monitor import Monitor, MonitorAction, MonitorLimits
from repro_torch.core.pilot import (
    InvalidTransition, Pilot, PilotConfig, TERMINAL_STATES, TRANSITIONS,
)
from repro_torch.core.proctable import PAYLOAD_UID, PILOT_UID, ProcessTable
from repro_torch.core.taskrepo import PayloadTask, TaskRepo, TaskResult
from repro_torch.core.timerwheel import TimerWheel, shared_wheel
from repro_torch.core.wrapper import PayloadCapability, run_wrapper

__all__ = [
    "SharedArena", "ClusterSim", "Fleet", "PilotSlice", "Executable",
    "ExecutableRegistry", "PLACEHOLDER", "PayloadImage", "PayloadExecutor",
    "PermissionError_", "PodPatchCapability", "Monitor", "MonitorAction",
    "MonitorLimits", "InvalidTransition", "Pilot", "PilotConfig",
    "TERMINAL_STATES", "TRANSITIONS", "PAYLOAD_UID", "PILOT_UID",
    "ProcessTable", "PayloadTask", "TaskRepo", "TaskResult", "TimerWheel",
    "shared_wheel", "PayloadCapability", "run_wrapper",
]
