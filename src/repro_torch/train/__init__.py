"""The training engine of the port (``repro.train``): trainer,
checkpointing, fault tolerance."""
from .trainer import Trainer, TrainerConfig  # noqa: F401
from .checkpoint import CheckpointManager  # noqa: F401
from .fault_tolerance import (  # noqa: F401
    HeartbeatMonitor, RestartLoop, RestartPolicy, remesh_plan,
)
