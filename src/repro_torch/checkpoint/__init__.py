from .manager import CheckpointManager, PreemptionGuard, StragglerMonitor
