"""Runtime services of the port (``repro.runtime``): the fault-tolerant
training loop, the straggler monitor (which the serving engine observes
its steps with too) and elastic scaling (``elastic_restore`` onto a new
mesh, the shard assignment)."""
from .elastic import elastic_restore, shard_assignment
from .fault_tolerance import FaultTolerantLoop, LoopMetrics, StragglerMonitor

__all__ = ["FaultTolerantLoop", "LoopMetrics", "StragglerMonitor",
           "elastic_restore", "shard_assignment"]
