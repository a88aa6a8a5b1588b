"""Runtime services of the port (``repro.runtime``): the fault-tolerant
training loop, the straggler monitor (which the serving engine observes
its steps with too) and elastic scaling's shard assignment."""
from .elastic import shard_assignment
from .fault_tolerance import FaultTolerantLoop, LoopMetrics, StragglerMonitor

__all__ = ["FaultTolerantLoop", "LoopMetrics", "StragglerMonitor",
           "shard_assignment"]
