"""Runtime services of the port (``repro.runtime``): so far the straggler
monitor the serving engine observes its steps with."""
from .fault_tolerance import StragglerMonitor

__all__ = ["StragglerMonitor"]
