"""Runtime: fault tolerance, straggler mitigation, monitoring (the port of
``repro.runtime``)."""
from .fault import FaultTolerantLoop, SimulatedFailure
from .monitor import StepMonitor

__all__ = ["FaultTolerantLoop", "SimulatedFailure", "StepMonitor"]
