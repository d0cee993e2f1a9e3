"""Roofline analysis from traced dry runs (the port of ``repro.roofline``)."""
from .analysis import (HW, RooflineReport, TraceCounter, TraceStats,
                       analyze_trace, collective_bytes_from_trace,
                       model_flops, trace_step)

__all__ = ["HW", "RooflineReport", "TraceCounter", "TraceStats",
           "analyze_trace", "collective_bytes_from_trace", "model_flops",
           "trace_step"]
