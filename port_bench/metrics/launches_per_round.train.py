"""CUDA kernels a round of the train cell(s), from the trace (the engine
layer)."""
from port_bench.harness.readers import launches_per_round as read  # noqa: F401
