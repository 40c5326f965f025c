"""Device ms (the union of kernels and copies) a Random-Sampling chunk of
1,024 continuations behind each of 27 canaries."""
from port_bench.harness.readers import device_ms_per_chunk as read  # noqa: F401
