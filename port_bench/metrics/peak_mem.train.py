"""Peak of allocated device memory, GiB, train cell(s)."""
from port_bench.harness.readers import peak_mem as read  # noqa: F401
