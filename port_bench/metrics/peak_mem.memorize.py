"""Peak of allocated device memory, GiB, memorize cell(s)."""
from port_bench.harness.readers import peak_mem as read  # noqa: F401
