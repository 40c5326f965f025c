"""Model FLOPs scoring needs over the window at the bf16 dense peak (the
whole step), memorize cell(s)."""
from port_bench.harness.readers import mfu as read  # noqa: F401
