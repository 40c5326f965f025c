"""Model FLOPs of the trained tokens over the window at the bf16 dense peak
(the whole step), zoo_train cell(s)."""
from port_bench.harness.readers import mfu as read  # noqa: F401
