"""Share of the traced window with nothing running on the card, train
cell(s)."""
from port_bench.harness.readers import device_idle as read  # noqa: F401
