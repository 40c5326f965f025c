"""ssd_scan's bound over the device time of a call's three CUDA kernels,
zoo_train cell(s)."""
from functools import partial

from port_bench.harness.readers import roofline

read = partial(roofline, kernel="ssd_scan")
