"""cifg_cell_fwd's bound over its device time a launch, memorize cell(s)."""
from functools import partial

from port_bench.harness.readers import roofline

read = partial(roofline, kernel="cifg_cell_fwd")
