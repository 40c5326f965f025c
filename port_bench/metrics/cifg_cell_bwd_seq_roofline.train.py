"""cifg_cell_bwd_seq's bound over its device time a launch, train cell(s)."""
from functools import partial

from port_bench.harness.readers import roofline

read = partial(roofline, kernel="cifg_cell_bwd_seq")
