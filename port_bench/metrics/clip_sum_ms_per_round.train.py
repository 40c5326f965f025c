"""Device ms a round of dp_sumsq and dp_clip_accumulate in the train
cell(s) (the clip and sum)."""
from port_bench.harness.readers import clip_sum_ms_per_round as read  # noqa: F401
