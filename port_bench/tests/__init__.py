"""CPU tests of the benchmark: the manifest, the import rule, the
references against the port's plain CPU path, the kernels' counts, the
run's refusals and the check's faults."""
