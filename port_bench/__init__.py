"""The benchmark of the PyTorch/CUDA port (`repro_torch`).

``python port_bench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line. Everything a cell needs is found by name:

* ``configs/<config>.json`` — a model configuration as it is run;
* ``traffic/<traffic>.json`` — a traffic mix, read by the generators of
  ``traffic/``;
* ``workloads/<cell>.json`` — a cell: its driver (``drivers/<driver>.py``),
  its training or scoring settings and the limits of its comparison;
* ``metrics/<metric>.py`` — one per-layer metric's reader;
* ``kernels/<kernel>.py`` — one kernel's operations and bytes.

``reference/`` is the plain PyTorch yardstick that decides ``correct``; it
imports nothing of the port.
"""
