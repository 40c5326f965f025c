"""One file a kind of cell. A driver has ``setup(cell, seed, dev)`` (the
program built from the seed, warmed up and, where the check reads them,
its first steps' readings taken), ``window(prog, seconds, trace)`` (the
measured work), ``context(prog, win)`` (what the per-layer readers read),
``release(prog)``, ``reference(cell, seed, dev, prec, fault)`` (the plain
reference's readings, run after the window), ``as_readings(ref)`` (a
reference's readings where the program's go: the control) and
``compare(cell, readings, ref)`` (the numbers judged against the cell's
limits)."""
