"""The harness: the manifest and a cell's files, the run's environment,
the card, the measured window and its trace, and the comparison."""
