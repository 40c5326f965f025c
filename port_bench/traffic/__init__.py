"""Traffic: the generators and the mixes they read (``<name>.json``).

A mix is data only. ``kind`` names the generator: ``sentences`` (a
population of users holding sentences, one a row, padded to
``seq_len + 1``), ``packed`` (a population of users holding rows of
``seq_len + 1`` tokens packed with sentences and no padding) or
``rs_sweep`` (canaries and the Random-Sampling pool of the Secret Sharer).
Everything is drawn on the card from the run's seed.
"""
from __future__ import annotations

import json
from pathlib import Path

DIR = Path(__file__).resolve().parent


def load(name: str) -> dict:
    """The mix ``traffic/<name>.json``."""
    return json.loads((DIR / f"{name}.json").read_text())
