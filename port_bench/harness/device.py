"""The card: the check that the cell's cards are there, their name and
power limit, and the peak of device memory."""
from __future__ import annotations

import subprocess
import sys

import torch


class NoCard(RuntimeError):
    """The cell asks for more cards than the machine has."""


def require(chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark "
                     "measures the port on NVIDIA cards only")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} card(s), "
                     f"torch.cuda.device_count() is "
                     f"{torch.cuda.device_count()}")


def power_limit() -> str:
    """The first card's name and power limit as ``nvidia-smi`` reads them,
    or why it could not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi failed: {err}"
    line = out.stdout.strip().splitlines()
    return line[0] if out.returncode == 0 and line else \
        f"nvidia-smi exit {out.returncode}"


def describe(chips: int, peak_bytes: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak_bytes)}


def peak_bytes(chips: int) -> int:
    """The peak of allocated memory on the fullest of the cell's cards."""
    return max(torch.cuda.max_memory_allocated(i) for i in range(chips))


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
