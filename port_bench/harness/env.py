"""The run's environment: where the port is imported from, where its
build and kernel caches live, sub-seeds, and the check that no JAX
package was loaded."""
from __future__ import annotations

import hashlib
import os
import sys
from typing import List

from port_bench.harness.manifest import ROOT

# whole top-level module names that the benchmark's process must not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def prepare() -> None:
    """Import the port from ``src/`` of this checkout; keep every cache a
    library could write (Triton's, PyTorch's extensions', CUDA's JIT) at
    fixed paths under ``build/`` of the checkout (the port builds its
    kernels into ``build/kernels`` itself); keep ``transformers`` from
    loading JAX."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_ext")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name is a JAX package's or the
    JAX reproduction's, compared whole (``repro_torch`` is not
    ``repro``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def subseed(seed: int, label: str) -> int:
    """A 63-bit seed of ``label`` under the run's ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{label}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)
