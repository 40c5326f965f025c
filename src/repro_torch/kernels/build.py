"""Build and load the port's hand-written CUDA kernels.

Each library is one ``.cu`` source with plain C entry points. It is compiled
with ``nvcc`` for ``sm_90a`` into a shared library under ``build/kernels/``
at the repository root (a directory ``.gitignore`` lists) the first time it
is needed, and loaded with ``ctypes``. The library's file name carries a
hash of the source and the flags, so an edited source is rebuilt and a
stale library is never loaded. Nothing here runs at import time.

    from repro_torch.kernels import build
    build.build()                 # every library, one nvcc per source, in parallel
    lib = build.load("dp_clip")   # lib.dp_sumsq, lib.dp_clip_accumulate
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS_DIR.parents[2] / "build" / "kernels"

# library name → its source, relative to this directory (a library exports
# the C entry points its source defines)
SOURCES = {
    "cifg_cell_fwd": "cifg_cell/csrc/cifg_cell_fwd.cu",
    "cifg_cell_bwd": "cifg_cell/csrc/cifg_cell_bwd.cu",
    "dp_clip": "dp_clip/csrc/dp_clip.cu",
    "flash_attention_fwd": "flash_attention/csrc/flash_attention_fwd.cu",
    "ssd_scan": "ssd_scan/csrc/ssd_scan.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

DEFAULT_CUDA_HOME = "/usr/local/cuda"

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or
    ``PATH``. Raises when there is none."""
    for home in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels are built from source on a host "
            "with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    src = _KERNELS_DIR / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    process per source, all started together. Returns, per name,
    ``{"path", "seconds", "log"}`` (``seconds`` 0 and ``log`` empty for a
    library that was already built); ``log`` holds ``-Xptxas -v``'s
    register and shared-memory report. Raises on a failed compile."""
    names = list(SOURCES if names is None else names)
    for name in names:
        if name not in SOURCES:
            raise KeyError(f"unknown kernel {name!r}; known: {sorted(SOURCES)}")
    out: Dict[str, dict] = {}
    running = {}
    for name in names:
        path = library_path(name)
        if path.is_file():
            out[name] = {"path": str(path), "seconds": 0.0, "log": ""}
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(_KERNELS_DIR / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, path, time.perf_counter())
    failed = []
    for name, (proc, tmp, path, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = {"path": str(path), "seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed; loaded once per
    process."""
    with _LOCK:
        if name not in _LOADED:
            build([name])
            _LOADED[name] = ctypes.CDLL(str(library_path(name)))
        return _LOADED[name]
