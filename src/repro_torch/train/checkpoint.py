"""Reader of the reference's msgpack checkpoint format.

Format: ``{"meta": {...}, "tree": nested dict}`` with each array leaf stored
as ``{"__nd__": raw bytes, "dtype": str, "shape": list}`` and sequences as
``{"__seq__": [...], "__tuple__": bool}``. Leaves come back as numpy arrays;
`repro_torch.utils.params.from_jax_params` puts them on a device.

:func:`load` applies :func:`migrate_lstm_gates`, which splits a CIFG
checkpoint's fused ``w_gates (d+h, 3h)`` into ``w_x (d, 3h)`` and
``w_h (h, 3h)``, as the reference's loader does.

``msgpack`` is imported inside :func:`load`: hosts that only serve from
freshly initialised weights do not need it.
"""
from __future__ import annotations

import pathlib
import struct
from typing import Any, Dict, Tuple

import numpy as np


class CheckpointError(RuntimeError):
    """A checkpoint file exists but cannot be decoded (truncated, corrupt,
    or not a checkpoint). A missing file stays a ``FileNotFoundError``."""


def _is_packed(d) -> bool:
    return isinstance(d, dict) and b"__nd__" in d


def _unpack_leaf(d):
    return np.frombuffer(d[b"__nd__"],
                         dtype=np.dtype(d[b"dtype"].decode())).reshape(
        d[b"shape"]).copy()


def _decode(obj):
    if _is_packed(obj):
        return _unpack_leaf(obj)
    if isinstance(obj, dict):
        if "__seq__" in obj or b"__seq__" in obj:
            key = "__seq__" if "__seq__" in obj else b"__seq__"
            tkey = "__tuple__" if "__tuple__" in obj else b"__tuple__"
            seq = [_decode(v) for v in obj[key]]
            return tuple(seq) if obj.get(tkey) else seq
        return {(k.decode() if isinstance(k, bytes) else k): _decode(v)
                for k, v in obj.items()}
    return obj


def migrate_lstm_gates(tree):
    """Split a fused ``w_gates (d+h, 3h)`` leaf into ``w_x`` (rows [:d]) and
    ``w_h`` (rows [d:]); the dims follow from the shape (3h = n_cols).
    Dicts that already carry the split layout are left alone. Idempotent."""
    if isinstance(tree, dict):
        tree = {k: migrate_lstm_gates(v) for k, v in tree.items()}
        wg = tree.get("w_gates")
        if (wg is not None and "w_x" not in tree and "w_h" not in tree
                and getattr(wg, "ndim", 0) == 2 and wg.shape[1] % 3 == 0
                and wg.shape[0] > wg.shape[1] // 3):
            h = wg.shape[1] // 3
            del tree["w_gates"]
            tree["w_x"], tree["w_h"] = wg[:-h], wg[-h:]
        return tree
    if isinstance(tree, list):
        return [migrate_lstm_gates(v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(migrate_lstm_gates(v) for v in tree)
    return tree


def load(path) -> Tuple[Any, Dict[str, Any]]:
    """Read a checkpoint → (tree of numpy arrays, meta dict)."""
    import msgpack

    path = pathlib.Path(path)
    blob = path.read_bytes()   # missing file → plain FileNotFoundError
    try:
        obj = msgpack.unpackb(blob, raw=True, strict_map_key=False)
        meta = {k.decode() if isinstance(k, bytes) else k:
                (v.decode() if isinstance(v, bytes) else v)
                for k, v in obj[b"meta"].items()}
        return migrate_lstm_gates(_decode(obj[b"tree"])), meta
    except (ValueError, KeyError, TypeError, IndexError, AttributeError,
            struct.error, msgpack.exceptions.UnpackException,
            msgpack.exceptions.ExtraData) as e:
        raise CheckpointError(
            f"corrupt or truncated checkpoint {path}: "
            f"{type(e).__name__}: {e}") from e
