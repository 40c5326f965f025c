"""Reader and writer of the reference's msgpack checkpoint format.

Format: ``{"meta": {...}, "tree": nested dict}`` with each array leaf stored
as ``{"__nd__": raw bytes, "dtype": str, "shape": list}`` and sequences as
``{"__seq__": [...], "__tuple__": bool}``. Leaves come back as numpy arrays;
`repro_torch.utils.params.from_jax_params` puts them on a device.

:func:`load` applies :func:`migrate_lstm_gates`, which splits a CIFG
checkpoint's fused ``w_gates (d+h, 3h)`` into ``w_x (d, 3h)`` and
``w_h (h, 3h)``, as the reference's loader does.

``msgpack`` is imported inside :func:`load`: hosts that only serve from
freshly initialised weights do not need it. :func:`save` needs no package:
it encodes the subset of msgpack the format uses by hand, byte for byte as
the reference's ``msgpack.packb(..., use_bin_type=True)`` does, and writes
atomically (temp file, fsync, rename).
"""
from __future__ import annotations

import os
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


def _pack(obj, out: bytearray) -> None:
    """Append the msgpack encoding of ``obj`` (None, bool, int, float, str,
    bytes, list/tuple, dict) in the smallest form, as msgpack's packer with
    ``use_bin_type=True`` chooses it."""
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), out, fix=(0xA0, 32), codes=(0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(len(obj), out, fix=None, codes=(0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, fix=(0x90, 16), codes=(None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, fix=(0x80, 16), codes=(None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot encode {type(obj).__name__} in a checkpoint")


def _pack_int(x: int, out: bytearray) -> None:
    if 0 <= x < 0x80 or -0x20 <= x < 0:
        out += struct.pack(">b" if x < 0 else ">B", x)
    elif 0 < x:
        for code, fmt, hi in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                              (0xCE, ">I", 0xFFFFFFFF),
                              (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if x <= hi:
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"integer {x} too large for msgpack")
    else:
        for code, fmt, lo in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                              (0xD2, ">i", -0x80000000),
                              (0xD3, ">q", -0x8000000000000000)):
            if x >= lo:
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"integer {x} too small for msgpack")


def _pack_len(n: int, out: bytearray, fix, codes) -> None:
    """Header of a str, bin, array or map of length ``n``: the fix form
    (``fix = (base, limit)``) below its limit, else 8-, 16- or 32-bit
    lengths (``codes``; ``None`` where the type has no such form)."""
    if fix is not None and n < fix[1]:
        out.append(fix[0] | n)
        return
    for code, fmt, hi in zip(codes, (">B", ">H", ">I"),
                             (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= hi:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"length {n} too large for msgpack")


def _encode(tree):
    """The reference's tree encoding: dicts with sorted keys (as
    ``jax.tree_util.tree_map`` rebuilds them), sequences as ``__seq__``
    records, array leaves as raw bytes with dtype and shape."""
    if isinstance(tree, dict):
        return {k: _encode(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return {"__seq__": [_encode(v) for v in tree],
                "__tuple__": isinstance(tree, tuple)}
    a = np.asarray(tree.detach().cpu().numpy() if hasattr(tree, "detach")
                   else tree)
    return {b"__nd__": a.tobytes(), b"dtype": str(a.dtype).encode(),
            b"shape": list(a.shape)}


def save(path, params, meta: Dict[str, Any] = None) -> None:
    """Write ``params`` (a tree of tensors or arrays; compute copies are
    dropped) and ``meta`` atomically: a same-directory temp file, fsync,
    then ``os.replace`` onto ``path``. The bytes are those the reference's
    ``save`` writes for the same tree and meta."""
    from repro_torch.utils.params import COMPUTE

    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if isinstance(params, dict):
        params = {k: v for k, v in params.items() if k != COMPUTE}
    blob = bytearray()
    _pack({"meta": meta or {}, "tree": _encode(params)}, blob)
    tmp = path.with_name(f".{path.name}.tmp.{os.getpid()}")
    try:
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise


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
