"""ctypes binding to the native data packer (``native/tkg_pack.cpp``).

The library builds at first use (``g++ -O3 -shared -fPIC``) into
``.kernel_build/libtkg_pack_torch.so`` at the root of the checkout, and
again whenever the source is newer; the build writes a private file and
renames it into place, so concurrent processes never load half of one.
Where no ``g++`` is found the library is unavailable: every entry point
then returns None and its caller packs with numpy. Anything else that goes
wrong (a failed build, an unreadable file, a bucket over its pad width)
raises.

``used()`` tells whether a native entry point ran since ``reset()``;
``disabled()`` turns the library off for a block (the numpy path's
reference runs).
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
SOURCE = os.path.join(_ROOT, "native", "tkg_pack.cpp")
BUILD_DIR = os.path.join(_ROOT, ".kernel_build")
LIB_PATH = os.path.join(BUILD_DIR, "libtkg_pack_torch.so")
INT_PAD = np.iinfo(np.int32).max

_lib = None
_lock = threading.Lock()
_state = {"calls": 0, "disabled": False}


def build() -> None:
    """Compile the library if it is missing or older than its source."""
    if (os.path.exists(LIB_PATH)
            and os.path.getmtime(LIB_PATH) >= os.path.getmtime(SOURCE)):
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        proc = subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", SOURCE, "-o", tmp],
            capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed (exit {proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    """The loaded library, or None where it is unavailable (no ``g++``, or
    turned off by ``disabled()``)."""
    global _lib
    if _state["disabled"]:
        return None
    with _lock:
        if _lib is None:
            if shutil.which("g++") is None:
                return None
            build()
            lib = ctypes.CDLL(LIB_PATH)
            lib.tkg_count_quads.restype = ctypes.c_long
            lib.tkg_count_quads.argtypes = [ctypes.c_char_p]
            lib.tkg_parse_quads.restype = ctypes.c_long
            lib.tkg_parse_quads.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_long]
            i64, i32 = (ctypes.POINTER(ctypes.c_int64),
                        ctypes.POINTER(ctypes.c_int32))
            lng = ctypes.c_long
            lib.tkg_pack_snapshots.restype = ctypes.c_int
            lib.tkg_pack_snapshots.argtypes = [
                i64, lng, i32, lng, lng, lng, i32, i32, i32,
                ctypes.POINTER(ctypes.c_uint8), i32]
            lib.tkg_filter_pairs.restype = ctypes.c_long
            lib.tkg_filter_pairs.argtypes = [
                i64, lng, i32, lng, lng, lng, ctypes.c_int, ctypes.c_int64,
                i32, i32]
            _lib = lib
    return _lib


@contextlib.contextmanager
def disabled():
    """The library off inside the block: callers take the numpy path."""
    before = _state["disabled"]
    _state["disabled"] = True
    try:
        yield
    finally:
        _state["disabled"] = before


def used() -> bool:
    """Whether a native entry point ran since the last ``reset()``."""
    return _state["calls"] > 0


def reset() -> None:
    _state["calls"] = 0


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _inputs(quads, time_pos, T: int):
    """Contiguous int64 [M, 4] quads and int32 time positions, checked:
    every quad's time value maps to a position in [0, T)."""
    quads = np.ascontiguousarray(quads, np.int64)
    time_pos = np.ascontiguousarray(time_pos, np.int32)
    if quads.ndim != 2 or quads.shape[1] != 4:
        raise ValueError(f"quads of shape {quads.shape}: [M, 4] expected")
    tv = quads[:, 3]
    if len(tv) and not (tv.min() >= 0 and tv.max() < len(time_pos)
                        and 0 <= time_pos[tv].min()
                        and time_pos[tv].max() < T):
        raise ValueError("a time value has no position in [0, T)")
    return quads, time_pos


def parse_quads(path: str) -> Optional[np.ndarray]:
    """The first four integer columns of each line of a quadruple text
    file -> int64 [rows, 4]; None where the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = lib.tkg_count_quads(path.encode())
    if n < 0:
        raise OSError(f"cannot read {path}")
    out = np.empty((n, 4), np.int64)
    got = lib.tkg_parse_quads(path.encode(), _ptr(out, ctypes.c_int64), n)
    if got < 0:
        raise OSError(f"cannot read {path}")
    _state["calls"] += 1
    return out[:got]


def pack_snapshots(quads: np.ndarray, time_pos: np.ndarray, T: int,
                   e_pad: int) -> Optional[Tuple[np.ndarray, ...]]:
    """Bucket quads into padded per-time arrays (src, rel, dst, emask,
    n_edges), each time's edges in file order; `time_pos` maps a raw time
    value to its position. None where the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    quads, time_pos = _inputs(quads, time_pos, T)
    src = np.empty((T, e_pad), np.int32)
    rel = np.empty((T, e_pad), np.int32)
    dst = np.empty((T, e_pad), np.int32)
    emask = np.empty((T, e_pad), np.uint8)
    n_edges = np.empty((T,), np.int32)
    rc = lib.tkg_pack_snapshots(
        _ptr(quads, ctypes.c_int64), len(quads),
        _ptr(time_pos, ctypes.c_int32), len(time_pos), T, e_pad,
        _ptr(src, ctypes.c_int32), _ptr(rel, ctypes.c_int32),
        _ptr(dst, ctypes.c_int32), _ptr(emask, ctypes.c_uint8),
        _ptr(n_edges, ctypes.c_int32))
    if rc != 0:
        raise ValueError(f"a time position holds more edges than the pad "
                         f"width {e_pad}")
    _state["calls"] += 1
    return src, rel, dst, emask.astype(bool), n_edges


def filter_pairs(quads: np.ndarray, time_pos: np.ndarray, T: int, f_pad: int,
                 mode: str, r2: int
                 ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Per-time sorted, deduplicated (group, value) pairs, padded with
    INT32_MAX to [T, f_pad]: tail mode groups h * r2 + r with value t, head
    mode t * r2 + r with value h. None where the library is
    unavailable."""
    if mode not in ("tail", "head"):
        raise ValueError(f"mode {mode!r}: 'tail' or 'head'")
    lib = get_lib()
    if lib is None:
        return None
    quads, time_pos = _inputs(quads, time_pos, T)
    grp = np.full((T, f_pad), INT_PAD, np.int32)
    val = np.full((T, f_pad), INT_PAD, np.int32)
    rc = lib.tkg_filter_pairs(
        _ptr(quads, ctypes.c_int64), len(quads),
        _ptr(time_pos, ctypes.c_int32), len(time_pos), T, f_pad,
        0 if mode == "tail" else 1, r2,
        _ptr(grp, ctypes.c_int32), _ptr(val, ctypes.c_int32))
    if rc < 0:
        raise ValueError(f"a time position holds more pairs than the pad "
                         f"width {f_pad}")
    _state["calls"] += 1
    return grp, val
