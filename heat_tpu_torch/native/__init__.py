"""The host-side native parser behind :func:`heat_tpu_torch.core.io.load_csv`
(heat_tpu ``native/__init__.py``), loaded with ``ctypes``.

``fastcsv.cpp`` is the port's own copy of heat_tpu's multithreaded CSV
parser (the original Heat's byte-range parse, ``heat/core/io.py:710``, in
C++). It is host code, not a kernel: it runs on the CPU on every machine.
The shared library is built with ``g++`` at first use into
``heat_tpu_torch/_build/``, named by a hash of the source and flags, so a
changed source rebuilds. :func:`available` is False where there is no
compiler or the build fails, and ``load_csv`` then takes
``numpy.genfromtxt``, as heat_tpu does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["available", "parse_csv_chunk"]

_SRC = Path(__file__).resolve().parent / "fastcsv.cpp"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread"]
_THREADS = min(os.cpu_count() or 1, 16)

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[Path]:
    """The library for this source, built if missing; None without ``g++``
    or when the build fails. Ranks that build at once write temporary
    files and rename them, so the last rename wins with the same bytes."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    tag = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    target = _BUILD / f"libfastcsv-{tag}.so"
    if target.exists():
        return target
    _BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        subprocess.run([gxx, *_FLAGS, str(_SRC), "-o", tmp], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, target)
        return target
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.fastcsv_parse_alloc.restype = ctypes.c_int
    lib.fastcsv_parse_alloc.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_char, ctypes.c_int,
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double))]
    lib.fastcsv_free.restype = None
    lib.fastcsv_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
    _lib = lib
    return _lib


def available() -> bool:
    """True when the native parser is loaded (building it on demand)."""
    return _load() is not None


def parse_csv_chunk(path: str, start: int = 0, sep: str = ",") -> np.ndarray:
    """Parse the lines of a numeric CSV from byte ``start`` on into a float64
    ``(rows, cols)`` array (heat_tpu ``native/__init__.py:125``) on up to 16
    threads. Fields that do not parse become NaN, as in ``genfromtxt``; a
    ragged file raises ``ValueError``, one that cannot be read ``OSError``."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native CSV parser unavailable")
    rows = ctypes.c_long()
    cols = ctypes.c_long()
    data = ctypes.POINTER(ctypes.c_double)()
    rc = lib.fastcsv_parse_alloc(path.encode(), start, -1, sep.encode()[0:1], _THREADS,
                                 ctypes.byref(rows), ctypes.byref(cols), ctypes.byref(data))
    if rc == -3:
        raise ValueError(f"ragged CSV (inconsistent column counts): {path!r}")
    if rc != 0:
        raise OSError(f"fastcsv_parse_alloc failed ({rc}) for {path!r}")
    if rows.value == 0:
        return np.empty((0, max(cols.value, 0)), np.float64)
    try:
        out = np.ctypeslib.as_array(data, shape=(rows.value, cols.value)).copy()
    finally:
        lib.fastcsv_free(data)
    return out
