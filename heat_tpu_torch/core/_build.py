"""Builds the port's CUDA kernels at first use.

``nvcc`` compiles every ``heat_tpu_torch/csrc/*.cu`` (all started together)
for ``sm_90a`` and links them into one shared library with a plain C
interface, loaded with ``ctypes``. The library lands in
``heat_tpu_torch/_build/``, named by a hash of the sources and flags, so a
changed source rebuilds and an unchanged one loads at once. A missing
``nvcc`` raises: no kernel is replaced by anything else. Once loaded, the
library runs the probe kernel (``csrc/probe.cu``) on the current card, so a
build that cannot launch there fails at first use with the CUDA error.
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
from typing import Optional

__all__ = ["library", "build_info"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.RLock()  # the first load only; the load-time probe re-enters library()
_lib: Optional[ctypes.CDLL] = None  # the loaded, probed library, read without the lock
_loading: Optional[ctypes.CDLL] = None  # the library while its load-time probe runs
_info: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: heat_tpu_torch builds its CUDA kernels from "
            f"{_CSRC} at first use and needs the CUDA toolkit on PATH")
    return path


def _compile(so: Path, sources) -> str:
    nvcc = _nvcc()
    tmp = _BUILD / f"tmp-{os.getpid()}-{threading.get_ident()}"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        procs = []
        for src in sources:
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = []
        failed = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        part = tmp / so.name
        link = subprocess.run(
            [nvcc, *_FLAGS[:2], "-shared", "-o", str(part), *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(part, so)
        (so.with_suffix(".log")).write_text("\n".join(log))
        return "\n".join(log)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _declare(lib: ctypes.CDLL) -> None:
    # every launching entry point ends in (int device, void* stream)
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    out = ctypes.POINTER(i)
    lib.heat_cdist_tile.argtypes = [p, p, p, i64, i64, i64, i, i, i, i, i, i, p]
    lib.heat_cdist_tile_plan.argtypes = [i64, i64, i64, i, i, out, out, i]
    lib.heat_kmeans_step.argtypes = [p, p, p, p, p, p, i64, i, i, i, i, i, i, i, p]
    lib.heat_kmeans_step_plan.argtypes = [i64, i, i, i, out, out, out, i]
    lib.heat_flash_attention.argtypes = [p, p, p, p, p, p, i64, i, i, i, i, f, i, i, p]
    lib.heat_flash_bwd_dkv.argtypes = [p, p, p, p, p, p, p, p, p, i, i64, i, i, i, i, f, i, i,
                                       p]
    lib.heat_flash_bwd_dq.argtypes = [p, p, p, p, p, p, p, p, i, i64, i, i, i, i, f, i, i, p]
    lib.heat_probe.argtypes = [p, p, i64, i, p]
    for fn in (lib.heat_cdist_tile, lib.heat_cdist_tile_plan, lib.heat_kmeans_step,
               lib.heat_kmeans_step_plan,
               lib.heat_flash_attention, lib.heat_flash_bwd_dkv, lib.heat_flash_bwd_dq,
               lib.heat_probe):
        fn.restype = i
    lib.heat_cuda_error_string.argtypes = [i]
    lib.heat_cuda_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The kernels' shared library, built from ``csrc/`` on first call. Once
    it is loaded and its probe has passed, a call reads the module global and
    takes no lock."""
    global _lib, _loading
    lib = _lib
    if lib is not None:
        return lib
    with _lock:
        if _lib is not None:
            return _lib
        if _loading is not None:  # the load-time probe's own launch
            return _loading
        start = time.perf_counter()
        sources = sorted(_CSRC.glob("*.cu"))
        h = hashlib.sha256(" ".join(_FLAGS).encode())
        for f in sources + sorted(_CSRC.glob("*.cuh")):
            h.update(f.name.encode())
            h.update(f.read_bytes())
        _BUILD.mkdir(parents=True, exist_ok=True)
        so = _BUILD / f"libheat_tpu_torch_{h.hexdigest()[:16]}.so"
        built = not so.exists()
        log_file = so.with_suffix(".log")
        log = _compile(so, sources) if built else (
            log_file.read_text() if log_file.exists() else "")
        lib = ctypes.CDLL(str(so))
        _declare(lib)
        _loading = lib
        try:
            _probe_card()
        finally:
            _loading = None
        _lib = lib
        _info.update(path=str(so), built=built, seconds=time.perf_counter() - start,
                     log=log)
        return lib


def _probe_card() -> None:
    """One launch of the probe kernel on the current card, held bitwise
    against its plain version."""
    import torch

    from . import kernels

    x = torch.zeros((8, 128), dtype=torch.float32,
                    device=torch.device("cuda", torch.cuda.current_device()))
    out = kernels.probe(x)
    torch.cuda.synchronize(x.device)
    if not torch.equal(out, kernels.probe_plain(x)):
        raise RuntimeError("the probe kernel ran on the card but returned wrong values")


def build_info() -> dict:
    """Path, build seconds and compiler log of the loaded library."""
    return dict(_info)
