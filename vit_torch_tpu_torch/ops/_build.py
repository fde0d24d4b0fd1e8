"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use with ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` at the root of the checkout, then loaded with
``ctypes``.  The library's file name carries a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source is
rebuilt and a stale library is never loaded.  ``ptxas -v`` reports each
kernel's registers, shared memory and spills; each build's report is kept
beside its library (``lib<name>-<hash>.log``) and read into :data:`LOGS`
whenever the library is built or found built.
Nothing here runs when the module is imported.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("flash_attention_fwd", "flash_attention_bwd",
           "window_attention_fwd", "window_attention_bwd", "window_gemm",
           "talking_heads", "attn_block", "fused_mlp", "w8a8", "auction")
LOGS: Dict[str, str] = {}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source on a machine with the CUDA toolkit")
    return path


def _library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile every missing kernel library (or one without its ptxas
    report), one ``nvcc`` per source, all started together.  Returns the
    seconds spent."""
    t0 = time.perf_counter()
    todo = []
    for name in names or KERNELS:
        lib = _library_path(name)
        log = lib.with_suffix(".log")
        if lib.exists() and log.exists():
            LOGS[name] = log.read_text(errors="replace")
        else:
            todo.append(name)
    if not todo:
        return time.perf_counter() - t0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        out = _library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, proc in procs:
        log = proc.communicate()[0].decode(errors="replace")
        LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:   # the report first: a library found built has its log
            tmp_log = tmp.with_suffix(".logtmp")
            tmp_log.write_text(log)
            os.replace(tmp_log, out.with_suffix(".log"))
            os.replace(tmp, out)   # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_library_path(name)))
            _loaded[name] = lib
        return lib
