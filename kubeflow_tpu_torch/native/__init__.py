"""The port's native host libraries (counterpart of kubeflow_tpu/native):
small C++ sources with flat C interfaces, bound with ctypes.

`library(name)` compiles `<name>.cpp` of this directory on first use with
the system g++ (`-O2 -std=c++17 -shared -fPIC -pthread`) into
`kubeflow_tpu_torch/_build/<hash>/lib<name>.so`, where the hash covers the
source and the flags, so an edited source is never served by a stale
library; the build writes a temporary file and renames it into place, so
processes that build at once race benignly. A missing compiler or a failed
build raises `NativeUnavailable`. Nothing is built when the module is
imported.

These are host libraries, not kernels: the continuous-batching scheduler
(`cb_scheduler.cpp`) holds queues and slots and does no tensor work; the
token loader (`data_loader.cpp`, bound by `training/loader.py`
`NativeTokenLoader`) fills a ring of batches from a memory-mapped corpus
on a worker thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_ROOT = SRC_DIR.parent / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class NativeUnavailable(RuntimeError):
    """No compiler, no source, or a failed build of a native library."""


def _lib_path(name: str) -> Path:
    src = SRC_DIR / f"{name}.cpp"
    if not src.exists():
        raise NativeUnavailable(f"no native source {src}")
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(src.read_bytes())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / f"lib{name}.so"


def build(name: str) -> Path:
    """Compile `<name>.cpp` unless its library exists; returns the path."""
    out = _lib_path(name)
    if out.exists():
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise NativeUnavailable("no C++ compiler on PATH")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, str(SRC_DIR / f"{name}.cpp"), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeUnavailable(
            f"native build failed: {' '.join(cmd)}\n{proc.stderr[-2000:]}")
    os.replace(tmp, out)
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
        return lib
