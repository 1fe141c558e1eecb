"""Build and load the port's CUDA kernels, and count their launches.

Each `csrc/<name>.cu` is compiled on first use by `nvcc` into a shared
library with a plain C interface (`-gencode arch=compute_90a,code=sm_90a`,
Hopper) and loaded with `ctypes`. Libraries live under
`kubeflow_tpu_torch/_build/<hash>/`, where the hash covers every source
and header in `csrc/` plus the compiler flags, so an edited source is never
served by a stale library. `build_all()` compiles every kernel at once, one
`nvcc` process per source.

Nothing here runs when the module is imported: the CPU tests import every
module of the port on a machine without `nvcc`.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: the sources, one library each
SOURCES = ("quant_matmul", "flash_decode", "flash_prefill", "flash_attn_fwd",
           "flash_attn_dq", "flash_attn_dkv")
#: the kernels, each with its own wrapper and launch counter: one per
#: source, and the paged modes of K2 and K3 (their own entry points in
#: flash_decode.cu and flash_prefill.cu)
KERNELS = SOURCES + ("flash_decode_paged", "flash_prefill_paged")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}

#: launches of each kernel wrapper since the last reset: one per call that
#: runs a kernel on the card (the plain CPU version is not counted)
LAUNCHES = {name: 0 for name in KERNELS}
#: the same launches by argument shape, {kernel: {((arg, value), ...): n}},
#: so a run's kernels can be checked again at exactly the shapes it used
SHAPES: dict[str, dict[tuple, int]] = {name: {} for name in KERNELS}


def count_launch(name: str, **shape) -> None:
    LAUNCHES[name] += 1
    key = tuple(shape.items())
    SHAPES[name][key] = SHAPES[name].get(key, 0) + 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        SHAPES[name].clear()


# A CUDA graph runs its kernels at every replay, but the wrappers count
# only while it is captured: the engine takes the counts a capture added
# (counts_since), puts the counters back (restore_counts) and adds the
# capture's counts once per replay (add_counts).


def snapshot_counts() -> tuple[dict, dict]:
    return dict(LAUNCHES), {k: dict(v) for k, v in SHAPES.items()}


def restore_counts(snap: tuple[dict, dict]) -> None:
    launches, shapes = snap
    LAUNCHES.update(launches)
    for name, by_shape in SHAPES.items():
        by_shape.clear()
        by_shape.update(shapes[name])


def counts_since(snap: tuple[dict, dict]) -> tuple[dict, dict]:
    launches, shapes = snap
    d_launches = {k: n - launches[k] for k, n in LAUNCHES.items()
                  if n != launches[k]}
    d_shapes = {name: {key: n - shapes[name].get(key, 0)
                       for key, n in by_shape.items()
                       if n != shapes[name].get(key, 0)}
                for name, by_shape in SHAPES.items()}
    return d_launches, d_shapes


def add_counts(delta: tuple[dict, dict]) -> None:
    d_launches, d_shapes = delta
    for name, n in d_launches.items():
        LAUNCHES[name] += n
    for name, by_shape in d_shapes.items():
        for key, n in by_shape.items():
            SHAPES[name][key] = SHAPES[name].get(key, 0) + n


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_ROOT / _source_hash() / f"lib{name}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    out = _lib_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> dict[str, tuple[float, str]]:
    """Compile every kernel that has no library for the current sources,
    all `nvcc` processes at once. Returns, for each fresh build, its
    seconds from the common start and its compiler log (registers, shared
    memory and spills per kernel, from -Xptxas -v)."""
    with _lock:
        t0 = time.monotonic()
        started = {name: _start(name) for name in SOURCES
                   if not _lib_path(name).exists()}
        done: dict = {}

        def collect(name, job):
            try:
                log = _finish(name, *job)
                done[name] = (time.monotonic() - t0, log)
            except BaseException as e:   # raised below, in the caller
                done[name] = e

        threads = [threading.Thread(target=collect, args=item)
                   for item in started.items()]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        for res in done.values():
            if isinstance(res, BaseException):
                raise res
        return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        path = _lib_path(name)
        if not path.exists():
            _finish(name, *_start(name))
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
