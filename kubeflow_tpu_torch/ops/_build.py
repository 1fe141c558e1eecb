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

import contextlib
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
#: the same launches by the tag of the thread that made them
#: (`set_thread_tag`), {tag: {kernel: n}}: the roles of a disaggregated
#: engine run on two threads and are counted apart
TAGGED: dict[str, dict[str, int]] = {}

# The counters are shared by every thread; what a thread is doing is its
# own: its tag, and whether its launches are being recorded for a CUDA
# graph (`recording`).
_count_lock = threading.Lock()
_tls = threading.local()


def set_thread_tag(tag: str | None) -> None:
    """Count this thread's launches under `tag` in TAGGED as well."""
    _tls.tag = tag


def _merge(into: tuple[dict, dict], launches: dict[str, int],
           shapes: dict[str, dict[tuple, int]]) -> None:
    total, by_shape = into
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n
    for name, counts in shapes.items():
        dst = by_shape.setdefault(name, {})
        for key, n in counts.items():
            dst[key] = dst.get(key, 0) + n


def _add(launches: dict[str, int], shapes: dict[str, dict[tuple, int]]
         ) -> None:
    tag = getattr(_tls, "tag", None)
    with _count_lock:
        _merge((LAUNCHES, SHAPES), launches, shapes)
        if tag is not None:
            _merge((TAGGED.setdefault(tag, {}), {}), launches, {})


def count_launch(name: str, **shape) -> None:
    delta = ({name: 1}, {name: {tuple(shape.items()): 1}})
    rec = getattr(_tls, "rec", None)
    if rec is None:
        _add(*delta)
    else:
        _merge(rec, *delta)


def reset_launches() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
            SHAPES[name].clear()
        TAGGED.clear()


# A CUDA graph runs its kernels at every replay, but the wrappers count
# only while it is captured: the engine runs the capture inside
# `recording()`, which keeps this thread's launches out of the counters,
# and adds what it recorded once per replay (`add_counts`). Other threads
# count on undisturbed meanwhile.


@contextlib.contextmanager
def recording():
    """Yields (launches, shapes), which collect this thread's launches
    inside the block instead of the counters."""
    prev = getattr(_tls, "rec", None)
    _tls.rec = ({}, {})
    try:
        yield _tls.rec
    finally:
        _tls.rec = prev


def add_counts(delta: tuple[dict, dict]) -> None:
    _add(*delta)


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


def set_build_root(path: str | os.PathLike) -> Path:
    """Keep the libraries under `path` from now on, under the same source
    hash (a predictor's `compile_cache`): the libraries built so far for
    the current sources are copied there, and later builds are written
    there, so a restarted process that points at the same directory finds
    every library and runs no nvcc. Libraries already loaded stay
    loaded."""
    global BUILD_ROOT
    new = Path(path)
    with _lock:
        src, dst = BUILD_ROOT / _source_hash(), new / _source_hash()
        if src != dst and src.is_dir():
            for lib in src.glob("lib*.so"):
                if not (dst / lib.name).exists():
                    dst.mkdir(parents=True, exist_ok=True)
                    tmp = dst / f"{lib.name}.{os.getpid()}.tmp"
                    shutil.copyfile(lib, tmp)
                    os.replace(tmp, dst / lib.name)
        BUILD_ROOT = new
    return new


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
