"""Token-corpus data loader (counterpart of kubeflow_tpu/training/loader.py):
the C++ prefetching core and its Python twin.

The native loader (`native/data_loader.cpp`, built by `native.library`)
memory-maps a uint32 token corpus and fills a ring of batch buffers from a
worker thread, so the host has the next batch ready while the card runs
the current step. `PyTokenLoader` makes the same xorshift64* crop sequence
in numpy, for the differential test that pins the two together and for a
caller that asks for it. Both yield the JAX package's batches byte for
byte for one corpus and seed.

Corpus format: a flat binary file of little-endian uint32 token ids
(`write_corpus` writes one).

Unlike the JAX package, `token_file_dataset(prefer_native=True)` does not
fall back to the twin when the library cannot be built: it raises
`NativeUnavailable`, as the port's engines do for their scheduler. The
twin is chosen only with `prefer_native=False`.
"""

from __future__ import annotations

import ctypes
import os
from typing import Any, Iterator

import numpy as np

_MASK = (1 << 64) - 1


def _xorshift64star(state: int) -> tuple[int, int]:
    """One step of xorshift64*; must match data_loader.cpp bit for bit."""
    s = state
    s ^= s >> 12
    s = (s ^ (s << 25)) & _MASK
    s ^= s >> 27
    return s, (s * 2685821657736338717) & _MASK


def write_corpus(path: str, tokens: np.ndarray) -> None:
    tokens = np.ascontiguousarray(tokens, dtype=np.uint32)
    with open(path, "wb") as f:
        f.write(tokens.tobytes())


class PyTokenLoader:
    """The Python twin: the native loader's batches, without prefetch."""

    def __init__(self, path: str, batch_size: int, seq_len: int,
                 seed: int = 0):
        self.batch = batch_size
        self.seq = seq_len
        self._state = seed if seed else 0x9E3779B97F4A7C15
        self.corpus = np.fromfile(path, dtype=np.uint32)
        if len(self.corpus) < seq_len + 1:
            raise ValueError("corpus smaller than one sequence")

    def __iter__(self) -> Iterator[dict[str, Any]]:
        return self

    def __next__(self) -> dict[str, Any]:
        span = len(self.corpus) - self.seq
        rows = np.empty((self.batch, self.seq), np.int32)
        for b in range(self.batch):
            self._state, r = _xorshift64star(self._state)
            start = r % span
            rows[b] = self.corpus[start:start + self.seq].astype(np.int32)
        return {"tokens": rows}

    def close(self) -> None:
        pass


class NativeTokenLoader:
    """ctypes binding over the C++ ring loader. Iterating yields
    {"tokens": int32 [batch, seq]}; the array is a copy, so the ring
    buffer is handed back at once. Raises `NativeUnavailable` when the
    library cannot be built, RuntimeError when the corpus cannot be
    opened or is shorter than one sequence."""

    def __init__(self, path: str, batch_size: int, seq_len: int,
                 seed: int = 0, n_buffers: int = 3):
        from kubeflow_tpu_torch import native

        self.batch = batch_size
        self.seq = seq_len
        self._h = None
        lib = native.library("data_loader")
        lib.dl_open.restype = ctypes.c_void_p
        lib.dl_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_uint64,
                                ctypes.c_char_p, ctypes.c_int]
        lib.dl_next.restype = ctypes.c_int
        lib.dl_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.POINTER(ctypes.c_int32))]
        lib.dl_release.restype = None
        lib.dl_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.dl_produced.restype = ctypes.c_long
        lib.dl_produced.argtypes = [ctypes.c_void_p]
        lib.dl_corpus_tokens.restype = ctypes.c_long
        lib.dl_corpus_tokens.argtypes = [ctypes.c_void_p]
        lib.dl_close.restype = None
        lib.dl_close.argtypes = [ctypes.c_void_p]
        self._lib = lib
        err = ctypes.create_string_buffer(256)
        self._h = lib.dl_open(os.fsencode(path), batch_size, seq_len,
                              n_buffers, seed, err, len(err))
        if not self._h:
            raise RuntimeError(f"data_loader: {err.value.decode()}")

    @property
    def corpus_tokens(self) -> int:
        return self._lib.dl_corpus_tokens(self._h)

    @property
    def batches_produced(self) -> int:
        return self._lib.dl_produced(self._h)

    def __iter__(self) -> Iterator[dict[str, Any]]:
        return self

    def __next__(self) -> dict[str, Any]:
        if self._h is None:
            raise StopIteration
        ptr = ctypes.POINTER(ctypes.c_int32)()
        idx = self._lib.dl_next(self._h, ctypes.byref(ptr))
        if idx < 0:
            raise StopIteration
        view = np.ctypeslib.as_array(ptr, shape=(self.batch, self.seq))
        out = np.array(view)   # copy out, then hand the buffer back
        self._lib.dl_release(self._h, idx)
        return {"tokens": out}

    def close(self) -> None:
        if self._h is not None:
            self._lib.dl_close(self._h)
            self._h = None

    def __del__(self):   # pragma: no cover - gc path
        try:
            self.close()
        except Exception:
            pass


def token_file_dataset(path: str, batch_size: int, seq_len: int,
                       seed: int = 0, prefer_native: bool = True):
    """A loader over a uint32 token corpus: the native (prefetching) one,
    which raises `NativeUnavailable` where it cannot be built, or with
    prefer_native=False the Python twin. Both yield the same batches."""
    if prefer_native:
        return NativeTokenLoader(path, batch_size, seq_len, seed)
    return PyTokenLoader(path, batch_size, seq_len, seed)
