"""A reader and a writer for the safetensors format, the port's own: the
card's machine has no `safetensors` package. An HF checkpoint directory
(`models/llama.py` `load_hf`) stores its weights this way, and the
port's trainer checkpoints (`training/checkpoint.py`) are written so.

A file is an 8-byte little-endian header length N, then N bytes of JSON
header, then the raw tensor bytes. The header maps each tensor name to
{"dtype", "shape", "data_offsets": [begin, end]} (offsets into the byte
section) and may carry a "__metadata__" dict of strings.

The byte section is memory-mapped copy-on-write, and `get_tensor`
returns a CPU tensor over the mapped pages (`torch.frombuffer`): nothing
is read until the caller touches it, and a caller that moves it to the
card reads each byte once, with no f32 (or any) copy of the model on the
host.

`save_file` writes a dict of tensors as one file: the header padded with
spaces to a multiple of 8 bytes, then each tensor's bytes, the widest
item sizes first so that every tensor starts aligned to its item size
(the reader then maps each one without a copy).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any

import numpy as np
import torch

#: the header's dtype names this reader takes, as torch dtypes
DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
          "F32": torch.float32, "I8": torch.int8, "I32": torch.int32,
          "I64": torch.int64}

#: torch dtypes -> the header's names (the writer's side of DTYPES)
DTYPE_NAMES = {v: k for k, v in DTYPES.items()}

#: a header larger than this is not a safetensors header (the format's
#: own reader refuses past 100 MB)
MAX_HEADER_BYTES = 100 << 20


class SafetensorsError(ValueError):
    """A file that is not a well-formed safetensors file."""


class SafeFile:
    """One safetensors file: its header read at open, its bytes mapped.

        with SafeFile(path) as f:
            for name in f.keys():
                t = f.get_tensor(name)      # CPU tensor over the mapping
    """

    def __init__(self, path: str):
        self.path = path
        size = os.path.getsize(path)
        with open(path, "rb") as fh:
            head = fh.read(8)
            if len(head) != 8:
                raise SafetensorsError(f"{path}: shorter than its header "
                                       "length")
            (n,) = struct.unpack("<Q", head)
            if n > MAX_HEADER_BYTES or 8 + n > size:
                raise SafetensorsError(f"{path}: header length {n} past "
                                       "the file or the format's limit")
            try:
                header = json.loads(fh.read(n))
            except ValueError as e:
                raise SafetensorsError(f"{path}: bad header: {e}") from e
        if not isinstance(header, dict):
            raise SafetensorsError(f"{path}: header is not an object")
        self._metadata = header.pop("__metadata__", None)
        data_len = size - 8 - n
        self._entries: dict[str, tuple[torch.dtype, tuple, int, int]] = {}
        for name, ent in header.items():
            try:
                dt, shape = ent["dtype"], tuple(int(d) for d in ent["shape"])
                begin, end = (int(o) for o in ent["data_offsets"])
            except (KeyError, TypeError, ValueError) as e:
                raise SafetensorsError(
                    f"{path}: bad header entry {name!r}") from e
            if dt not in DTYPES:
                raise SafetensorsError(
                    f"{path}: tensor {name!r} has dtype {dt}; this reader "
                    f"takes {sorted(DTYPES)}")
            nbytes = (int(np.prod(shape, dtype=np.int64))
                      * DTYPES[dt].itemsize)
            if not 0 <= begin <= end <= data_len or end - begin != nbytes:
                raise SafetensorsError(
                    f"{path}: tensor {name!r} offsets {begin}..{end} do not "
                    f"hold {shape} {dt} inside {data_len} bytes")
            self._entries[name] = (DTYPES[dt], shape, begin, end)
        # copy-on-write: torch.frombuffer wants a writable buffer, and a
        # private mapping gives one without copying a page until written
        self._data = (np.memmap(path, dtype=np.uint8, mode="c",
                                offset=8 + n, shape=(data_len,))
                      if data_len else np.zeros(0, np.uint8))

    def keys(self) -> list[str]:
        return list(self._entries)

    def metadata(self) -> dict[str, str] | None:
        return self._metadata

    def shape(self, name: str) -> tuple[int, ...]:
        return self._entry(name)[1]

    def _entry(self, name: str):
        if name not in self._entries:
            raise KeyError(f"{name} is not in {self.path}")
        return self._entries[name]

    def get_tensor(self, name: str) -> torch.Tensor:
        """The tensor as stored, on the CPU, over the file's mapped pages
        (a copy only when its offset is not aligned to its item size)."""
        dtype, shape, begin, end = self._entry(name)
        if begin == end:
            return torch.empty(shape, dtype=dtype)
        raw = self._data[begin:end]
        if (raw.ctypes.data % dtype.itemsize) or not raw.flags.writeable:
            raw = np.array(raw)
        return torch.frombuffer(raw, dtype=dtype).reshape(shape)

    def close(self) -> None:
        """Drop the mapping (tensors still viewing it keep it alive)."""
        self._data = None
        self._entries = {}

    def __enter__(self) -> "SafeFile":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def save_file(tensors: dict[str, torch.Tensor], path: str) -> int:
    """Write `tensors` to `path` as one safetensors file, fsynced, and
    return its size in bytes. Tensors not on the CPU are copied there
    first."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: dict[str, Any] = {}
    offset = 0
    for name in order:
        t = tensors[name]
        if t.dtype not in DTYPE_NAMES:
            raise SafetensorsError(
                f"tensor {name!r} has dtype {t.dtype}; this writer takes "
                f"{sorted(str(d) for d in DTYPE_NAMES)}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": DTYPE_NAMES[t.dtype],
                        "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(head)))
        fh.write(head)
        for name in order:
            t = tensors[name].detach()
            if t.numel() == 0:
                continue
            raw = t.cpu().contiguous().reshape(-1).view(torch.uint8)
            fh.write(memoryview(raw.numpy()))
        fh.flush()
        os.fsync(fh.fileno())
    return 8 + len(head) + offset
