"""Byte-level tokenizer (counterpart of kubeflow_tpu/serving/tokenizer.py
`ByteTokenizer`): token id == UTF-8 byte value."""

from __future__ import annotations

from typing import Sequence


class ByteTokenizer:
    """UTF-8 byte-level: token id == byte value. Lossless for any text;
    ids outside 0..255 (e.g. a model's EOS) decode to nothing."""

    vocab_size = 256

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode(
            "utf-8", errors="replace")
