"""Tokenizers for the text endpoints (counterpart of
kubeflow_tpu/serving/tokenizer.py): the runtime owns the tokenizer, the
model sees ids.

  - `ByteTokenizer`: UTF-8 bytes, token id = byte value (0..255); works
    with any model whose vocabulary covers 256, and is what a model
    directory without tokenizer files gets.
  - an HF tokenizer: `load_tokenizer("/path/to/dir")` loads a local
    pretrained tokenizer through `transformers`, imported only there; on
    a machine without `transformers` that call raises, as in the JAX
    package.
"""

from __future__ import annotations

from typing import Any, Sequence


class ByteTokenizer:
    """UTF-8 byte-level: token id == byte value. Lossless for any text;
    ids outside 0..255 (e.g. a model's EOS) decode to nothing."""

    vocab_size = 256

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode(
            "utf-8", errors="replace")


def chat_prompt_ids(tokenizer: Any, messages: list[dict]) -> list[int]:
    """messages → prompt token ids. Uses the tokenizer's own chat template
    when it has one (HF); otherwise a plain role-tagged concatenation with
    a generation prompt for the assistant turn."""
    if hasattr(tokenizer, "apply_chat_template"):
        return tokenizer.apply_chat_template(messages)
    text = "".join(f"<|{m['role']}|>\n{m['content']}\n" for m in messages)
    return tokenizer.encode(text + "<|assistant|>\n")


class StreamDecoder:
    """Incremental detokenizer for streaming: decodes the RUNNING token
    sequence and emits the stable text delta, holding back trailing
    replacement characters that may be an incomplete multi-byte/multi-token
    sequence still being generated (decoding tokens one at a time would
    corrupt any non-ASCII output)."""

    def __init__(self, tokenizer: Any):
        self._tok = tokenizer
        self._ids: list[int] = []
        self._emitted = 0

    def push(self, token_id: int) -> str:
        self._ids.append(int(token_id))
        text = self._tok.decode(self._ids)
        safe = len(text)
        while safe > 0 and text[safe - 1] == "�":
            safe -= 1
        delta, self._emitted = text[self._emitted:safe], max(self._emitted,
                                                            safe)
        return delta

    def flush(self) -> str:
        """Whatever is still held back once the stream ends (a genuinely
        malformed tail decodes to its replacement characters here)."""
        text = self._tok.decode(self._ids)
        delta, self._emitted = text[self._emitted:], len(text)
        return delta


def load_tokenizer(spec: str | None) -> Any:
    """None → ByteTokenizer; a path → local HF tokenizer directory."""
    if spec is None:
        return ByteTokenizer()
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise RuntimeError(
            f"tokenizer {spec!r} needs transformers: {e}") from e
    tok = AutoTokenizer.from_pretrained(spec)

    class _HF:
        vocab_size = tok.vocab_size
        eos_id = tok.eos_token_id  # None when the tokenizer defines none

        def encode(self, text: str) -> list[int]:
            return tok.encode(text, add_special_tokens=False)

        def decode(self, ids: Sequence[int]) -> str:
            return tok.decode(list(ids), skip_special_tokens=True)

        if getattr(tok, "chat_template", None):
            def apply_chat_template(self, messages: list) -> list[int]:
                return tok.apply_chat_template(messages,
                                               add_generation_prompt=True)

    return _HF()
