"""Byte-level tokenizer and llama3-style chat template (port of the byte
path of ``engine/tokenizer.py``; the HF tokenizer is not ported yet, so
every model name gets the byte tokenizer, as the reference does when no
local tokenizer files exist).

One difference from the reference: a model whose vocabulary is larger
than the byte tokenizer's (Llama-3's 128256 ids) can emit ids past it,
which the reference renders as nothing.  The port renders each as
``<|id|>``, so a random-weight model's output is visible text and equal
token streams give equal text.
"""

from __future__ import annotations

import codecs
from typing import Callable, Optional, Sequence


def render_chat(messages: Sequence[tuple[str, str]], add_generation_prompt: bool = True) -> str:
    """(role, content) turns -> a single prompt string (llama3-flavored)."""
    parts = []
    for role, content in messages:
        parts.append(f"<|start_header_id|>{role}<|end_header_id|>\n\n{content}<|eot_id|>")
    if add_generation_prompt:
        parts.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    return "".join(parts)


class ByteTokenizer:
    """UTF-8 bytes as tokens; ids 0..255 = bytes, then pad/bos/eos."""

    def __init__(self) -> None:
        self.pad_id = 256
        self.bos_id = 257
        self.eos_id = 258
        self.vocab_size = 259

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        piece = decode_stream(self)
        return "".join(piece(i) for i in ids) + piece(0, final=True)

    def apply_chat_template(self, messages: Sequence[tuple[str, str]]) -> list[int]:
        return self.encode(render_chat(messages))


def decode_stream(tokenizer) -> Callable[..., str]:
    """Incremental, byte-safe detokenizer: ``piece(tid)`` returns the text
    that token completes, ``piece(0, final=True)`` flushes."""
    decoder = codecs.getincrementaldecoder("utf-8")(errors="replace")

    def piece(tid: int, final: bool = False) -> str:
        if final:
            return decoder.decode(b"", final=True)
        if tid < 256:
            return decoder.decode(bytes([tid]))
        if tid < tokenizer.vocab_size:  # pad / bos / eos
            return ""
        return f"<|{tid}|>"

    return piece


def get_tokenizer(name_or_path: Optional[str] = None) -> ByteTokenizer:
    """The byte tokenizer, for any model name."""
    return ByteTokenizer()
