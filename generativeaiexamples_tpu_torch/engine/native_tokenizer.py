"""ctypes bridge to the C++ WordPiece tokenizer ``native/wordpiece.cpp``
(port of the JAX package's ``engine/native_tokenizer.py``).

Host tokenization is the embedder's per-document CPU cost; the C++
longest-match loop takes it off the interpreter for ASCII text.
``WordPieceTokenizer`` routes only NUL-free ASCII text here and keeps the
Python path for everything else, which gives the same ids
(``tests/test_torch_tokenizer.py``).
"""

from __future__ import annotations

import ctypes

import numpy as np

from generativeaiexamples_tpu_torch.utils.native_build import load_native_library

_configured = False


def load_library() -> ctypes.CDLL:
    """Load (building if needed) the wordpiece shared library."""
    global _configured
    lib = load_native_library("wordpiece")
    if not _configured:
        lib.wp_create.restype = ctypes.c_void_p
        lib.wp_create.argtypes = [ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
        lib.wp_free.argtypes = [ctypes.c_void_p]
        lib.wp_encode.restype = ctypes.c_int32
        lib.wp_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        _configured = True
    return lib


class NativeWordPiece:
    """One built vocab; ``encode`` returns raw ids (no special tokens)."""

    def __init__(self, vocab_blob: str, *, lowercase: bool, unk_id: int, max_word_chars: int) -> None:
        self._lib = load_library()
        self._handle = self._lib.wp_create(vocab_blob.encode("ascii"), 1 if lowercase else 0, unk_id, max_word_chars)
        if not self._handle:
            raise RuntimeError("wp_create failed")

    def __del__(self) -> None:
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.wp_free(handle)
            self._handle = None

    def encode(self, text: str) -> list[int]:
        data = text.encode("ascii")
        cap = max(len(data), 1)
        out = np.empty(cap, dtype=np.int32)
        n = self._lib.wp_encode(self._handle, data, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
        if n < 0:  # cannot happen: a text of n bytes gives at most n ids
            raise RuntimeError("wp_encode overflow")
        return out[:n].tolist()
