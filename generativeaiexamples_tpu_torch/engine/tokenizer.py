"""Tokenizers for the serving engine (port of ``engine/tokenizer.py``).

Three implementations behind one duck-typed interface, each with a
llama3-style chat template:

* :class:`WordPieceTokenizer`: BERT WordPiece from a checkpoint's
  ``vocab.txt`` (the embedder's and the cross-encoder's), dependency-free,
  with the C++ ASCII fast path of ``native/wordpiece.cpp``
  (``engine.native_tokenizer``).
* :class:`HFTokenizer`: a ``transformers`` tokenizer whose files are
  local; ``transformers`` is imported only when one is built (the card
  machine has none, so there a Llama name gets the byte tokenizer, as the
  reference does without local files).
* :class:`ByteTokenizer`: UTF-8 bytes, for hermetic tests and
  random-weight serving.

:func:`get_tokenizer` chooses among them in the reference's order.  One
difference from the reference: a model whose vocabulary is larger than
the byte tokenizer's (Llama-3's 128256 ids) can emit ids past it, which
the reference renders as nothing.  The port renders each as ``<|id|>``,
so a random-weight model's output is visible text and equal token streams
give equal text.
"""

from __future__ import annotations

import codecs
import json
import os
import unicodedata
from typing import Callable, Optional, Sequence

# Engine-internal model preset names: never valid HF hub ids.
ENGINE_PRESETS = frozenset(
    {"llama-tiny", "llama3-8b", "llama3-70b", "arctic-embed-l", "bert-tiny", "cross-encoder-rerank"}
)


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


class WordPieceTokenizer:
    """BERT-style WordPiece tokenizer (``vocab.txt`` driven).

    The standard pipeline: whitespace / punctuation basic tokenization with
    optional lower-casing and accent stripping, then greedy longest-match
    WordPiece with ``##`` continuation pieces, as ``transformers``'
    ``BertTokenizer``.  NUL-free ASCII text goes through the C++ library
    (``engine.native_tokenizer``, built at first use); other text, a vocab
    whose ids are not dense, or ``GAIE_DISABLE_NATIVE_TOKENIZER`` keep the
    Python path, which gives the same ids.
    """

    def __init__(self, vocab, *, lowercase: bool = True, unk_token: str = "[UNK]", max_word_chars: int = 100) -> None:
        if isinstance(vocab, (str, bytes)):
            with open(vocab, encoding="utf-8") as fh:
                tokens = [line.rstrip("\n") for line in fh]
            self.vocab = {t: i for i, t in enumerate(tokens)}
        else:
            self.vocab = dict(vocab)
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        self.lowercase = lowercase
        self.unk_token = unk_token
        self.max_word_chars = max_word_chars
        self.vocab_size = len(self.vocab)
        self.pad_id = self.vocab.get("[PAD]", 0)
        self.cls_id = self.vocab.get("[CLS]", 1)
        self.sep_id = self.vocab.get("[SEP]", 2)
        self.unk_id = self.vocab.get(unk_token, 3)
        # Duck-type compatibility with the byte and HF tokenizers.
        self.bos_id = self.cls_id
        self.eos_id = self.sep_id
        self._native = None
        self._native_tried = False

    @staticmethod
    def _is_punct(ch: str) -> bool:
        cp = ord(ch)
        if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
            return True
        return unicodedata.category(ch).startswith("P")

    @staticmethod
    def _is_cjk(ch: str) -> bool:
        # The 8 ranges BertTokenizer._is_chinese_char splits on.
        cp = ord(ch)
        return (
            0x4E00 <= cp <= 0x9FFF
            or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F
            or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF
            or 0x2F800 <= cp <= 0x2FA1F
        )

    def _basic_tokens(self, text: str) -> list[str]:
        if self.lowercase:
            text = unicodedata.normalize("NFD", text.lower())
            text = "".join(ch for ch in text if unicodedata.category(ch) != "Mn")
        out: list[str] = []
        word: list[str] = []
        for ch in text:
            cp = ord(ch)
            if ch in "\t\n\r":
                ch = " "  # BERT treats these controls as whitespace
            elif cp == 0 or cp == 0xFFFD or unicodedata.category(ch).startswith("C"):
                continue
            if ch.isspace():
                if word:
                    out.append("".join(word))
                    word = []
            elif self._is_punct(ch) or self._is_cjk(ch):
                if word:
                    out.append("".join(word))
                    word = []
                out.append(ch)
            else:
                word.append(ch)
        if word:
            out.append("".join(word))
        return out

    def _wordpiece(self, word: str) -> list[int]:
        if len(word) > self.max_word_chars:
            return [self.unk_id]
        pieces: list[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            pieces.append(cur)
            start = end
        return pieces

    def native_handle(self):
        """The C++ tokenizer for this vocab (built at first use), or None
        where the Python path serves: ``GAIE_DISABLE_NATIVE_TOKENIZER``, ids
        that are not dense, a token holding a newline or NUL (the library
        indexes tokens by line), or a library that does not build."""
        if self._native_tried:
            return self._native
        self._native_tried = True
        if os.environ.get("GAIE_DISABLE_NATIVE_TOKENIZER"):
            return None
        if sorted(self.inv_vocab) != list(range(len(self.vocab))):
            return None
        if any("\n" in t or "\x00" in t for t in self.vocab):
            return None
        try:
            from generativeaiexamples_tpu_torch.engine import native_tokenizer

            # Non-ASCII entries never match the ASCII-only native path:
            # their lines stay empty, so every other id keeps its line.
            blob = "\n".join(
                self.inv_vocab[i] if self.inv_vocab[i].isascii() else "" for i in range(len(self.vocab))
            )
            self._native = native_tokenizer.NativeWordPiece(
                blob, lowercase=self.lowercase, unk_id=self.unk_id, max_word_chars=self.max_word_chars
            )
        except Exception:  # noqa: BLE001 - the reference's rule: the Python path serves
            self._native = None
        return self._native

    def tokenize_ids(self, text: str) -> list[int]:
        """Raw WordPiece ids, no special tokens."""
        # NUL would end the C string early (the Python path drops it and
        # goes on), so NUL-bearing text stays on Python.
        if text.isascii() and "\x00" not in text:
            native = self.native_handle()
            if native is not None:
                return native.encode(text)
        ids: list[int] = []
        for word in self._basic_tokens(text):
            ids.extend(self._wordpiece(word))
        return ids

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = self.tokenize_ids(text)
        return [self.cls_id] + ids + [self.sep_id] if add_bos else ids

    def encode_pair(self, text_a, text_b: str, max_length: Optional[int] = None) -> tuple[list[int], list[int]]:
        """``[CLS] a [SEP] b [SEP]`` with BERT segment ids (0s then 1s).

        ``text_a`` may be a pre-tokenized id list (a query scored against
        many passages tokenizes once).  With ``max_length`` the pair is
        truncated longest-first, so both segments survive.
        """
        a = list(text_a) if isinstance(text_a, list) else self.tokenize_ids(text_a)
        b = self.tokenize_ids(text_b)
        if max_length is not None:
            budget = max_length - 3
            while len(a) + len(b) > budget and (a or b):
                if len(a) > len(b):
                    a.pop()
                else:
                    b.pop()
        ids = [self.cls_id] + a + [self.sep_id] + b + [self.sep_id]
        types = [0] * (len(a) + 2) + [1] * (len(b) + 1)
        return ids, types

    def decode(self, ids: Sequence[int]) -> str:
        special = {self.pad_id, self.cls_id, self.sep_id}
        words: list[str] = []
        for i in ids:
            if i in special:
                continue
            piece = self.inv_vocab.get(i, self.unk_token)
            if piece.startswith("##") and words:
                words[-1] += piece[2:]
            else:
                words.append(piece)
        return " ".join(words)

    def apply_chat_template(self, messages: Sequence[tuple[str, str]]) -> list[int]:
        return self.encode(render_chat(messages))


class HFTokenizer:
    """A ``transformers`` tokenizer whose files are local (imported only
    when one is built)."""

    def __init__(self, name_or_path: str, local_files_only: bool = True) -> None:
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(name_or_path, local_files_only=local_files_only)
        self.vocab_size = len(self._tok)
        self.bos_id = self._tok.bos_token_id
        self.eos_id = self._tok.eos_token_id
        pad = self._tok.pad_token_id
        self.pad_id = pad if pad is not None else self.eos_id

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        return self._tok.encode(text, add_special_tokens=add_bos)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)

    def apply_chat_template(self, messages: Sequence[tuple[str, str]]) -> list[int]:
        try:
            return self._tok.apply_chat_template(
                [{"role": r, "content": c} for r, c in messages], add_generation_prompt=True
            )
        except Exception:  # noqa: BLE001 - no template: the llama3 rendering, as the reference
            return self.encode(render_chat(messages))


def decode_stream(tokenizer) -> Callable[..., str]:
    """Incremental detokenizer: ``piece(tid)`` returns the text that token
    completes, ``piece(0, final=True)`` flushes.  Byte-safe for the byte
    tokenizer; other tokenizers decode token by token, as the
    reference's."""
    if getattr(tokenizer, "vocab_size", 0) != 259:

        def token_piece(tid: int, final: bool = False) -> str:
            return "" if final else tokenizer.decode([tid])

        return token_piece
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


def _wordpiece_dir(path: str) -> Optional[WordPieceTokenizer]:
    """A checkpoint directory's bare ``vocab.txt`` as WordPiece, with
    ``do_lower_case`` from its ``tokenizer_config.json`` (default true)."""
    vocab = os.path.join(path, "vocab.txt")
    if not os.path.isfile(vocab):
        return None
    lowercase = True
    tok_cfg = os.path.join(path, "tokenizer_config.json")
    if os.path.isfile(tok_cfg):
        try:
            with open(tok_cfg, encoding="utf-8") as fh:
                lowercase = bool(json.load(fh).get("do_lower_case", True))
        except (OSError, ValueError):
            pass
    return WordPieceTokenizer(vocab, lowercase=lowercase)


def _may_be_local(name_or_path: str) -> bool:
    """Whether ``transformers`` could find files for ``name_or_path``
    without the hub: a directory, or a hub name with a folder in the local
    hub cache (``HF_HUB_CACHE``, ``HUGGINGFACE_HUB_CACHE``, ``HF_HOME/hub``
    or ``$XDG_CACHE_HOME/huggingface/hub``, and ``TRANSFORMERS_CACHE``).
    A name with neither fails ``local_files_only`` whatever happens, and
    importing ``transformers`` only to learn that costs seconds (15 s cold
    on an H100 host)."""
    if os.path.isdir(name_or_path):
        return True
    home = os.environ.get("HF_HOME") or os.path.join(
        os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache"), "huggingface")
    caches = [os.environ.get(key) for key in ("HF_HUB_CACHE", "HUGGINGFACE_HUB_CACHE", "TRANSFORMERS_CACHE")]
    folder = "models--" + name_or_path.replace("/", "--")
    return any(os.path.isdir(os.path.join(cache, folder)) for cache in caches + [os.path.join(home, "hub")] if cache)


def get_tokenizer(name_or_path: Optional[str] = None):
    """The reference's order: a directory with ``vocab.txt`` is WordPiece;
    then local HF tokenizer files; then, for a name that is no engine
    preset and only while ``HF_HUB_OFFLINE`` is unset, the hub; else
    bytes."""
    if name_or_path:
        if os.path.isdir(name_or_path):
            wordpiece = _wordpiece_dir(name_or_path)
            if wordpiece is not None:
                return wordpiece
        if _may_be_local(name_or_path):
            try:
                return HFTokenizer(name_or_path, local_files_only=True)
            except Exception:  # noqa: BLE001 - no transformers, or no local files
                pass
        if name_or_path not in ENGINE_PRESETS and os.environ.get("HF_HUB_OFFLINE", "") not in ("1", "true"):
            try:
                return HFTokenizer(name_or_path, local_files_only=False)
            except Exception:  # noqa: BLE001
                pass
    return ByteTokenizer()
