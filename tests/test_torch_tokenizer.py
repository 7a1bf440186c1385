"""The port's tokenizers against the JAX package's, on the CPU.

``WordPieceTokenizer`` gives the JAX one's ids and ``transformers``'
``BertTokenizer``'s on texts and pairs (longest-first truncation), through
the native C++ path and the Python path alike; the native path equals the
Python path on adversarial inputs and keeps the reference's rules for when
Python serves; ``HFTokenizer`` equals the JAX ``HFTokenizer`` on a
byte-level BPE tokenizer built here with ``tokenizers`` (encode, decode,
chat template); ``get_tokenizer`` chooses as the JAX package does; the
reranker builds the reference's two-segment pairs; the stream decoder
decodes token by token for tokenizers other than bytes.
"""

import random
import shutil

import pytest

from generativeaiexamples_tpu.engine import tokenizer as jtok
from generativeaiexamples_tpu_torch.engine import tokenizer as ttok

transformers = pytest.importorskip("transformers")

# Dense ids (no token twice), so the native path serves.
VOCAB = ("[PAD] [CLS] [SEP] [UNK] the quick brown fox jump ##s over lazy dog embed ##ding retrieval augment "
         "##ed generation tpu native frame ##work , . ! ? 1 2 3 ##0 a b c").split()
TEXTS = [
    "The quick brown fox jumps over the lazy dog.",
    "Embeddings, retrieval-augmented generation!",
    "TPU native framework? 120 quacks",
    "  weird   spacing\tand\nnewlines ",
]
NATIVE = pytest.param(True, id="native")
PYTHON = pytest.param(False, id="python")


def _wordpiece(mod, vocab, native: bool):
    tok = mod.WordPieceTokenizer(vocab)
    if not native:
        tok._native_tried = True  # pin the Python path
    elif shutil.which("g++") is None:
        pytest.skip("g++ is missing: the native WordPiece library cannot build")
    return tok


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("wp") / "vocab.txt"
    path.write_text("\n".join(VOCAB) + "\n")
    return str(path)


@pytest.mark.parametrize("native", [NATIVE, PYTHON])
def test_wordpiece_equals_reference_and_bert_tokenizer(vocab_file, native):
    ours = _wordpiece(ttok, vocab_file, native)
    ref = jtok.WordPieceTokenizer(vocab_file)
    theirs = transformers.BertTokenizer(vocab_file, do_lower_case=True)
    for text in TEXTS:
        assert ours.encode(text) == ref.encode(text) == theirs.encode(text), text
        assert ours.encode(text, add_bos=False) == ref.encode(text, add_bos=False)
        assert ours.decode(ours.encode(text)) == ref.decode(ref.encode(text))
    assert (ours._native is not None) == native
    q, p = "the quick fox", "embeddings over the lazy dog framework"
    ids, types = ours.encode_pair(q, p)
    want = theirs(q, p)
    assert (ids, types) == ref.encode_pair(q, p) == (want["input_ids"], want["token_type_ids"])
    for max_length in (10, 7, 3):
        ids, types = ours.encode_pair(q, p, max_length=max_length)
        want = theirs(q, p, truncation="longest_first", max_length=max_length)
        assert (ids, types) == ref.encode_pair(q, p, max_length=max_length)
        assert (ids, types) == (want["input_ids"], want["token_type_ids"])
    # A pre-tokenized first segment (a query scored against many passages).
    assert ours.encode_pair(ours.tokenize_ids(q), p, max_length=10) == ref.encode_pair(
        ref.tokenize_ids(q), p, max_length=10)
    assert ours.apply_chat_template([("user", "the dog")]) == ref.apply_chat_template([("user", "the dog")])


WORDS = ("the of and to in retrieval augmented generation embedding vector search pipeline index document query "
         "context tokens model unbelievable restructuring tokenization hyperparameters").split()
TRICKY = ["Hello, World!  x", "a" * 150, "don't stop-me now...", "tabs\tand\nnewlines\r ok", ")(*&^%$#@!", "", "   ",
          "MiXeD CaSe WoRdS", "zzzzzq unmatchable##", "1 2 3 42 x9", "café déjà vu — naïve", "hello\x00world of vectors",
          "\x07bell and \x1b escape"]


def _native_vocab():
    specials = ["[PAD]", "[CLS]", "[SEP]", "[UNK]", "[MASK]"]
    chars = [chr(c) for c in range(ord("a"), ord("z") + 1)] + list("0123456789")
    toks = (specials + chars + ["##" + c for c in chars] + ["##ing", "##ed", "##tion", "##s", "##er", "##ly", "##ment"]
            + [w for i, w in enumerate(WORDS) if i % 5 != 0] + ["naïve"])
    return {t: i for i, t in enumerate(dict.fromkeys(toks))}


@pytest.fixture(scope="module")
def native_pair():
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the native WordPiece library cannot build")
    native = ttok.WordPieceTokenizer(_native_vocab())
    assert native.native_handle() is not None
    python = _wordpiece(ttok, _native_vocab(), native=False)
    return native, python


def test_native_equals_python_and_the_reference(native_pair):
    native, python = native_pair
    ref = jtok.WordPieceTokenizer(_native_vocab())
    rng = random.Random(7)
    corpus = TRICKY + [" ".join(rng.choice(WORDS) for _ in range(rng.randint(1, 200))) for _ in range(100)]
    for text in corpus:
        assert native.tokenize_ids(text) == python.tokenize_ids(text) == ref.tokenize_ids(text), repr(text)
    assert native.encode_pair("the query", "the document text") == python.encode_pair("the query", "the document text")
    # NUL-bearing text stays on Python (the C string would end at the NUL).
    assert len(native.tokenize_ids("hello\x00world of vectors")) > 2


@pytest.mark.parametrize("case", ["env", "newline", "nul", "sparse"])
def test_python_serves_where_the_reference_says(case, monkeypatch):
    vocab = _native_vocab()
    if case == "env":
        monkeypatch.setenv("GAIE_DISABLE_NATIVE_TOKENIZER", "1")
    elif case == "newline":
        vocab["bad\ntoken"] = len(vocab)
    elif case == "nul":
        vocab["bad\x00token"] = len(vocab)
    else:
        vocab["gap"] = len(vocab) + 5  # ids that are not dense
    for mod in (ttok, jtok):
        tok = mod.WordPieceTokenizer(vocab)
        tok.tokenize_ids("warm")
        assert tok._native is None, mod.__name__
    assert ttok.WordPieceTokenizer(vocab).tokenize_ids("the index") == jtok.WordPieceTokenizer(vocab).tokenize_ids(
        "the index")


def test_native_library_builds_in_the_ports_own_directory():
    from generativeaiexamples_tpu_torch.engine import native_tokenizer
    from generativeaiexamples_tpu_torch.utils import native_build

    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the native WordPiece library cannot build")
    native_tokenizer.load_library()
    assert native_build.BUILD_DIR.endswith("build/torch_native")
    assert native_build._cache["wordpiece"]._name.startswith(native_build.BUILD_DIR)


@pytest.fixture(scope="module")
def bpe_dir(tmp_path_factory):
    """A byte-level BPE tokenizer with a chat template, saved as local HF
    files (nothing is fetched)."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=320, special_tokens=["<unk>", "<s>", "</s>"],
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(TEXTS * 20 + ["retrieval augmented generation on one card"] * 20, trainer)
    root = tmp_path_factory.mktemp("bpe")
    fast = transformers.PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<s>", eos_token="</s>",
                                                unk_token="<unk>")
    fast.save_pretrained(str(root / "plain"))
    fast.chat_template = ("{% for m in messages %}<|{{ m['role'] }}|>{{ m['content'] }}</s>{% endfor %}"
                          "{% if add_generation_prompt %}<|assistant|>{% endif %}")
    fast.save_pretrained(str(root / "chat"))
    return {"plain": str(root / "plain"), "chat": str(root / "chat")}


@pytest.mark.parametrize("which", ["plain", "chat"])
def test_hf_tokenizer_equals_reference(bpe_dir, which):
    ours, ref = ttok.HFTokenizer(bpe_dir[which]), jtok.HFTokenizer(bpe_dir[which])
    assert (ours.vocab_size, ours.bos_id, ours.eos_id, ours.pad_id) == (ref.vocab_size, ref.bos_id, ref.eos_id,
                                                                        ref.pad_id)
    for text in TEXTS + ["ünïcödé text"]:
        for add_bos in (True, False):
            assert ours.encode(text, add_bos) == ref.encode(text, add_bos)
        ids = ours.encode(text)
        assert ours.decode(ids) == ref.decode(ids)
    messages = [("system", "be brief"), ("user", "the quick fox")]
    assert ours.apply_chat_template(messages) == ref.apply_chat_template(messages)
    piece = ttok.decode_stream(ours)
    ids = ours.encode("the quick brown fox", add_bos=False)
    assert "".join(piece(i) for i in ids) + piece(0, final=True) == "".join(ours.decode([i]) for i in ids)


def test_get_tokenizer_chooses_as_the_reference(bpe_dir, vocab_file, tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    cased = tmp_path / "cased"
    shutil.copytree(vocab_file.rsplit("/", 1)[0], cased)
    (cased / "tokenizer_config.json").write_text('{"do_lower_case": false}')
    cases = [None, "", "llama-tiny", "llama3-8b", "meta-llama/Meta-Llama-3-8B-Instruct", bpe_dir["plain"],
             vocab_file.rsplit("/", 1)[0], str(cased), str(tmp_path / "missing")]
    for name in cases:
        ours, ref = ttok.get_tokenizer(name), jtok.get_tokenizer(name)
        assert type(ours).__name__ == type(ref).__name__, name
        assert ours.encode("The quick fox") == ref.encode("The quick fox"), name
    assert ttok.get_tokenizer(str(cased)).lowercase is False
    assert ttok.ENGINE_PRESETS == jtok.ENGINE_PRESETS


def test_hub_name_without_a_cache_folder_skips_transformers(tmp_path, monkeypatch):
    """A hub name is tried through ``transformers`` (local files only) only
    when the local hub cache holds a folder for it: without one the port
    gives bytes, as the reference does after its failed lookup, without
    building an ``HFTokenizer``; with one it builds it."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    for key in ("HUGGINGFACE_HUB_CACHE", "TRANSFORMERS_CACHE"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    built = []

    class Stub:
        def __init__(self, name, local_files_only=True):
            built.append((name, local_files_only))
            raise OSError("no local files")

    monkeypatch.setattr(ttok, "HFTokenizer", Stub)
    name = "Snowflake/snowflake-arctic-embed-l"
    assert type(ttok.get_tokenizer(name)).__name__ == type(jtok.get_tokenizer(name)).__name__ == "ByteTokenizer"
    assert built == [] and not ttok._may_be_local(name)
    for folder in (tmp_path / "hub", tmp_path / "home" / "hub"):
        (folder / "models--Snowflake--snowflake-arctic-embed-l").mkdir(parents=True)
        assert ttok._may_be_local(name)
        assert type(ttok.get_tokenizer(name)).__name__ == "ByteTokenizer" and built.pop() == (name, True)
        shutil.rmtree(folder)


def test_reranker_builds_the_references_pairs(vocab_file):
    """Two segments with a WordPiece vocab, segment 0 with bytes: the port's
    ``GPUReranker`` encodes each (query, passage) as ``TPUReranker`` does."""
    from generativeaiexamples_tpu.engine.reranker import TPUReranker
    from generativeaiexamples_tpu.models import bert as jbert
    from generativeaiexamples_tpu_torch.engine.reranker import GPUReranker
    from generativeaiexamples_tpu_torch.models import bert as tbert

    pairs = [("the quick fox", "embeddings over the lazy dog framework"), ("tpu", "a b c " * 20)]
    for tokenizers in ((ttok.WordPieceTokenizer(vocab_file), jtok.WordPieceTokenizer(vocab_file)),
                       (ttok.ByteTokenizer(), jtok.ByteTokenizer())):
        ours = GPUReranker(tbert.bert_tiny(max_positions=16), tokenizer=tokenizers[0], device="cpu")
        ref = TPUReranker(jbert.bert_tiny(max_positions=16), tokenizer=tokenizers[1])
        for q, p in pairs:
            got = ours._encode_pair(ours._query_ids(q), p)
            assert got == ref._encode_pair(ref._query_ids(q), p)
            assert len(got[0]) <= 16
        if isinstance(tokenizers[0], ttok.WordPieceTokenizer):
            ids, types = ours._encode_pair(ours._query_ids(pairs[0][0]), pairs[0][1])
            assert ids[0] == 1 and ids.count(2) == 2 and set(types) == {0, 1}
