"""Port parity: GPT-2's byte-level BPE (``GPT2Tokenizer``) and BERT's
WordPiece (``BertTokenizer``).

A byte-level vocabulary and merges are learned from a fixed text (the
usual BPE training: the most frequent adjacent pair of each pre-split word
merged, 80 times; every merge's parts and result are vocabulary entries,
so the JAX package takes its native merge core where the library is
built).  The port's Python merge loop gives the JAX package's ids on
texts in and out of the training text (unicode, digits, runs of spaces,
contractions), and on a vocabulary whose merges leave it (the JAX Python
path); ``decode`` inverts ``encode``.  The handcrafted cases of the JAX
package's tests/test_gpt.py and tests/test_native.py hold too.  BERT's
tokenizer equals the JAX one on the synthetic vocabulary (``[MASK]``,
unknown words, punctuation).  ``from_pretrained`` of both reads a
pre-seeded ``LIGHTGRAD_CACHE``.  Exact equality throughout.
"""

import collections
import hashlib
import json

import pytest

from lightgrad_tpu import native
from lightgrad_tpu.models import BertTokenizer as JBertTokenizer
from lightgrad_tpu.models import GPT2Tokenizer as JGPT2Tokenizer
from lightgrad_tpu_torch.models import BertTokenizer, GPT2Tokenizer

CORPUS = ("The quick brown fox jumps over the lazy dog. It's the dog's "
          "day: 42 dogs, 7 foxes -- and they've all gone home!  Ünïcödé "
          "text, naïve café, and 日本語 too. the the the quick quick fox")
TEXTS = [CORPUS, "hello world", "The dog's 1234 foxes  jumped!!",
         "  leading and trailing  ", "naïve 日本 café\nnew line\ttab", ""]


def _learn(text, n_merges=80):
    """A GPT-2-style vocabulary (the 256 byte symbols, then each merge's
    result) and merges learned from ``text``."""
    enc = GPT2Tokenizer._bytes_to_unicode()
    words = collections.Counter(
        tuple(enc[b] for b in tok.encode("utf-8"))
        for tok in GPT2Tokenizer._PAT.findall(text))
    vocab = {enc[b]: i for i, b in enumerate(sorted(enc))}
    merges = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for w, c in words.items():
            for p in zip(w, w[1:]):
                pairs[p] += c
        if not pairs:
            break
        best = max(pairs, key=lambda p: (pairs[p], p))
        merges.append(best)
        vocab.setdefault(best[0] + best[1], len(vocab))
        new = collections.Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i < len(w) - 1 and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            new[tuple(out)] += c
        words = new
    return vocab, merges


def test_gpt2_tokenizer_matches_jax_on_a_learned_vocabulary():
    vocab, merges = _learn(CORPUS)
    assert len(merges) == 80
    tok = GPT2Tokenizer(vocab, merges)
    jtok = JGPT2Tokenizer(vocab, merges)
    if native.available():
        assert jtok._native_handle >= 0     # JAX merges natively here
    for text in TEXTS:
        ids = tok.encode(text)
        assert ids == jtok.encode(text), text
        assert tok.decode(ids) == text == jtok.decode(ids)
    # merges compress the training text
    assert len(tok.encode(CORPUS)) < len(CORPUS.encode("utf-8")) // 2


def test_gpt2_tokenizer_matches_jax_when_merges_leave_the_vocab():
    """Merges whose results are not all vocabulary entries: the JAX package
    takes its Python loop too; pieces outside the vocabulary drop."""
    vocab, merges = _learn(CORPUS, 60)
    for piece in list(vocab)[256 + 10: 256 + 30]:
        del vocab[piece]
    vocab = {p: i for i, p in enumerate(vocab)}
    tok, jtok = GPT2Tokenizer(vocab, merges), JGPT2Tokenizer(vocab, merges)
    for text in TEXTS:
        assert tok.encode(text) == jtok.encode(text), text


def test_gpt2_handcrafted_cases():
    enc = GPT2Tokenizer._bytes_to_unicode()
    h, e, l, o, sp, w = (enc[ord(c)] for c in "helo w")
    vocab = {h: 0, e: 1, l: 2, o: 3, "ll": 4, "llo": 5, sp + w: 6}
    tok = GPT2Tokenizer(vocab, [(l, l), ("ll", o), (sp, w)])
    assert tok.encode("hello w") == [0, 1, 5, 6]
    assert tok.decode([0, 1, 5, 6]) == "hello w"
    tok = GPT2Tokenizer({"a": 0, "aa": 1, "aaaa": 2},
                        [("a", "a"), ("aa", "aa")])
    assert tok._encode_word("aaa") == [1, 0]
    assert tok._encode_word("aaaa") == [2]
    assert tok._encode_word("aaaaa") == [2, 0]


def _seed(tmp_path, url, files, monkeypatch):
    for name, data in files.items():
        key = hashlib.md5((url + name).encode()).hexdigest()
        (tmp_path / key).write_bytes(data)
    monkeypatch.setenv("LIGHTGRAD_CACHE", str(tmp_path))


def test_gpt2_from_pretrained_reads_a_seeded_cache(tmp_path, monkeypatch):
    vocab, merges = _learn(CORPUS, 50)
    merges_txt = "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges)
    _seed(tmp_path, "https://huggingface.co/tiny/gpt2/resolve/main/",
          {"vocab.json": json.dumps(vocab).encode(),
           "merges.txt": merges_txt.encode()}, monkeypatch)
    tok = GPT2Tokenizer.from_pretrained("tiny/gpt2")
    jtok = JGPT2Tokenizer.from_pretrained("tiny/gpt2")
    assert tok.bpe_ranks == jtok.bpe_ranks and tok.encoder == jtok.encoder
    for text in TEXTS:
        assert tok.encode(text) == jtok.encode(text)


@pytest.mark.parametrize("text", [
    "tok1 tok22 [MASK] tok994", "TOK5 [mask] tok999 tok1,tok2!",
    "unknownword tok7", "", "[MASK][MASK]"])
def test_bert_tokenizer_matches_jax(text):
    tok, jtok = BertTokenizer.synthetic(), JBertTokenizer.synthetic()
    assert tok.vocab == jtok.vocab
    assert tok.tokenize(text) == jtok.tokenize(text)
    ids = tok.encode(text)
    assert ids == jtok.encode(text)
    assert ids[0] == tok.ids["[CLS]"] and ids[-1] == tok.ids["[SEP]"]
    assert tok.convert_ids_to_tokens(ids) == jtok.convert_ids_to_tokens(ids)


def test_bert_wordpiece_and_from_pretrained(tmp_path, monkeypatch):
    vocab = BertTokenizer.SPECIALS + ["un", "##aff", "##able", "play",
                                      "##ing", ",", "!"]
    tok = BertTokenizer(vocab)
    assert tok.tokenize("Unaffable playing, [MASK]!") == [
        "un", "##aff", "##able", "play", "##ing", ",", "[MASK]", "!"]
    assert tok.tokenize("unplayable") == ["[UNK]"]
    _seed(tmp_path, "https://huggingface.co/tiny/bert/resolve/main/",
          {"vocab.txt": "\n".join(vocab).encode()}, monkeypatch)
    t2 = BertTokenizer.from_pretrained("tiny/bert")
    j2 = JBertTokenizer.from_pretrained("tiny/bert")
    assert t2.vocab == j2.vocab == vocab
    assert t2.encode("unaffable play") == j2.encode("unaffable play")
