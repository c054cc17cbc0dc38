"""Port parity: the SentencePiece reader / writer / encoders
(``utils/sentencepiece.py``) and ``LlamaTokenizer``.

The synthetic models of tests/test_tokenizers.py -- a LLaMA-style BPE
vocabulary (specials, 256 byte pieces, scored merges) and a unigram one --
built by each package: the same ids and decoded text for each text (byte
fallback included), the unigram Viterbi segmentation, ``to_bytes``
byte-identical, each package reading the other's bytes, and
``LlamaTokenizer``'s BOS / EOS handling and ``from_file`` /
``from_pretrained`` (from a pre-seeded cache, no network).  Exact
equality throughout.
"""

import hashlib

import pytest

from lightgrad_tpu.models import LlamaTokenizer as JTokenizer
from lightgrad_tpu.utils.sentencepiece import SentencePieceModel as JSP
from lightgrad_tpu_torch.models import LlamaTokenizer
from lightgrad_tpu_torch.utils.sentencepiece import SentencePieceModel

_SP = "▁"
TEXTS = ["hello", "world", "hello world", "hello hello", "we", "hé",
         "héllo wörld", "", "  two  spaces", "中文"]


def _bpe_pieces():
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    pieces += [(f"<0x{b:02X}>", 0.0, 6) for b in range(256)]
    for piece, score in [
        (_SP, -1.0), ("h", -2.0), ("e", -2.1), ("l", -2.2), ("o", -2.3),
        ("he", -3.0), ("ll", -3.1), ("hell", -4.0), ("hello", -5.0),
        (_SP + "hello", -5.5), ("w", -2.4), ("or", -3.2), ("orl", -4.5),
        ("orld", -6.0), (_SP + "w", -3.5),
    ]:
        pieces.append((piece, score, 1))
    return pieces


def _unigram_pieces():
    return [("<unk>", 0.0, 2)] + [(p, s, 1) for p, s in [
        (_SP, -1.0), ("a", -3.0), ("b", -3.0), ("ab", -4.0), ("ba", -7.0)]]


MODELS = {"bpe": (_bpe_pieces, "BPE"), "unigram": (_unigram_pieces,
                                                   "UNIGRAM")}


def _pair(kind):
    pieces, mtype = MODELS[kind]
    return (SentencePieceModel(pieces(), getattr(SentencePieceModel, mtype)),
            JSP(pieces(), getattr(JSP, mtype)))


@pytest.mark.parametrize("kind", list(MODELS))
def test_models_match_jax(kind):
    tsp, jsp = _pair(kind)
    # the wire format: byte-identical, and each reads the other's bytes
    assert tsp.to_bytes() == jsp.to_bytes()
    read = (SentencePieceModel.from_bytes(jsp.to_bytes()),
            JSP.from_bytes(tsp.to_bytes()))
    for sp in read:
        assert sp.pieces == tsp.pieces and sp.types == tsp.types
        assert sp.model_type == tsp.model_type
    # scores travel as float32
    assert read[0].scores == read[1].scores
    texts = TEXTS if kind == "bpe" else ["abab", "ba", "aab b"]
    for text in texts:
        for add_prefix in (True, False):
            ids = tsp.encode(text, add_prefix=add_prefix)
            assert ids == jsp.encode(text, add_prefix=add_prefix), text
            assert tsp.decode(ids) == jsp.decode(ids)
    if kind == "bpe":
        # byte fallback: an unknown character as its utf-8 byte pieces
        ids = tsp.encode("hé")
        assert [tsp.pieces[i] for i in ids] == [_SP, "h", "<0xC3>",
                                                "<0xA9>"]
        assert tsp.decode(ids) == "hé"
        assert [tsp.pieces[i] for i in tsp.encode("hello")] == [
            _SP + "hello"]
    else:
        # Viterbi: ab + ab (-8) over a + ba + b (-13)
        assert [tsp.pieces[i] for i in tsp.encode(
            "abab", add_prefix=False)] == ["ab", "ab"]


def test_llama_tokenizer_matches_jax(tmp_path, monkeypatch):
    """BOS on encode, BOS / EOS dropped on decode, the vocabulary size, and
    ``from_file`` / ``from_pretrained`` (the file under md5(url) in
    ``LIGHTGRAD_CACHE``) reading the JAX package's bytes."""
    tsp, jsp = _pair("bpe")
    tok, jtok = LlamaTokenizer(tsp), JTokenizer(jsp)
    for text in TEXTS:
        ids = tok.encode(text)
        assert ids == jtok.encode(text) and ids[0] == tok.bos_id == 1
        assert tok.encode(text, bos=False) == ids[1:]
        assert tok.decode(ids + [tok.eos_id]) == jtok.decode(
            ids + [jtok.eos_id])
    assert tok.decode(tok.encode("hello world")) == "hello world"
    assert tok.vocab_size == jtok.vocab_size == len(tsp)
    path = tmp_path / "tokenizer.model"
    path.write_bytes(jsp.to_bytes())
    assert LlamaTokenizer.from_file(str(path)).encode("héllo") == \
        jtok.encode("héllo")
    url = "https://huggingface.co/tiny/llama/resolve/main/tokenizer.model"
    (tmp_path / hashlib.md5(url.encode()).hexdigest()).write_bytes(
        jsp.to_bytes())
    monkeypatch.setenv("LIGHTGRAD_CACHE", str(tmp_path))
    assert LlamaTokenizer.from_pretrained("tiny/llama").encode(
        "hello world") == jtok.encode("hello world")
