"""Pure-Python SentencePiece model reader, writer and encoder.

Counterpart of ``lightgrad_tpu/utils/sentencepiece.py``, kept as the port's
own copy (the port imports nothing of the JAX package): the same
``SentencePieceModel``.  The LLaMA family ships its vocabulary as a
SentencePiece ``tokenizer.model`` protobuf; this module parses the
ModelProto wire format directly (the ``pieces`` list and the trainer's
``model_type``), writes it back (``to_bytes``), and implements the two
encoders:

* **BPE** (LLaMA): repeatedly merge the adjacent symbol pair whose
  concatenation is a vocab piece with the best (highest) score.
* **Unigram**: Viterbi segmentation maximizing the sum of piece log-probs.

Both use SentencePiece's text normalization convention: spaces become the
"lower one eighth block" marker (U+2581), a dummy prefix space is added, and
characters with no piece fall back to ``<0xNN>`` byte pieces when present.
No ``sentencepiece`` install is needed.
"""

import struct

__all__ = ["SentencePieceModel"]

_SPACE = "▁"

# piece types (sentencepiece_model.proto)
_NORMAL, _UNKNOWN, _CONTROL, _USER_DEFINED, _UNUSED, _BYTE = 1, 2, 3, 4, 5, 6


# ---------------------------------------------------------------------------
# minimal protobuf wire-format reader
# ---------------------------------------------------------------------------
def _read_varint(buf, pos):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf):
    """Yield (field_number, wire_type, value) over one message's fields."""
    pos, n = 0, len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # fixed64
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:  # fixed32
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_piece(buf):
    piece, score, ptype = "", 0.0, _NORMAL
    for field, wire, val in _fields(buf):
        if field == 1:
            piece = val.decode("utf-8")
        elif field == 2:
            score = struct.unpack("<f", val)[0]
        elif field == 3:
            ptype = val
    return piece, score, ptype


def _parse_model_type(trainer_buf):
    for field, wire, val in _fields(trainer_buf):
        if field == 3:
            return val  # 1 = UNIGRAM, 2 = BPE, 3 = WORD, 4 = CHAR
    return 1


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------
class SentencePieceModel:
    """Vocabulary + encoder loaded from ``tokenizer.model`` bytes."""

    UNIGRAM, BPE = 1, 2

    def __init__(self, pieces, model_type=BPE):
        """pieces: list of (piece, score, type) in vocab-id order."""
        self.pieces = [p for p, _, _ in pieces]
        self.scores = [s for _, s, _ in pieces]
        self.types = [t for _, _, t in pieces]
        self.model_type = model_type
        self.ids = {p: i for i, p in enumerate(self.pieces)}
        self.unk_id = next(
            (i for i, t in enumerate(self.types) if t == _UNKNOWN), 0)
        self._byte_ids = {}
        for i, (p, t) in enumerate(zip(self.pieces, self.types)):
            if t == _BYTE:
                self._byte_ids[int(p[1:-1], 16)] = i

    # -- construction ------------------------------------------------------
    @classmethod
    def from_bytes(cls, data: bytes):
        pieces, model_type = [], cls.UNIGRAM
        for field, wire, val in _fields(data):
            if field == 1:  # repeated SentencePiece
                pieces.append(_parse_piece(val))
            elif field == 2:  # TrainerSpec
                model_type = _parse_model_type(val)
        return cls(pieces, model_type)

    @classmethod
    def from_file(cls, path: str):
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())

    def __len__(self):
        return len(self.pieces)

    # -- encoding ----------------------------------------------------------
    def _normalize(self, text: str, add_prefix: bool = True):
        text = text.replace(" ", _SPACE)
        if add_prefix and not text.startswith(_SPACE):
            text = _SPACE + text
        return text

    def _bpe_encode(self, text: str):
        """Best-score-first pair merging (the LLaMA/SP-BPE scheme)."""
        syms = list(text)
        if not syms:
            return []
        while True:
            best, best_score = -1, -float("inf")
            for i in range(len(syms) - 1):
                merged = syms[i] + syms[i + 1]
                j = self.ids.get(merged)
                if j is not None and self.scores[j] > best_score:
                    best, best_score = i, self.scores[j]
            if best < 0:
                break
            syms[best:best + 2] = [syms[best] + syms[best + 1]]
        return syms

    def _viterbi_encode(self, text: str):
        """Optimal unigram segmentation by total log-prob."""
        n = len(text)
        best = [-float("inf")] * (n + 1)
        back = [0] * (n + 1)
        best[0] = 0.0
        max_len = max((len(p) for p in self.pieces), default=1)
        for end in range(1, n + 1):
            for start in range(max(0, end - max_len), end):
                if best[start] == -float("inf"):
                    continue
                j = self.ids.get(text[start:end])
                if j is None:
                    # single unknown char: allow with unk penalty
                    if end - start == 1:
                        score = best[start] - 100.0
                        if score > best[end]:
                            best[end], back[end] = score, start
                    continue
                score = best[start] + self.scores[j]
                if score > best[end]:
                    best[end], back[end] = score, start
        out, end = [], n
        while end > 0:
            start = back[end]
            out.append(text[start:end])
            end = start
        return out[::-1]

    def _piece_to_ids(self, piece: str):
        """One surface piece -> vocab id(s), with byte fallback."""
        j = self.ids.get(piece)
        if j is not None and self.types[j] != _UNKNOWN:
            return [j]
        if self._byte_ids:
            return [self._byte_ids.get(b, self.unk_id)
                    for b in piece.encode("utf-8")]
        return [self.unk_id]

    def encode(self, text: str, add_prefix: bool = True):
        text = self._normalize(text, add_prefix)
        segment = (self._bpe_encode if self.model_type == self.BPE
                   else self._viterbi_encode)
        ids = []
        for piece in segment(text):
            ids.extend(self._piece_to_ids(piece))
        return ids

    def decode(self, ids):
        out, byte_run = [], []

        def flush():
            if byte_run:
                out.append(bytes(byte_run).decode("utf-8", errors="replace"))
                byte_run.clear()

        for i in ids:
            t = self.types[i]
            if t == _BYTE:
                byte_run.append(int(self.pieces[i][1:-1], 16))
                continue
            flush()
            if t in (_CONTROL, _UNKNOWN):
                continue
            out.append(self.pieces[i])
        flush()
        return "".join(out).replace(_SPACE, " ").lstrip(" ")

    # -- serialization (testing / synthetic vocabularies) -------------------
    def to_bytes(self) -> bytes:
        """Serialize back to ModelProto wire format (round-trip support)."""
        def varint(x):
            out = bytearray()
            while True:
                b = x & 0x7F
                x >>= 7
                out.append(b | (0x80 if x else 0))
                if not x:
                    return bytes(out)

        def field(num, wire, payload):
            return varint(num << 3 | wire) + payload

        buf = bytearray()
        for piece, score, ptype in zip(self.pieces, self.scores, self.types):
            raw = piece.encode("utf-8")
            msg = (field(1, 2, varint(len(raw)) + raw)
                   + field(2, 5, struct.pack("<f", score))
                   + field(3, 0, varint(ptype)))
            buf += field(1, 2, varint(len(msg)) + msg)
        trainer = field(3, 0, varint(self.model_type))
        buf += field(2, 2, varint(len(trainer)) + trainer)
        return bytes(buf)
