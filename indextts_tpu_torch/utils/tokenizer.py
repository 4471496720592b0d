"""Text tokenizer: sentencepiece-compatible BPE without the sentencepiece
binary dependency.

Behavioural rebuild of the reference TextTokenizer
(indextts/utils/front.py:221-424).  Model resolution order:

1. a sentencepiece ``bpe.model`` file parsed directly (minimal protobuf
   reader for ModelProto: pieces + scores) → exact BPE merges;
2. a ``vocab.txt`` listing ``id: piece`` per line (the in-repo vocabulary
   dump) → greedy longest-match segmentation, which coincides with BPE for
   this vocab's dominant single-CJK-char + whole-word pieces.

The sentence splitter (`split_sentences_by_token`) reproduces the reference
algorithm exactly (front.py:341-424), including comma/hyphen/hard-length
fallbacks and short-sentence merging — it is the application-level
"long context" strategy (SURVEY.md §5).
"""

from __future__ import annotations

import heapq
import os
import re
import struct
import warnings
from typing import Dict, List, Optional, Tuple, Union

from indextts_tpu_torch.utils.textnorm import (
    TextNormalizer,
    de_tokenized_by_CJK_char,
    tokenize_by_CJK_char,
)

WORD_BOUNDARY = "▁"  # ▁


# ---------------------------------------------------------------------------
# sentencepiece ModelProto mini-parser
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:
        _, pos = _read_varint(buf, pos)
    elif wire_type == 1:
        pos += 8
    elif wire_type == 2:
        ln, pos = _read_varint(buf, pos)
        pos += ln
    elif wire_type == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire_type}")
    return pos


def parse_sentencepiece_model(path: str) -> List[Tuple[str, float, int]]:
    """Parse a sentencepiece model file into [(piece, score, type), ...].

    ModelProto: field 1 = repeated SentencePiece{1: piece, 2: score, 3: type}.
    Types: 1=NORMAL, 2=UNKNOWN, 3=CONTROL, 4=USER_DEFINED, 6=BYTE.
    """
    with open(path, "rb") as f:
        buf = f.read()
    pieces: List[Tuple[str, float, int]] = []
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:
            ln, pos = _read_varint(buf, pos)
            sub, end = buf[pos : pos + ln], pos + ln
            pos = end
            piece, score, ptype = "", 0.0, 1
            sp = 0
            while sp < len(sub):
                stag, sp = _read_varint(sub, sp)
                sfield, swire = stag >> 3, stag & 7
                if sfield == 1 and swire == 2:
                    sln, sp = _read_varint(sub, sp)
                    piece = sub[sp : sp + sln].decode("utf-8")
                    sp += sln
                elif sfield == 2 and swire == 5:
                    (score,) = struct.unpack("<f", sub[sp : sp + 4])
                    sp += 4
                elif sfield == 3 and swire == 0:
                    ptype, sp = _read_varint(sub, sp)
                else:
                    sp = _skip_field(sub, sp, swire)
            pieces.append((piece, score, ptype))
        else:
            pos = _skip_field(buf, pos, wire)
    return pieces


def parse_vocab_txt(path: str) -> List[Tuple[str, float, int]]:
    """Parse the in-repo ``vocab.txt`` dump (lines of ``id: piece``)."""
    pieces: List[Tuple[str, float, int]] = []
    pat = re.compile(r"^(\d+): (.*)$")
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            m = pat.match(line.rstrip("\n"))
            if not m:
                continue
            idx, piece = int(m.group(1)), m.group(2)
            assert idx == len(pieces), f"non-contiguous vocab id {idx}"
            ptype = 1
            if piece in ("<s>", "</s>"):
                ptype = 3
            elif piece == "<unk>":
                ptype = 2
            # longer pieces get higher merge priority under greedy matching;
            # score is synthetic (vocab.txt carries none)
            pieces.append((piece, -float(idx), ptype))
    return pieces


# ---------------------------------------------------------------------------
# BPE encoder
# ---------------------------------------------------------------------------

class BPEModel:
    def __init__(self, pieces: List[Tuple[str, float, int]], exact_scores: bool):
        self.pieces = pieces
        self.exact_scores = exact_scores
        self.piece_to_id: Dict[str, int] = {p: i for i, (p, _, _) in enumerate(pieces)}
        self.scores: Dict[str, float] = {p: s for (p, s, _) in pieces}
        self.unk_id = next(
            (i for i, (_, _, t) in enumerate(pieces) if t == 2), 0
        )
        self.max_piece_len = max((len(p) for p, _, t in pieces if t == 1), default=1)

    @classmethod
    def load(cls, path: str) -> "BPEModel":
        if path.endswith(".txt"):
            return cls(parse_vocab_txt(path), exact_scores=False)
        try:
            pieces = parse_sentencepiece_model(path)
            if pieces:
                return cls(pieces, exact_scores=True)
        except Exception:
            pass
        raise ValueError(f"cannot parse vocab/model file: {path}")

    # -- segmentation -----------------------------------------------------

    def _bpe_segment(self, text: str) -> List[str]:
        """Score-driven BPE merges (sentencepiece BPE semantics): repeatedly
        merge the adjacent symbol pair whose concatenation is an in-vocab
        piece with the highest score."""
        symbols = list(text)
        if not symbols:
            return []
        # doubly-linked list over symbol slots
        nxt = list(range(1, len(symbols) + 1))
        prv = list(range(-1, len(symbols)))
        alive = [True] * len(symbols)
        rev = 0
        heap: List[Tuple[float, int, int, int, str]] = []

        def push(i: int) -> None:
            j = nxt[i]
            if j >= len(symbols):
                return
            merged = symbols[i] + symbols[j]
            score = self.scores.get(merged)
            if score is not None:
                heapq.heappush(heap, (-score, i, rev, j, merged))

        for i in range(len(symbols) - 1):
            push(i)
        while heap:
            _, i, _, j, merged = heapq.heappop(heap)
            if not (alive[i] and alive[j]) or nxt[i] != j:
                continue
            if symbols[i] + symbols[j] != merged:
                continue
            symbols[i] = merged
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[i] < len(symbols):
                prv[nxt[i]] = i
            rev += 1
            push(i)
            if prv[i] >= 0:
                push(prv[i])
        out = []
        i = 0
        while i < len(symbols):
            if alive[i]:
                out.append(symbols[i])
                i = nxt[i]
            else:
                i += 1
        return out

    def _greedy_segment(self, text: str) -> List[str]:
        """Longest-prefix match (used when only vocab.txt is available)."""
        out: List[str] = []
        i, n = 0, len(text)
        while i < n:
            best = None
            for ln in range(min(self.max_piece_len, n - i), 0, -1):
                cand = text[i : i + ln]
                if cand in self.piece_to_id:
                    best = cand
                    break
            if best is None:
                out.append(text[i])
                i += 1
            else:
                out.append(best)
                i += len(best)
        return out

    def encode_as_pieces(self, text: str) -> List[str]:
        if not text:
            return []
        # sentencepiece default pre-processing: collapse whitespace, escape to
        # ▁, add dummy prefix
        text = re.sub(r"\s+", " ", text.strip())
        if not text:
            return []
        text = WORD_BOUNDARY + text.replace(" ", WORD_BOUNDARY)
        segment = self._bpe_segment if self.exact_scores else self._greedy_segment
        return segment(text)

    def piece_to_id_or_unk(self, piece: str) -> int:
        return self.piece_to_id.get(piece, self.unk_id)

    def id_to_piece(self, idx: int) -> str:
        return self.pieces[idx][0]

    def decode_pieces(self, pieces: List[str]) -> str:
        text = "".join(p for p in pieces if p not in ("<s>", "</s>", "<unk>"))
        return text.replace(WORD_BOUNDARY, " ").lstrip(" ")


# ---------------------------------------------------------------------------
# public tokenizer (reference: front.py:221-424)
# ---------------------------------------------------------------------------

class TextTokenizer:
    punctuation_marks_tokens = [".", "!", "?", "▁.", "▁?", "▁..."]

    def __init__(self, vocab_file: str, normalizer: Optional[TextNormalizer] = None):
        if vocab_file is None:
            raise ValueError("vocab_file not specified")
        if not os.path.exists(vocab_file):
            # fall back to sibling vocab.txt (reference ships it at repo root)
            alt = os.path.join(os.path.dirname(vocab_file), "vocab.txt")
            if os.path.exists(alt):
                vocab_file = alt
            else:
                raise ValueError(f"vocab file {vocab_file} does not exist")
        self.vocab_file = vocab_file
        self.normalizer = normalizer
        if self.normalizer:
            self.normalizer.load()
        self.model = BPEModel.load(vocab_file)
        self.pre_tokenizers = [tokenize_by_CJK_char]

    @property
    def vocab_size(self) -> int:
        return len(self.model.pieces)

    unk_token = "<unk>"
    pad_token = None
    bos_token = "<s>"
    eos_token = "</s>"
    pad_token_id = -1
    bos_token_id = 0
    eos_token_id = 1

    @property
    def unk_token_id(self) -> int:
        return self.model.unk_id

    def convert_ids_to_tokens(self, ids: Union[int, List[int]]):
        if isinstance(ids, int):
            return self.model.id_to_piece(ids)
        return [self.model.id_to_piece(i) for i in ids]

    def convert_tokens_to_ids(self, tokens: Union[str, List[str]]) -> List[int]:
        if isinstance(tokens, str):
            tokens = [tokens]
        return [self.model.piece_to_id_or_unk(t) for t in tokens]

    def tokenize(self, text: str) -> List[str]:
        return self.encode(text, out_type=str)

    def encode(self, text: str, out_type=int):
        if len(text) == 0:
            return []
        if len(text.strip()) == 1:
            pieces = self.model.encode_as_pieces(text)
        else:
            if self.normalizer:
                text = self.normalizer.normalize(text)
            for pre in self.pre_tokenizers:
                text = pre(text)
            pieces = self.model.encode_as_pieces(text)
        if out_type is str:
            return pieces
        return [self.model.piece_to_id_or_unk(p) for p in pieces]

    def batch_encode(self, texts: List[str], out_type=int):
        return [self.encode(t, out_type=out_type) for t in texts]

    def decode(self, ids: Union[int, List[int]], do_lower_case: bool = False) -> str:
        if isinstance(ids, int):
            ids = [ids]
        pieces = [self.model.id_to_piece(i) for i in ids]
        text = self.model.decode_pieces(pieces)
        return de_tokenized_by_CJK_char(text, do_lower_case=do_lower_case)

    # -- sentence splitting (reference: front.py:341-424) ------------------

    @staticmethod
    def split_sentences_by_token(
        tokenized_str: List[str],
        split_tokens: List[str],
        max_tokens_per_sentence: int,
    ) -> List[List[str]]:
        if len(tokenized_str) == 0:
            return []
        sentences: List[List[str]] = []
        current_sentence: List[str] = []
        current_len = 0
        for i in range(len(tokenized_str)):
            token = tokenized_str[i]
            current_sentence.append(token)
            current_len += 1
            if current_len <= max_tokens_per_sentence:
                if token in split_tokens and current_len > 2:
                    if i < len(tokenized_str) - 1 and tokenized_str[i + 1] in ("'", "▁'"):
                        current_sentence.append(tokenized_str[i + 1])
                    sentences.append(current_sentence)
                    current_sentence = []
                    current_len = 0
                continue
            # over-length: force split
            if not ("," in split_tokens or "▁," in split_tokens) and (
                "," in current_sentence or "▁," in current_sentence
            ):
                sub = TextTokenizer.split_sentences_by_token(
                    current_sentence, [",", "▁,"], max_tokens_per_sentence
                )
            elif "-" not in split_tokens and "-" in current_sentence:
                sub = TextTokenizer.split_sentences_by_token(
                    current_sentence, ["-"], max_tokens_per_sentence
                )
            else:
                sub = []
                for j in range(0, len(current_sentence), max_tokens_per_sentence):
                    sub.append(current_sentence[j : j + max_tokens_per_sentence])
                warnings.warn(
                    f"sentence exceeds {max_tokens_per_sentence} tokens; hard split",
                    RuntimeWarning,
                )
            sentences.extend(sub)
            current_sentence = []
            current_len = 0
        if current_len > 0:
            sentences.append(current_sentence)
        # merge short neighbours
        merged: List[List[str]] = []
        for sentence in sentences:
            if not sentence:
                continue
            if merged and len(merged[-1]) + len(sentence) <= max_tokens_per_sentence:
                merged[-1] = merged[-1] + sentence
            elif not merged:
                merged.append(sentence)
            else:
                merged.append(sentence)
        return merged

    def split_sentences(
        self, tokenized: List[str], max_tokens_per_sentence: int = 120
    ) -> List[List[str]]:
        return self.split_sentences_by_token(
            tokenized, self.punctuation_marks_tokens, max_tokens_per_sentence
        )
