"""SentencePiece-style greedy-bigram tokenizer.

Re-implementation of llama_tokenizer (llama.cpp:1655-1802): split text into
UTF-8 characters, then repeatedly merge the adjacent pair whose merged string
is the vocab token with the highest score (ties: leftmost), emitting byte
fallback tokens (id = byte + 3) for anything left over.  Vocab entries carry
scores from the model file; "▁" was already replaced by a literal space at
conversion time (convert.py:239).  All five reference architectures clone
this tokenizer, so one implementation serves them all here too.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

TOKEN_UNK = 0
TOKEN_BOS = 1
TOKEN_EOS = 2


_UTF8_LEN = [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 3, 4]


def _utf8_len(b: int) -> int:
    """llama-util.h utf8_len: length from the high nibble of the lead byte."""
    return _UTF8_LEN[b >> 4]


@dataclass
class Vocab:
    tokens: list[bytes]
    scores: list[float]

    def __post_init__(self):
        self.token_to_id = {t: i for i, t in enumerate(self.tokens)}

    @property
    def n_vocab(self) -> int:
        return len(self.tokens)

    @staticmethod
    def from_ggjt(gf) -> "Vocab":
        return Vocab([w for w, _ in gf.vocab], [s for _, s in gf.vocab])

    def id_to_text(self, tid: int) -> bytes:
        return self.tokens[tid]


class Tokenizer:
    def __init__(self, vocab: Vocab, use_native: bool | None = None):
        """use_native None or True: the C++ tokenizer (native/) when it is
        built, which gives the same ids; False: always the Python one."""
        self.vocab = vocab
        self._native = None
        if use_native is not False:
            from .. import native

            if native.available():
                self._native = native.NativeVocab(vocab.tokens, vocab.scores)

    def tokenize(self, text: str | bytes, bos: bool = False) -> list[int]:
        if isinstance(text, str):
            text = text.encode("utf-8")
        if not text:
            # empty input returns NO tokens, not even BOS — the reference
            # early-returns before the bos push (llama.cpp:1788-1790)
            return []
        if self._native is not None:
            return self._native.tokenize(bytes(text), bos)
        out: list[int] = []
        if bos:
            out.append(TOKEN_BOS)

        # split into utf-8 characters (doubly-linked symbol list)
        sym_text: list[bytes] = []
        offs = 0
        while offs < len(text):
            n = min(len(text) - offs, _utf8_len(text[offs]))
            sym_text.append(text[offs : offs + n])
            offs += n
        n_sym = len(sym_text)
        prev = list(range(-1, n_sym - 1))
        nxt = [i + 1 for i in range(n_sym)]
        nxt[-1] = -1
        length = [len(s) for s in sym_text]  # 0 = merged away

        t2i = self.vocab.token_to_id
        scores = self.vocab.scores
        heap: list[tuple[float, int, int, int]] = []

        def try_add(left: int, right: int):
            if left == -1 or right == -1:
                return
            merged = sym_text[left] + sym_text[right]
            tid = t2i.get(merged)
            if tid is None or tid >= self.vocab.n_vocab:
                return
            # C++ priority_queue: max score first, ties -> smallest left index
            heapq.heappush(heap, (-scores[tid], left, right, len(merged)))

        for i in range(1, n_sym):
            try_add(i - 1, i)

        while heap:
            _, left, right, size = heapq.heappop(heap)
            if length[left] == 0 or length[right] == 0 or length[left] + length[right] != size:
                continue
            sym_text[left] = sym_text[left] + sym_text[right]
            length[left] += length[right]
            length[right] = 0
            nxt[left] = nxt[right]
            if nxt[right] >= 0:
                prev[nxt[right]] = left
            try_add(prev[left], left)
            try_add(left, nxt[left])

        i = 0
        while i != -1:
            tid = t2i.get(sym_text[i])
            if tid is None:
                for byte in sym_text[i]:
                    out.append(byte + 3)
            else:
                out.append(tid)
            i = nxt[i]
        return out

    def detokenize(self, ids: list[int]) -> bytes:
        parts = []
        for tid in ids:
            if 3 <= tid < 259 and len(self.vocab.tokens[tid]) == 0:
                parts.append(bytes([tid - 3]))
            else:
                parts.append(self.vocab.tokens[tid])
        return b"".join(parts)

    def token_text(self, tid: int) -> bytes:
        """llama_token_to_str for a single id."""
        return self.vocab.tokens[tid]
