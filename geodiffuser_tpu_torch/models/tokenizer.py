"""CLIP's byte-level BPE tokenizer and the offline hash tokenizer: the
port's own copy of `geodiffuser_tpu/models/tokenizer.py`.

`CLIPTokenizer` is the BPE of the HF CLIPTokenizer the reference uses
(editor.py:106-112: vocab 49408, lowercasing, whitespace collapsing, the
`</w>` word-end convention) loaded from a local `vocab.json` and
`merges.txt`.  Without those files `HashTokenizer` gives deterministic
pseudo-ids in the same padded layout ([bos] ids.. [eos] [eos]...), for
randomly initialised pipelines.
"""

from __future__ import annotations

import json
import os
import re
from functools import lru_cache
from typing import List, Sequence

import numpy as np

BOS = 49406
EOS = 49407
MAX_LEN = 77

# The canonical CLIP pattern uses \p{L}/\p{N} classes; python `re` lacks
# them, so we use the close \w-based approximation below.
_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|\w+|[^\s\w]+",
    re.UNICODE,
)


@lru_cache()
def _bytes_to_unicode():
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class CLIPTokenizer:
    """BPE tokenizer loading vocab/merges from a local directory."""

    def __init__(self, vocab_path: str, merges_path: str, max_length: int = MAX_LEN):
        with open(vocab_path) as f:
            self.encoder = json.load(f)
        with open(merges_path) as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges if m and not m.startswith("#version")]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = _bytes_to_unicode()
        self.max_length = max_length
        self.bos = self.encoder.get("<|startoftext|>", BOS)
        self.eos = self.encoder.get("<|endoftext|>", EOS)
        self._cache = {}

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return [token + "</w>"]
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word, i = [], 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        self._cache[token] = list(word)
        return list(word)

    def encode(self, text: str) -> List[int]:
        text = re.sub(r"\s+", " ", text.lower().strip())
        ids: List[int] = []
        for tok in _PAT.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok) if t in self.encoder)
        return ids

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        out = np.full((len(texts), self.max_length), self.eos, np.int32)
        for i, t in enumerate(texts):
            ids = [self.bos] + self.encode(t)[: self.max_length - 2] + [self.eos]
            out[i, : len(ids)] = ids
        return out


class HashTokenizer:
    """Deterministic fallback when no vocab files exist; ids are stable
    hashes of words."""

    def __init__(self, vocab_size: int = 49408, max_length: int = MAX_LEN):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.bos = vocab_size - 2
        self.eos = vocab_size - 1

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        out = np.full((len(texts), self.max_length), self.eos, np.int32)
        for i, t in enumerate(texts):
            words = re.findall(r"\w+|[^\s\w]", t.lower())
            body = [
                (int.from_bytes(w.encode(), "little") * 2654435761) % (self.vocab_size - 3)
                for w in words
            ][: self.max_length - 2]
            ids = [self.bos] + body + [self.eos]
            out[i, : len(ids)] = ids
        return out


def load_tokenizer(checkpoint_dir: str | None = None, vocab_size: int = 49408,
                   max_length: int = MAX_LEN):
    """CLIPTokenizer when `<checkpoint_dir>/tokenizer/{vocab.json,merges.txt}`
    exist, else HashTokenizer."""
    if checkpoint_dir:
        tok_dir = os.path.join(checkpoint_dir, "tokenizer")
        vocab = os.path.join(tok_dir, "vocab.json")
        merges = os.path.join(tok_dir, "merges.txt")
        if os.path.exists(vocab) and os.path.exists(merges):
            return CLIPTokenizer(vocab, merges, max_length)
    return HashTokenizer(vocab_size, max_length)
