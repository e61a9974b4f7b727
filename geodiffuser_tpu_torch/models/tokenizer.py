"""Offline tokenizer: the port's own copy of the JAX package's
`HashTokenizer` (geodiffuser_tpu/models/tokenizer.py:120-153).

Same padded CLIP layout ([bos] ids.. [eos] [eos]...); ids are stable hashes
of words.  Loading CLIP's BPE vocabulary comes with checkpoint loading, in a
later slice.
"""

from __future__ import annotations

import re
from typing import Sequence

import numpy as np

MAX_LEN = 77


class HashTokenizer:
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


def load_tokenizer(vocab_size: int = 49408, max_length: int = MAX_LEN) -> HashTokenizer:
    """The tokenizer of a randomly initialised pipeline."""
    return HashTokenizer(vocab_size, max_length)
