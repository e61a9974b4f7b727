"""The offline hash tokenizer of randomly initialised pipelines: the port's
own copy of `HashTokenizer` (`geodiffuser_tpu_torch/models/tokenizer.py`).
It gives deterministic pseudo-ids in CLIP's padded layout ([bos] ids..
[eos] [eos]...).  The benchmark's weights are random, so the port never
loads CLIP's BPE vocabulary either.
"""

from __future__ import annotations

import re
from typing import Sequence

import numpy as np

MAX_LEN = 77


class HashTokenizer:
    """Deterministic ids for prompts: stable hashes of words."""

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
