"""Wikitext-2 word-level corpus.

Port of ``tq_tpu.data.wikitext`` (numpy only).  Tokenization: whitespace
split + '<eos>' appended per line; the dictionary is built by tokenizing
train, valid, test **in that order**, so word ids, and therefore any
pretrained checkpoint's embedding rows, depend on that order.

Looks for ``train.txt``/``valid.txt``/``test.txt`` under the given
directory or ``$TQ_DATA_DIR/wikitext-2``; falls back to the deterministic
Zipf-distributed synthetic streams the JAX package uses (vocab 33278,
seeds 7, 8 and 9), byte for byte.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from tq_tpu_torch.data.synthetic import synthetic_tokens

__all__ = ["Dictionary", "Corpus", "SyntheticCorpus", "load_corpus",
           "batchify"]

VOCAB = 33278  # Wikitext-2's word vocabulary


class Dictionary:
    def __init__(self):
        self.word2idx: dict[str, int] = {}
        self.idx2word: list = []

    def add_word(self, word: str) -> int:
        if word not in self.word2idx:
            self.idx2word.append(word)
            self.word2idx[word] = len(self.idx2word) - 1
        return self.word2idx[word]

    def __len__(self):
        return len(self.idx2word)


class Corpus:
    def __init__(self, path: str | Path):
        path = Path(path)
        self.dictionary = Dictionary()
        self.train = self._tokenize(path / "train.txt")
        self.valid = self._tokenize(path / "valid.txt")
        self.test = self._tokenize(path / "test.txt")

    def _tokenize(self, path: Path) -> np.ndarray:
        """Build the vocabulary and id-ify, line by line."""
        if not path.exists():
            return np.zeros((0,), np.int32)
        ids = []
        with open(path, encoding="utf8") as f:
            for line in f:
                for word in line.split() + ["<eos>"]:
                    ids.append(self.dictionary.add_word(word))
        return np.asarray(ids, np.int32)


class SyntheticCorpus:
    """The synthetic stand-in: token ids 0..33277 (the words are the ids)
    and Zipf streams of 200,000 / 20,000 / 20,000 tokens."""

    def __init__(self):
        self.dictionary = Dictionary()
        self.dictionary.idx2word = list(range(VOCAB))
        self.vocab = VOCAB
        self.train = synthetic_tokens(length=200000, seed=7)
        self.valid = synthetic_tokens(length=20000, seed=8)
        self.test = synthetic_tokens(length=20000, seed=9)


def load_corpus(data_dir: str | None = None):
    """(corpus, source): the real corpus ('real') if a directory holds
    ``test.txt``, else the synthetic one ('synthetic')."""
    roots = []
    if data_dir:
        roots.append(Path(data_dir))
    env = os.environ.get("TQ_DATA_DIR")
    if env:
        roots += [Path(env) / "wikitext-2", Path(env)]
    for root in roots:
        if (root / "test.txt").exists():
            return Corpus(root), "real"
    return SyntheticCorpus(), "synthetic"


def batchify(data: np.ndarray, bsz: int) -> np.ndarray:
    """(N,) -> (N//bsz, bsz): ``bsz`` contiguous streams, one per column."""
    nbatch = len(data) // bsz
    return data[: nbatch * bsz].reshape(bsz, nbatch).T.copy()
