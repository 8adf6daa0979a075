"""TF-IDF and Bag-of-Words vectorizers.

Parity with the reference `bagofwords/vectorizer/` (TfidfVectorizer,
BagOfWordsVectorizer — Lucene-index-backed there; plain in-memory here).

Port of deeplearning4j_tpu/nlp/tfidf.py: a host-only copy (it holds
no tensor).
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from .tokenization import DefaultTokenizerFactory, TokenizerFactory
from .vocab import VocabCache, VocabConstructor


class BaseTextVectorizer:
    def __init__(self, min_word_frequency: int = 1,
                 tokenizer: Optional[TokenizerFactory] = None):
        self.min_word_frequency = min_word_frequency
        self.tokenizer = tokenizer or DefaultTokenizerFactory()
        self.vocab: Optional[VocabCache] = None
        self._doc_freq: Optional[np.ndarray] = None
        self._n_docs = 0

    def fit(self, documents: List[str]):
        token_docs = [self.tokenizer.create(d).get_tokens() for d in documents]
        self.vocab = VocabConstructor(self.min_word_frequency).build_vocab(token_docs)
        V = self.vocab.num_words()
        df = np.zeros(V, np.int64)
        for doc in token_docs:
            seen = {self.vocab.index_of(t) for t in doc}
            for i in seen:
                if i >= 0:
                    df[i] += 1
        self._doc_freq = df
        self._n_docs = len(documents)
        return self

    def _counts(self, document: str) -> np.ndarray:
        v = np.zeros(self.vocab.num_words(), np.float32)
        for t in self.tokenizer.create(document).get_tokens():
            i = self.vocab.index_of(t)
            if i >= 0:
                v[i] += 1.0
        return v

    def transform(self, document: str) -> np.ndarray:
        raise NotImplementedError

    def transform_all(self, documents: List[str]) -> np.ndarray:
        return np.stack([self.transform(d) for d in documents])

    def fit_transform(self, documents: List[str]) -> np.ndarray:
        return self.fit(documents).transform_all(documents)


class BagOfWordsVectorizer(BaseTextVectorizer):
    """Raw term counts (reference BagOfWordsVectorizer)."""

    def transform(self, document: str) -> np.ndarray:
        return self._counts(document)


class TfidfVectorizer(BaseTextVectorizer):
    """tf * log(N/df) weighting (reference TfidfVectorizer)."""

    def idf(self, word: str) -> float:
        i = self.vocab.index_of(word)
        if i < 0 or self._doc_freq[i] == 0:
            return 0.0
        return math.log(self._n_docs / self._doc_freq[i])

    def tf_for(self, counts: np.ndarray) -> np.ndarray:
        total = counts.sum()
        return counts / total if total else counts

    def transform(self, document: str) -> np.ndarray:
        counts = self._counts(document)
        tf = self.tf_for(counts)
        with np.errstate(divide="ignore"):
            idf = np.log(np.maximum(self._n_docs, 1)
                         / np.maximum(self._doc_freq, 1)).astype(np.float32)
        return tf * idf
