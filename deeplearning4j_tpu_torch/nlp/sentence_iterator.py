"""Sentence/document iteration SPI.

Parity with the reference `text/sentenceiterator/` (SentenceIterator,
BasicLineIterator, CollectionSentenceIterator, FileSentenceIterator,
LineSentenceIterator, label-aware variants) and `text/documentiterator/`.

Port of deeplearning4j_tpu/nlp/sentence_iterator.py: a host-only copy (it holds
no tensor).
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterable, List, Optional


class SentencePreProcessor:
    def pre_process(self, sentence: str) -> str:
        raise NotImplementedError


class SentenceIterator:
    """Reference text/sentenceiterator/SentenceIterator."""

    def __init__(self):
        self._pre: Optional[SentencePreProcessor] = None

    def set_pre_processor(self, pre: SentencePreProcessor):
        self._pre = pre
        return self

    def _apply(self, s: str) -> str:
        return self._pre.pre_process(s) if self._pre else s

    def next_sentence(self) -> Optional[str]:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next_sentence()


class CollectionSentenceIterator(SentenceIterator):
    def __init__(self, sentences: Iterable[str]):
        super().__init__()
        self._sentences = list(sentences)
        self._idx = 0

    def next_sentence(self):
        s = self._sentences[self._idx]
        self._idx += 1
        return self._apply(s)

    def has_next(self):
        return self._idx < len(self._sentences)

    def reset(self):
        self._idx = 0


class BasicLineIterator(SentenceIterator):
    """One sentence per line from a file (reference BasicLineIterator)."""

    def __init__(self, path):
        super().__init__()
        self._path = Path(path)
        self._fh = None
        self._next_line: Optional[str] = None
        self.reset()

    def _advance(self):
        line = self._fh.readline()
        self._next_line = line.rstrip("\n") if line else None

    def next_sentence(self):
        s = self._next_line
        self._advance()
        return self._apply(s)

    def has_next(self):
        return self._next_line is not None

    def reset(self):
        if self._fh:
            self._fh.close()
        self._fh = open(self._path, "r", encoding="utf-8", errors="replace")
        self._advance()


class LabelAwareSentenceIterator(SentenceIterator):
    """Sentence + current label (reference labelaware variants)."""

    def current_label(self) -> str:
        raise NotImplementedError


class LabelledCollectionSentenceIterator(LabelAwareSentenceIterator):
    def __init__(self, sentences: List[str], labels: List[str]):
        super().__init__()
        assert len(sentences) == len(labels)
        self._sentences = sentences
        self._labels = labels
        self._idx = 0

    def next_sentence(self):
        s = self._sentences[self._idx]
        self._idx += 1
        return self._apply(s)

    def has_next(self):
        return self._idx < len(self._sentences)

    def reset(self):
        self._idx = 0

    def current_label(self):
        return self._labels[max(0, self._idx - 1)]
