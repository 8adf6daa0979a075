"""Vocabulary: VocabWord, VocabCache, VocabConstructor, Huffman coding.

Parity with the reference `models/word2vec/wordstore/` (VocabCache SPI,
InMemoryLookupCache/AbstractCache, VocabConstructor) and
`models/word2vec/Huffman.java` (hierarchical-softmax code/point assignment).

Port of deeplearning4j_tpu/nlp/vocab.py: a host-only copy. `build_huffman`
breaks heap ties as JAX's does (by ``uid``, then `id_key`), so the codes
and points, by which hierarchic softmax indexes syn1, are JAX's.
"""
from __future__ import annotations

import heapq
from collections import Counter
from typing import Dict, Iterable, List, Optional


class VocabWord:
    """Reference models/word2vec/VocabWord."""

    __slots__ = ("word", "count", "index", "codes", "points")

    def __init__(self, word: str, count: int = 1, index: int = -1):
        self.word = word
        self.count = count
        self.index = index
        self.codes: List[int] = []   # Huffman code bits
        self.points: List[int] = []  # inner-node indices

    def __repr__(self):
        return f"VocabWord({self.word!r}, count={self.count}, index={self.index})"


class VocabCache:
    """In-memory vocab store (reference AbstractCache/InMemoryLookupCache)."""

    def __init__(self):
        self._words: Dict[str, VocabWord] = {}
        self._by_index: List[VocabWord] = []
        self.total_word_count = 0

    def add_token(self, word: str, count: int = 1):
        vw = self._words.get(word)
        if vw is None:
            vw = VocabWord(word, 0)
            self._words[word] = vw
        vw.count += count
        self.total_word_count += count

    def finalize_vocab(self, min_word_frequency: int = 1):
        """Drop rare words, assign indices by descending frequency."""
        kept = [vw for vw in self._words.values() if vw.count >= min_word_frequency]
        kept.sort(key=lambda v: (-v.count, v.word))
        self._words = {v.word: v for v in kept}
        self._by_index = kept
        for i, vw in enumerate(kept):
            vw.index = i

    def contains_word(self, word: str) -> bool:
        return word in self._words

    def word_for(self, word: str) -> Optional[VocabWord]:
        return self._words.get(word)

    def index_of(self, word: str) -> int:
        vw = self._words.get(word)
        return vw.index if vw else -1

    def word_at_index(self, idx: int) -> Optional[str]:
        return self._by_index[idx].word if 0 <= idx < len(self._by_index) else None

    def vocab_words(self) -> List[VocabWord]:
        return list(self._by_index)

    def num_words(self) -> int:
        return len(self._by_index)

    def word_frequency(self, word: str) -> int:
        vw = self._words.get(word)
        return vw.count if vw else 0


class VocabConstructor:
    """Scan sequences -> counts -> finalized VocabCache
    (reference vocabulary/VocabConstructor; the parallel scan becomes a
    single-pass Counter — vocab building is host-side work)."""

    def __init__(self, min_word_frequency: int = 1):
        self.min_word_frequency = min_word_frequency

    def build_vocab(self, token_sequences: Iterable[List[str]]) -> VocabCache:
        cache = VocabCache()
        counts: Counter = Counter()
        total = 0
        for seq in token_sequences:
            counts.update(seq)
            total += len(seq)
        for word, count in counts.items():
            vw = VocabWord(word, count)
            cache._words[word] = vw
        cache.total_word_count = total
        cache.finalize_vocab(self.min_word_frequency)
        return cache


def build_huffman(cache: VocabCache) -> None:
    """Assign Huffman codes/points to every vocab word
    (reference models/word2vec/Huffman.java). Inner-node ids are 0..n-2."""
    words = cache.vocab_words()
    n = len(words)
    if n == 0:
        return
    # heap of (count, uid, node); node = (word_idx | None, children)
    heap = []
    uid = 0
    for vw in words:
        heap.append((vw.count, uid, ("leaf", vw.index)))
        uid += 1
    heapq.heapify(heap)
    inner_id = 0
    parent: Dict[tuple, tuple] = {}
    while len(heap) > 1:
        c1, _, n1 = heapq.heappop(heap)
        c2, _, n2 = heapq.heappop(heap)
        node = ("inner", inner_id)
        parent[id_key(n1)] = (node, 0)
        parent[id_key(n2)] = (node, 1)
        inner_id += 1
        heapq.heappush(heap, (c1 + c2, uid, node))
        uid += 1
    for vw in words:
        codes: List[int] = []
        points: List[int] = []
        node = ("leaf", vw.index)
        while id_key(node) in parent:
            par, bit = parent[id_key(node)]
            codes.append(bit)
            points.append(par[1])
            node = par
        vw.codes = list(reversed(codes))
        vw.points = list(reversed(points))


def id_key(node: tuple) -> tuple:
    return node
