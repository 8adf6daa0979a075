"""In-memory inverted index (reference `text/invertedindex/InvertedIndex.java`
+ LuceneInvertedIndex: word -> documents postings consulted by the
bagofwords vectorizers and sampling-based trainers).

The reference embeds Lucene; the capability that matters to the framework —
postings, document frequencies, batch iteration over docs containing a word,
index-backed TF-IDF — is a data structure, implemented here directly.

Port of deeplearning4j_tpu/nlp/invertedindex.py: a host-only copy (it holds
no tensor).
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


class InvertedIndex:
    def __init__(self):
        self._docs: List[List[str]] = []
        self._labels: List[Optional[str]] = []
        self._postings: Dict[str, List[int]] = defaultdict(list)
        self._doc_freq: Dict[str, int] = defaultdict(int)

    # -- build -----------------------------------------------------------------
    def add_document(self, tokens: Sequence[str],
                     label: Optional[str] = None) -> int:
        doc_id = len(self._docs)
        tokens = list(tokens)
        self._docs.append(tokens)
        self._labels.append(label)
        for w in set(tokens):
            self._postings[w].append(doc_id)
            self._doc_freq[w] += 1
        return doc_id

    # -- query (reference InvertedIndex interface) -----------------------------
    def num_documents(self) -> int:
        return len(self._docs)

    def document(self, doc_id: int) -> List[str]:
        return self._docs[doc_id]

    def document_label(self, doc_id: int) -> Optional[str]:
        return self._labels[doc_id]

    def documents(self, word: str) -> List[int]:
        """Posting list: ids of documents containing `word`."""
        return list(self._postings.get(word, ()))

    def doc_frequency(self, word: str) -> int:
        return self._doc_freq.get(word, 0)

    def terms(self) -> List[str]:
        return sorted(self._postings)

    def doc_appeared_in_percent(self, word: str) -> float:
        n = self.num_documents()
        return self.doc_frequency(word) / n if n else 0.0

    def tfidf(self, word: str, doc_id: int) -> float:
        """Index-backed tf-idf (the quantity the reference's
        TfidfVectorizer pulls from its Lucene index)."""
        doc = self._docs[doc_id]
        if not doc:
            return 0.0
        tf = doc.count(word) / len(doc)
        df = self.doc_frequency(word)
        if df == 0:
            return 0.0
        idf = math.log((1 + self.num_documents()) / (1 + df)) + 1.0
        return tf * idf

    def batch_iter(self, batch_size: int) -> Iterable[List[Tuple[int, List[str]]]]:
        """Iterate documents in batches (reference batchDocs iterator used
        by index-fed trainers)."""
        batch = []
        for i, doc in enumerate(self._docs):
            batch.append((i, doc))
            if len(batch) >= batch_size:
                yield batch
                batch = []
        if batch:
            yield batch
