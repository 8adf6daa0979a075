"""Disk-backed inverted index: corpus-scale postings with bounded memory.

Capability parity with the reference's Lucene-backed index
(`deeplearning4j-scaleout/deeplearning4j-nlp/src/main/java/org/deeplearning4j/text/invertedindex/LuceneInvertedIndex.java`):
the reference embeds Lucene to keep million-document corpora OUT of heap —
postings and stored documents live on disk, only the term dictionary stays
resident. This module implements the same storage discipline directly,
with the InvertedIndex duck-type the bagofwords/TF-IDF vectorizers consume
(`nlp/invertedindex.py`, `nlp/tfidf.py`):

  - **document store**: append-only `docs.dat` (length-prefixed UTF-8
    token rows + optional label), offsets in `docs.idx` — O(1) seek per
    document, nothing resident but the offset/length arrays
    (16 bytes/doc).
  - **postings**: buffered in RAM up to ``flush_every`` entries, then
    SPILLED as a term-sorted segment file (Lucene's indexing chain);
    ``commit()`` k-way-merges the segments into one `postings.dat` plus a
    resident term dictionary {term -> (offset, df)} — memory scales with
    VOCABULARY, not corpus (the Lucene FST trade).
  - postings store (doc_id, term_count) u32 pairs, so TF-IDF scoring reads
    postings only; per-doc lengths are a resident u32 array.

Port of deeplearning4j_tpu/nlp/diskindex.py: a host-only copy, a text
subsystem on the host (the reference runs Lucene on Spark's executors,
not the GPU). The on-disk layout is the JAX package's, so an index
written by either package opens in the other.
"""
from __future__ import annotations

import heapq
import math
import os
import struct
from array import array
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_U32 = struct.Struct("<I")
_REC = struct.Struct("<II")  # (doc_id, term_count)


class DiskInvertedIndex:
    """One-shot build (add_document* -> commit()) then query; ``open()``
    re-attaches to a committed index. The query surface matches
    nlp/invertedindex.InvertedIndex so the TF-IDF/bagofwords stack can use
    either interchangeably."""

    def __init__(self, directory: str, flush_every: int = 2_000_000):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.flush_every = int(flush_every)
        self._doc_off = array("Q")   # offset of each doc row in docs.dat
        self._doc_len = array("I")   # token count per doc (TF denominators)
        self._docs_f = open(os.path.join(directory, "docs.dat"), "wb")
        self._docs_pos = 0
        # postings buffer: term -> (array of doc ids, array of counts)
        self._buf: Dict[str, Tuple[array, array]] = defaultdict(
            lambda: (array("I"), array("I")))
        self._buffered = 0
        self._segments: List[str] = []
        self._terms: Optional[Dict[str, Tuple[int, int]]] = None
        self._post_f = None

    # -- build -----------------------------------------------------------------
    def add_document(self, tokens: Sequence[str],
                     label: Optional[str] = None) -> int:
        if self._terms is not None:
            raise RuntimeError("index is committed; open a new directory "
                               "to index more documents")
        doc_id = len(self._doc_off)
        row = ("\x1f".join(tokens) + "\x1e" + (label or "")).encode()
        self._docs_f.write(_U32.pack(len(row)) + row)
        self._doc_off.append(self._docs_pos)
        self._docs_pos += _U32.size + len(row)
        self._doc_len.append(len(tokens))
        counts: Dict[str, int] = {}
        for w in tokens:
            counts[w] = counts.get(w, 0) + 1
        for w, c in counts.items():
            ids, cnts = self._buf[w]
            ids.append(doc_id)
            cnts.append(c)
        self._buffered += len(counts)
        if self._buffered >= self.flush_every:
            self._spill()
        return doc_id

    def _spill(self) -> None:
        if not self._buffered:
            return
        path = os.path.join(self.dir, f"seg-{len(self._segments):05d}.dat")
        with open(path, "wb") as f:
            for term in sorted(self._buf):
                ids, cnts = self._buf[term]
                tb = term.encode()
                f.write(_U32.pack(len(tb)) + tb + _U32.pack(len(ids)))
                rec = array("I")
                for i, c in zip(ids, cnts):
                    rec.append(i)
                    rec.append(c)
                f.write(rec.tobytes())
        self._segments.append(path)
        self._buf.clear()
        self._buffered = 0

    @staticmethod
    def _read_segment(path: str):
        """Yield (term, bytes_of_id_count_pairs) in term-sorted order."""
        with open(path, "rb") as f:
            while True:
                hdr = f.read(_U32.size)
                if len(hdr) < _U32.size:
                    return
                tlen, = _U32.unpack(hdr)
                term = f.read(tlen).decode()
                n, = _U32.unpack(f.read(_U32.size))
                yield term, f.read(n * _REC.size)

    def commit(self) -> "DiskInvertedIndex":
        """Merge spilled segments into postings.dat + the resident term
        dictionary, and persist docs.idx / terms.dat for reopen."""
        if self._terms is not None:
            return self
        self._spill()
        self._docs_f.flush()
        os.fsync(self._docs_f.fileno())
        self._docs_f.close()
        terms: Dict[str, Tuple[int, int]] = {}
        post_path = os.path.join(self.dir, "postings.dat")
        streams = [self._read_segment(p) for p in self._segments]
        with open(post_path, "wb") as out:
            pos = 0
            # k-way merge; segments were written in chronological order, so
            # concatenating a term's runs keeps doc ids ascending
            merged = heapq.merge(
                *[((t, si, blob) for t, blob in s)
                  for si, s in enumerate(streams)],
                key=lambda r: (r[0], r[1]))
            cur_term, chunks = None, []
            for term, _si, blob in merged:
                if term != cur_term:
                    if cur_term is not None:
                        data = b"".join(chunks)
                        out.write(data)
                        terms[cur_term] = (pos, len(data) // _REC.size)
                        pos += len(data)
                    cur_term, chunks = term, []
                chunks.append(blob)
            if cur_term is not None:
                data = b"".join(chunks)
                out.write(data)
                terms[cur_term] = (pos, len(data) // _REC.size)
        with open(os.path.join(self.dir, "terms.dat"), "wb") as f:
            for term, (off, df) in terms.items():
                tb = term.encode()
                f.write(_U32.pack(len(tb)) + tb
                        + struct.pack("<QI", off, df))
        with open(os.path.join(self.dir, "docs.idx"), "wb") as f:
            f.write(_U32.pack(len(self._doc_off)))
            f.write(self._doc_off.tobytes())
            f.write(self._doc_len.tobytes())
        for p in self._segments:
            os.unlink(p)
        self._segments = []
        self._terms = terms
        self._post_f = open(post_path, "rb")
        self._docs_r = open(os.path.join(self.dir, "docs.dat"), "rb")
        return self

    @classmethod
    def open(cls, directory: str) -> "DiskInvertedIndex":
        """Attach to a committed index (restart path)."""
        self = cls.__new__(cls)
        self.dir = directory
        self._segments = []
        self._buf = {}
        self._buffered = 0
        with open(os.path.join(directory, "docs.idx"), "rb") as f:
            n, = _U32.unpack(f.read(_U32.size))
            self._doc_off = array("Q")
            self._doc_off.frombytes(f.read(8 * n))
            self._doc_len = array("I")
            self._doc_len.frombytes(f.read(4 * n))
        terms: Dict[str, Tuple[int, int]] = {}
        with open(os.path.join(directory, "terms.dat"), "rb") as f:
            while True:
                hdr = f.read(_U32.size)
                if len(hdr) < _U32.size:
                    break
                tlen, = _U32.unpack(hdr)
                term = f.read(tlen).decode()
                off, df = struct.unpack("<QI", f.read(12))
                terms[term] = (off, df)
        self._terms = terms
        self._post_f = open(os.path.join(directory, "postings.dat"), "rb")
        self._docs_r = open(os.path.join(directory, "docs.dat"), "rb")
        return self

    # -- query (InvertedIndex duck-type) ---------------------------------------
    def _require_committed(self):
        if self._terms is None:
            raise RuntimeError("call commit() before querying")

    def num_documents(self) -> int:
        return len(self._doc_off)

    def _doc_row(self, doc_id: int) -> Tuple[List[str], Optional[str]]:
        self._require_committed()
        self._docs_r.seek(self._doc_off[doc_id])
        ln, = _U32.unpack(self._docs_r.read(_U32.size))
        row = self._docs_r.read(ln).decode()
        toks, _, label = row.rpartition("\x1e")
        return (toks.split("\x1f") if toks else []), (label or None)

    def document(self, doc_id: int) -> List[str]:
        return self._doc_row(doc_id)[0]

    def document_label(self, doc_id: int) -> Optional[str]:
        return self._doc_row(doc_id)[1]

    def _postings(self, word: str) -> Tuple[array, array]:
        self._require_committed()
        ent = self._terms.get(word)
        if ent is None:
            return array("I"), array("I")
        off, df = ent
        self._post_f.seek(off)
        both = array("I")
        both.frombytes(self._post_f.read(df * _REC.size))
        return both[0::2], both[1::2]

    def documents(self, word: str) -> List[int]:
        return list(self._postings(word)[0])

    def doc_frequency(self, word: str) -> int:
        self._require_committed()
        ent = self._terms.get(word)
        return ent[1] if ent else 0

    def terms(self) -> List[str]:
        self._require_committed()
        return sorted(self._terms)

    def doc_appeared_in_percent(self, word: str) -> float:
        n = self.num_documents()
        return self.doc_frequency(word) / n if n else 0.0

    def _idf(self, df: int) -> float:
        return math.log((1 + self.num_documents()) / (1 + df)) + 1.0

    def tfidf(self, word: str, doc_id: int) -> float:
        """Postings-backed tf-idf — no document fetch needed (the stored
        per-posting term counts are Lucene's term-vector shortcut)."""
        self._require_committed()
        dl = self._doc_len[doc_id]
        if not dl:
            return 0.0
        ids, cnts = self._postings(word)
        # ids ascend: binary search
        import bisect
        i = bisect.bisect_left(ids, doc_id)
        if i >= len(ids) or ids[i] != doc_id:
            return 0.0
        return (cnts[i] / dl) * self._idf(self.doc_frequency(word))

    def search(self, query_tokens: Sequence[str], top_k: int = 10
               ) -> List[Tuple[int, float]]:
        """Rank documents by summed tf-idf over the query terms (disjunctive
        Lucene-style scoring), reading only postings."""
        self._require_committed()
        scores: Dict[int, float] = {}
        for w in dict.fromkeys(query_tokens):
            ids, cnts = self._postings(w)
            if not ids:
                continue
            idf = self._idf(len(ids))
            for d, c in zip(ids, cnts):
                scores[d] = scores.get(d, 0.0) + (c / self._doc_len[d]) * idf
        return sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))[:top_k]

    def batch_iter(self, batch_size: int
                   ) -> Iterable[List[Tuple[int, List[str]]]]:
        self._require_committed()
        batch = []
        for i in range(self.num_documents()):
            batch.append((i, self.document(i)))
            if len(batch) >= batch_size:
                yield batch
                batch = []
        if batch:
            yield batch

    def close(self) -> None:
        for f in (getattr(self, "_post_f", None),
                  getattr(self, "_docs_r", None),
                  getattr(self, "_docs_f", None)):
            try:
                if f is not None and not f.closed:
                    f.close()
            except Exception:
                pass
