"""Word-vector serialization in word2vec-compatible text/binary formats —
port of deeplearning4j_tpu/nlp/serializer.py.

Parity with the reference `models/embeddings/loader/WordVectorSerializer`
(writeWordVectors / loadTxtVectors / word2vec C binary format). The files
are shared interchange formats: a file written by either package reads
in the other, and both write the same bytes for the same vectors. The
loaders put the vectors on ``device``.
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import Tuple

import numpy as np

from .vocab import VocabCache, VocabWord
from ..util.device import DeviceLike
from .word2vec import InMemoryLookupTable, SequenceVectors


def _escape(word: str) -> str:
    # word2vec's space-delimited formats cannot hold spaces (n-gram vocab
    # entries); escape them reversibly, leaving external files unaffected
    return word.replace("%", "%25").replace(" ", "%20")


def _unescape(word: str) -> str:
    return word.replace("%20", " ").replace("%25", "%")


def write_word_vectors(model: SequenceVectors, path) -> None:
    """word2vec text format: header 'V D', then 'word v1 v2 ...' per line."""
    path = Path(path)
    syn0 = model.lookup_table.syn0.cpu().numpy()
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"{model.vocab.num_words()} {model.layer_size}\n")
        for vw in model.vocab.vocab_words():
            vec = " ".join(f"{x:.6f}" for x in syn0[vw.index])
            f.write(f"{_escape(vw.word)} {vec}\n")


def load_txt_vectors(path, device: DeviceLike = "cuda") -> SequenceVectors:
    """Load word2vec text format into a query-able SequenceVectors."""
    path = Path(path)
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        header = f.readline().split()
        v, d = int(header[0]), int(header[1])
        words, vectors = [], []
        for line in f:
            parts = line.rstrip("\n").split(" ")
            if len(parts) < d + 1:
                continue
            words.append(_unescape(parts[0]))
            vectors.append(np.asarray(parts[1:d + 1], np.float32))
    return _model(words, vectors, d, device)


def write_word_vectors_binary(model: SequenceVectors, path) -> None:
    """word2vec C binary format."""
    path = Path(path)
    syn0 = model.lookup_table.syn0.cpu().numpy().astype(np.float32)
    with open(path, "wb") as f:
        f.write(f"{model.vocab.num_words()} {model.layer_size}\n".encode())
        for vw in model.vocab.vocab_words():
            f.write(_escape(vw.word).encode("utf-8") + b" ")
            f.write(syn0[vw.index].tobytes())
            f.write(b"\n")


def load_binary_vectors(path, device: DeviceLike = "cuda") -> SequenceVectors:
    path = Path(path)
    with open(path, "rb") as f:
        header = f.readline().split()
        v, d = int(header[0]), int(header[1])
        words, vectors = [], []
        for _ in range(v):
            word = bytearray()
            while True:
                ch = f.read(1)
                if ch == b" " or not ch:
                    break
                word.extend(ch)
            vec = np.frombuffer(f.read(4 * d), np.float32)
            f.read(1)  # trailing newline
            words.append(_unescape(word.decode("utf-8", errors="replace")))
            vectors.append(vec)
    return _model(words, vectors, d, device)


def _model(words, vectors, d: int, device: DeviceLike) -> SequenceVectors:
    """A query-able SequenceVectors over loaded words and vectors."""
    model = SequenceVectors(layer_size=d, device=device)
    cache = VocabCache()
    for i, w in enumerate(words):
        vw = VocabWord(w, count=1, index=i)
        cache._words[w] = vw
        cache._by_index.append(vw)
    model.vocab = cache
    model.lookup_table = InMemoryLookupTable.from_numpy(np.stack(vectors),
                                                        device=model.device)
    return model
