"""ParagraphVectors (doc2vec): PV-DBOW and PV-DM with inference — port of
deeplearning4j_tpu/nlp/paragraph.py.

Parity with the reference `models/paragraphvectors/ParagraphVectors.java`
(948 LoC; DBOW/DM via learning/impl/sequence/{DBOW,DM}.java, `inferVector`).
Label (document) vectors live in a table of their own on the model's
device; training is the same batched negative-sampling machinery as
Word2Vec (word2vec.ns_grads with the document row as the predictor for
DBOW, word2vec.dm_grads for DM), each step captured on the card as
Word2Vec's are; `infer_vector` runs a few gradient steps on a fresh row
with the word tables frozen. The negatives are numpy's ``rng.choice``
draws in JAX's order, and `infer_vector` seeds its generator from the
text's crc32, as JAX does.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..util.device import DeviceLike
from .sentence_iterator import LabelledCollectionSentenceIterator
from .tokenization import DefaultTokenizerFactory, TokenizerFactory
from .word2vec import MappedBuilder, SequenceVectors, _as_batch


class ParagraphVectors(SequenceVectors):
    def __init__(self, layer_size=100, window=5, min_word_frequency=1,
                 negative=5, learning_rate=0.025, min_learning_rate=1e-4,
                 epochs=5, batch_size=2048, seed=42, dm=False,
                 device: DeviceLike = "cuda"):
        super().__init__(layer_size=layer_size, window=window,
                         min_word_frequency=min_word_frequency,
                         negative=max(1, negative), learning_rate=learning_rate,
                         min_learning_rate=min_learning_rate, epochs=epochs,
                         batch_size=batch_size, seed=seed, device=device)
        self.dm = dm
        self.label_index: Dict[str, int] = {}
        self.doc_vectors: Optional[torch.Tensor] = None
        self._tokenizer: TokenizerFactory = DefaultTokenizerFactory()

    class Builder(MappedBuilder):
        MAPPING = {"layer_size": "layer_size", "window_size": "window",
                   "min_word_frequency": "min_word_frequency",
                   "negative_sample": "negative",
                   "learning_rate": "learning_rate",
                   "min_learning_rate": "min_learning_rate",
                   "epochs": "epochs", "iterations": "epochs",
                   "batch_size": "batch_size", "seed": "seed",
                   "grad_clip": "grad_clip", "dm": "dm", "device": "device"}

        def __init__(self):
            super().__init__()
            self._sentences: List[str] = []
            self._labels: List[str] = []

        def iterate(self, iterator: LabelledCollectionSentenceIterator):
            self._sentences = list(iterator._sentences)
            self._labels = list(iterator._labels)
            return self

        def documents(self, sentences: List[str], labels: List[str]):
            self._sentences = sentences
            self._labels = labels
            return self

        def build(self) -> "ParagraphVectors":
            pv = ParagraphVectors(**self._kw)
            pv._sentences = self._sentences
            pv._labels = self._labels
            pv._tokenizer = self._tokenizer
            return pv

    @staticmethod
    def builder() -> "ParagraphVectors.Builder":
        return ParagraphVectors.Builder()

    # -- training --------------------------------------------------------------
    def _dm_epoch(self, encoded, rng):
        """One PV-DM epoch (JAX :122-166): every token's full window (no
        reduced window), shuffled, in batches."""
        W = self.window
        B = self.batch_size
        docs, centers, ctxs, cmasks = [], [], [], []
        for seq, lab in zip(encoded, self._labels):
            di = self.label_index[lab]
            n = len(seq)
            for i in range(n):
                lo, hi = max(0, i - W), min(n, i + W + 1)
                window = [seq[j] for j in range(lo, hi) if j != i]
                pad = 2 * W - len(window)
                docs.append(di)
                centers.append(seq[i])
                ctxs.append(window + [0] * pad)
                cmasks.append([1.0] * len(window) + [0.0] * pad)
        if not docs:
            return
        docs = np.asarray(docs, np.int32)
        centers = np.asarray(centers, np.int32)
        ctxs = np.asarray(ctxs, np.int32)
        cmasks = np.asarray(cmasks, np.float32)
        perm = rng.permutation(docs.size)
        docs, centers, ctxs, cmasks = docs[perm], centers[perm], ctxs[perm], cmasks[perm]
        lr = np.float32(self.learning_rate)
        for off in range(0, docs.size, B):
            d = docs[off:off + B]
            c = centers[off:off + B]
            cx = ctxs[off:off + B]
            cm = cmasks[off:off + B]
            nv = d.size
            if nv < B:
                d = np.pad(d, (0, B - nv))
                c = np.pad(c, (0, B - nv))
                cx = np.pad(cx, ((0, B - nv), (0, 0)))
                cm = np.pad(cm, ((0, B - nv), (0, 0)))
            valid = np.zeros(B, np.float32)
            valid[:nv] = 1.0
            negs = rng.choice(self.vocab.num_words(), size=(B, self.negative),
                              p=self._neg_probs).astype(np.int32)
            self._step("dm", (d, c, cx, cm, negs, valid), lr)

    def fit(self):
        sequences = [self._tokenizer.create(s).get_tokens() for s in self._sentences]
        # word vectors first (DBOW also trains word vectors in reference when
        # trainWordVectors=true; we always do — it shares syn1neg)
        self.fit_sequences(sequences)
        self.label_index = {}
        for lab in self._labels:
            if lab not in self.label_index:
                self.label_index[lab] = len(self.label_index)
        n_docs = len(self.label_index)
        rng = np.random.default_rng(self.seed + 1)
        self.doc_vectors = torch.tensor(
            (rng.random((n_docs, self.layer_size), np.float32) - 0.5)
            / self.layer_size, device=self.device)
        encoded = self._encode(sequences)
        if self.dm:
            for _ in range(self.epochs):
                self._dm_epoch(encoded, rng)
            return self
        B = self.batch_size
        lr = np.float32(self.learning_rate)
        for _ in range(self.epochs):
            docs, targets = [], []
            for seq, lab in zip(encoded, self._labels):
                di = self.label_index[lab]
                for widx in seq:
                    docs.append(di)
                    targets.append(widx)
            docs = np.asarray(docs, np.int32)
            targets = np.asarray(targets, np.int32)
            perm = rng.permutation(docs.size)
            docs, targets = docs[perm], targets[perm]
            for off in range(0, docs.size, B):
                d = docs[off:off + B]
                t = targets[off:off + B]
                nv = d.size
                if nv < B:
                    d = np.pad(d, (0, B - nv))
                    t = np.pad(t, (0, B - nv))
                valid = np.zeros(B, np.float32)
                valid[:nv] = 1.0
                negs = rng.choice(self.vocab.num_words(),
                                  size=(B, self.negative),
                                  p=self._neg_probs).astype(np.int32)
                self._step("dbow", (d, t, negs, valid), lr)
        return self

    # -- query -----------------------------------------------------------------
    def doc_vector(self, label: str) -> Optional[np.ndarray]:
        idx = self.label_index.get(label)
        return None if idx is None else self.doc_vectors[idx].cpu().numpy()

    def infer_vector(self, text: str, steps: int = 20,
                     lr: float = 0.05) -> np.ndarray:
        """Gradient-infer a vector for unseen text (reference inferVector;
        JAX :224-252): ``steps`` steps of the negative-sampling loss over
        the text's words, the word tables frozen, fresh negatives each
        step, the ones that are also targets masked out."""
        tokens = self._tokenizer.create(text).get_tokens()
        idx = np.asarray([self.vocab.index_of(t) for t in tokens
                          if self.vocab.index_of(t) >= 0], np.int32)
        import zlib
        # stable per-text seed (process hash randomization would make
        # inference non-reproducible)
        rng = np.random.default_rng((zlib.crc32(text.encode()) ^ self.seed)
                                    & 0x7FFFFFFF)
        vec = (rng.random(self.layer_size, np.float32) - 0.5) \
            / self.layer_size
        if idx.size == 0:
            return vec
        dev = self.device
        syn1neg = self.lookup_table.syn1neg
        targets = _as_batch(idx, dev)
        u = syn1neg[targets]                                # [T, D]
        v = torch.tensor(vec, device=dev)
        with torch.no_grad():
            for _ in range(steps):
                negs = _as_batch(
                    rng.choice(self.vocab.num_words(), size=(self.negative,),
                               p=self._neg_probs).astype(np.int32), dev)
                n = syn1neg[negs]                           # [K, D]
                mask = (~torch.isin(negs, targets)).to(v.dtype)
                g = (-torch.sigmoid(-(u @ v))) @ u \
                    + (torch.sigmoid(n @ v) * mask) @ n
                v = v - lr * g
        return v.cpu().numpy()

    def similarity_to_label(self, text: str, label: str) -> float:
        v = self.infer_vector(text)
        d = self.doc_vector(label)
        denom = np.linalg.norm(v) * np.linalg.norm(d)
        return float(v @ d / denom) if denom else 0.0

    def nearest_labels(self, text: str, n: int = 5) -> List[str]:
        v = self.infer_vector(text)
        dv = self.doc_vectors.cpu().numpy()
        sims = dv @ v / (np.linalg.norm(dv, axis=1) * (np.linalg.norm(v) + 1e-12)
                         + 1e-12)
        order = np.argsort(-sims)
        inv = {i: l for l, i in self.label_index.items()}
        return [inv[int(i)] for i in order[:n]]


ParagraphVectors.Builder.TARGET_CLS = ParagraphVectors
