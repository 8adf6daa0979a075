"""GloVe: co-occurrence counting + weighted least-squares embedding — port
of deeplearning4j_tpu/nlp/glove.py.

Parity with the reference `models/glove/` (Glove.java:32 over SequenceVectors,
AbstractCoOccurrences windowed counting with 1/distance weighting) and
`models/embeddings/learning/impl/elements/GloVe.java` (403 LoC; AdaGrad row
updates). Co-occurrences are counted on the host into COO triples
(`AbstractCoOccurrences`, a host-only copy of JAX's, spill shards and their
cleanup included); training runs as batched AdaGrad steps on the device,
the gathers' transpose summed per row by ``index_add_`` into dense
gradients (word2vec.glove_grads), each step captured on the card as the
word2vec steps are. The AdaGrad accumulators start at ones and the padded
rows' ``x`` is 1.0, as in JAX. JAX reads the loss on the host after every
step; the port reads it once, after the last step: ``score_`` is the same
value.

With ``mesh`` each rank computes the gradients of its rows of every batch,
the ranks sum them (one all-reduce) and every rank applies the same
AdaGrad step (word2vec.mesh_rank_step), so the tables stay replicated.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..util.device import DeviceLike
from .tokenization import DefaultTokenizerFactory, TokenizerFactory
from .vocab import VocabConstructor
from .word2vec import (GLOVE_ACCS, GLOVE_TABLES, InMemoryLookupTable,
                       MappedBuilder, SequenceVectors, _as_batch, adagrad,
                       glove_grads)


def _cleanup_shards(paths: List[str]) -> None:
    import os
    for p in paths:
        try:
            os.unlink(p)
        except OSError:
            pass


class AbstractCoOccurrences:
    """Windowed symmetric co-occurrence counts with 1/d weighting
    (reference models/glove/AbstractCoOccurrences + its disk-spilled
    counting in models/glove/count/).

    Counting is vectorized (per-offset masks over the concatenated corpus,
    coalesced with np.unique — no per-token Python loop), and memory is
    bounded like the reference's CountMap spill: when accumulated unique
    pairs exceed `max_pairs_in_memory`, the partial COO shard is written to
    `spill_dir` (or a temp dir) and counting continues with an empty
    accumulator; `triples()` merges all shards."""

    def __init__(self, window: int = 15, symmetric: bool = True,
                 max_pairs_in_memory: int = 10_000_000,
                 spill_dir: Optional[str] = None,
                 vocab_size: Optional[int] = None):
        import uuid
        self.window = window
        self.symmetric = symmetric
        self.max_pairs = max_pairs_in_memory
        self.spill_dir = spill_dir
        import weakref
        self._keys = np.zeros(0, np.int64)
        self._vals = np.zeros(0, np.float64)
        self._shards: List[str] = []
        # GC'd counters remove their own shards even in a shared spill_dir
        # (the finalizer sees late appends through the shared list object)
        weakref.finalize(self, _cleanup_shards, self._shards)
        self._tmpdir = None
        self._shard_tag = uuid.uuid4().hex[:12]  # unique within shared dirs
        # pass vocab_size for incremental fits (Glove supplies it); without
        # it the key base grows by re-basing stored keys when needed
        self._n = int(vocab_size) if vocab_size else 0

    def _coalesce(self, keys: np.ndarray, vals: np.ndarray):
        uk, inv = np.unique(keys, return_inverse=True)
        sums = np.bincount(inv, weights=vals, minlength=uk.size)
        return uk, sums

    def _spill(self):
        import shutil
        import tempfile
        import weakref
        if self.spill_dir is None and self._tmpdir is None:
            self._tmpdir = tempfile.mkdtemp(prefix="glove_cooc_")
            weakref.finalize(self, shutil.rmtree, self._tmpdir,
                             ignore_errors=True)
        d = self.spill_dir or self._tmpdir
        path = f"{d}/shard_{self._shard_tag}_{len(self._shards):04d}.npz"
        np.savez_compressed(path, keys=self._keys, vals=self._vals)
        self._shards.append(path)
        self._keys = np.zeros(0, np.int64)
        self._vals = np.zeros(0, np.float64)

    def _rebase(self, new_v: int):
        """Re-encode stored keys from base self._n to base new_v (vocab
        grew across incremental fits without an up-front vocab_size)."""
        old_v = self._n

        def rebase(keys):
            return (keys // old_v) * new_v + (keys % old_v)

        self._keys = rebase(self._keys)
        for path in self._shards:
            with np.load(path) as z:
                k, v = rebase(z["keys"]), z["vals"]
            np.savez_compressed(path, keys=k, vals=v)
        self._n = new_v

    def _absorb(self, keys: np.ndarray, vals: np.ndarray):
        """Merge a pair chunk into the bounded in-memory accumulator,
        spilling when it exceeds max_pairs (memory stays bounded even
        within one large fit() call)."""
        self._keys, self._vals = self._coalesce(
            np.concatenate([self._keys, keys]),
            np.concatenate([self._vals, vals]))
        if self._keys.size > self.max_pairs:
            self._spill()

    def fit(self, encoded_sequences: List[np.ndarray]):
        w = self.window
        seqs = [np.asarray(s, np.int64) for s in encoded_sequences
                if len(s) >= 2]
        if not seqs:
            return self
        toks = np.concatenate(seqs)
        needed = int(toks.max()) + 1
        if self._n == 0:
            self._n = needed
        elif needed > self._n:
            self._rebase(needed)
        V = self._n
        lens = np.array([len(s) for s in seqs])
        seq_id = np.repeat(np.arange(len(seqs)), lens)
        for d in range(1, w + 1):
            if d >= toks.size:
                break
            same = seq_id[:-d] == seq_id[d:]
            a = toks[d:][same]     # later token
            b = toks[:-d][same]    # earlier token, distance d
            wgt = np.full(a.size, 1.0 / d)
            if self.symmetric:
                self._absorb(np.concatenate([a * V + b, b * V + a]),
                             np.concatenate([wgt, wgt]))
            else:
                self._absorb(a * V + b, wgt)
        return self

    def triples(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        key_parts, val_parts = [self._keys], [self._vals]
        for path in self._shards:
            with np.load(path) as z:
                key_parts.append(z["keys"])
                val_parts.append(z["vals"])
        keys, vals = self._coalesce(np.concatenate(key_parts),
                                    np.concatenate(val_parts))
        V = max(self._n, 1)
        return ((keys // V).astype(np.int32), (keys % V).astype(np.int32),
                vals.astype(np.float32))

    def close(self) -> None:
        """Delete this counter's spill shards (also runs via finalizer for
        the self-created temp dir; call explicitly when using a shared
        spill_dir so shards don't accumulate across runs)."""
        import os
        for path in self._shards:
            try:
                os.unlink(path)
            except OSError:
                pass
        self._shards = []

    @property
    def counts(self) -> Dict[Tuple[int, int], float]:
        """READ-ONLY snapshot as {(row, col): weight}; missing pairs read
        as 0.0. Mutations are not written back — use fit() to add counts
        (the pre-round-3 mutable-defaultdict API is retired)."""
        from collections import defaultdict
        r, c, v = self.triples()
        out: Dict[Tuple[int, int], float] = defaultdict(float)
        out.update({(int(a), int(b)): float(x)
                    for a, b, x in zip(r, c, v)})
        return out


class Glove(SequenceVectors):
    """Reference models/glove/Glove.java:32."""

    def __init__(self, layer_size=50, window=15, min_word_frequency=1,
                 learning_rate=0.05, epochs=25, batch_size=4096, seed=42,
                 x_max=100.0, alpha=0.75, symmetric=True, mesh=None,
                 device: DeviceLike = "cuda"):
        super().__init__(layer_size=layer_size, window=window,
                         min_word_frequency=min_word_frequency,
                         learning_rate=learning_rate, epochs=epochs,
                         batch_size=batch_size, seed=seed, mesh=mesh,
                         device=device)
        self.x_max = x_max
        self.alpha = alpha
        self.symmetric = symmetric
        self._iterator = None
        self._tokenizer: TokenizerFactory = DefaultTokenizerFactory()
        self._glove: Dict[str, torch.Tensor] = {}

    class Builder(MappedBuilder):
        MAPPING = {"layer_size": "layer_size", "window_size": "window",
                   "min_word_frequency": "min_word_frequency",
                   "learning_rate": "learning_rate", "epochs": "epochs",
                   "iterations": "epochs", "batch_size": "batch_size",
                   "seed": "seed", "x_max": "x_max", "alpha": "alpha",
                   "symmetric": "symmetric", "use_mesh": "mesh",
                   "device": "device"}

    @staticmethod
    def builder() -> "Glove.Builder":
        return Glove.Builder()

    def fit(self):
        sequences = [self._tokenizer.create(s).get_tokens() for s in self._iterator]
        return self.fit_sequences(sequences)

    def _tables(self) -> Dict[str, torch.Tensor]:
        return self._glove

    def _glove_body(self):
        x_max, alpha = self.x_max, self.alpha

        @torch.no_grad()
        def body(i, j, x, valid, lr):
            t = self._glove
            ts = [t[k] for k in GLOVE_TABLES]
            grads, loss = glove_grads(*ts, i, j, x, valid, x_max, alpha,
                                      valid.sum().clamp_min(1.0))
            adagrad(ts, [t[k] for k in GLOVE_ACCS], grads, lr)
            return loss
        return body

    def fit_sequences(self, sequences: List[List[str]]):
        self.vocab = VocabConstructor(self.min_word_frequency).build_vocab(sequences)
        encoded = self._encode(sequences)
        cooc = AbstractCoOccurrences(
            self.window, self.symmetric,
            vocab_size=self.vocab.num_words()).fit(encoded)
        rows, cols, vals = cooc.triples()
        V, D = self.vocab.num_words(), self.layer_size
        rng = np.random.default_rng(self.seed)
        dev = self.device
        w = (rng.random((V, D), np.float32) - 0.5) / D
        wc = (rng.random((V, D), np.float32) - 0.5) / D
        t = {"w": torch.tensor(w, device=dev), "wc": torch.tensor(wc, device=dev),
             "b": torch.zeros(V, dtype=torch.float32, device=dev),
             "bc": torch.zeros(V, dtype=torch.float32, device=dev)}
        # AdaGrad accumulators (reference uses per-row AdaGrad)
        for k, acc in zip(GLOVE_TABLES, GLOVE_ACCS):
            t[acc] = torch.ones_like(t[k])
        self._glove = t
        if self.mesh is not None:
            self._start_mesh(t)
        body = self._glove_body()
        lr = _as_batch(np.float32(self.learning_rate), dev)

        B = self.batch_size
        n = rows.size
        last = float("nan")
        for _ in range(self.epochs):
            perm = rng.permutation(n)
            for off in range(0, n, B):
                sl = perm[off:off + B]
                i, j, x = rows[sl], cols[sl], vals[sl]
                nv = i.size
                if nv < B:
                    i = np.pad(i, (0, B - nv))
                    j = np.pad(j, (0, B - nv))
                    x = np.pad(x, (0, B - nv), constant_values=1.0)
                valid = np.zeros(B, np.float32)
                valid[:nv] = 1.0
                if self._mesh_run is not None:
                    last = self._mesh_run.step(
                        "glove", [i, j, x, valid], float(self.learning_rate),
                        x_max=self.x_max, alpha=self.alpha)
                else:
                    args = tuple(_as_batch(a, dev) for a in (i, j, x, valid))
                    last = self.graphs.run("glove", args + (lr,), body,
                                           list(t.values()))
        # final embedding = w + wc (GloVe convention)
        self.lookup_table = InMemoryLookupTable.of(t["w"] + t["wc"])
        self.score_ = float(last)
        return self


Glove.Builder.TARGET_CLS = Glove
