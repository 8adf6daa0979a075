"""SequenceVectors + Word2Vec (SkipGram/CBOW, negative sampling +
hierarchic softmax) — port of deeplearning4j_tpu/nlp/word2vec.py.

Parity with the reference embeddings stack (SURVEY.md §2.5):
  - `models/sequencevectors/SequenceVectors.java:48` — the generic trainer
    over SequenceElements (fit():137: vocab build -> training threads)
  - `models/embeddings/learning/impl/elements/SkipGram.java:24` (HS +
    negative sampling :223-225), `CBOW.java`
  - `models/word2vec/Word2Vec.java` builder facade
  - `models/embeddings/inmemory/InMemoryLookupTable` (syn0/syn1/syn1Neg)

As in the JAX package, training pairs are made on the host and trained in
large batched steps: gather rows, the sampled-softmax (or Huffman-path)
loss summed over the batch, its gradients as dense [V, D] tensors — the
gathers' transpose, written out here and summed per row by ``index_add_``
— then the elementwise clip of the summed gradient and the dense update,
written into the tables in place. The steps are plain PyTorch: nothing in
the JAX package's nlp/ reaches a Pallas kernel.

On the card every step runs as a CUDA graph (nn/step_graph.StepGraphs: a
step kind's first batch runs eagerly and captures it, later batches
replay it). The skip-gram negative-sampling epoch runs JAX's chunk path
(JAX :211-384): a producer thread makes the pairs of 64-batch chunks
while the device trains the previous chunk; a chunk is staged on the
device once and the captured batch step replays 64 times over it. JAX
draws the chunk's negatives inside its scan program from
``fold_in(fold_in(key, chunk), i)``; a capture cannot set a generator's
state, so the port draws the chunk's [64, B, K] unigram-table indices
before the replays, in one ``torch.randint`` on the model's own device
generator seeded from ``seed + 1``, through ``draws`` (`GeneratorDraws`;
a test passes JAX's draws instead). Host randomness (the vocab's table,
pairs, subsampling, CBOW windows, per-batch negatives) is numpy, in JAX's
call order, so the two packages' host streams are identical.

With ``mesh`` (a `parallel.mesh.ProcessMesh`; reference dl4j-spark-nlp
Word2Vec.java:134) rank 0 makes each batch as before and sends it to
every rank (one command, one data broadcast); each rank computes the
dense gradients of its rows, these are summed by one all-reduce, then
clipped and applied on every rank, so the tables stay replicated (JAX's
psum before the clip). The mesh path is per batch, as in JAX, and eager.
"""
from __future__ import annotations

import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.step_graph import StepGraphs, to_device
from ..parallel.mesh import SERVICE_OPS
from ..util.device import DeviceLike, resolve_device
from .sentence_iterator import CollectionSentenceIterator
from .tokenization import DefaultTokenizerFactory, TokenizerFactory
from .vocab import VocabCache, VocabConstructor, build_huffman

Tensor = torch.Tensor


# -- the steps' gradients ----------------------------------------------------
# Each returns the dense gradients of the batch's summed loss with respect
# to the tables it reads, in their order, and that sum. d(-log sigmoid(x))
# = -sigmoid(-x), d(-log sigmoid(-x)) = sigmoid(x): JAX's softplus
# derivatives.

def _scatter(table: Tensor, idx: Tensor, rows: Tensor) -> Tensor:
    """``rows`` summed into a zero [V, D] gradient at ``idx``."""
    return torch.zeros_like(table).index_add_(
        0, idx.reshape(-1), rows.reshape(-1, table.shape[-1]))


def _ns_heads(h, syn1neg, target, negs, valid):
    """The negative-sampling head over predictor rows ``h`` (JAX
    `_neg_sampling_loss` :41-54): (dL/dh, syn1neg's gradient, the loss
    summed over the valid rows)."""
    u = syn1neg[target]
    n = syn1neg[negs]                                   # [B, K, D]
    pos = (h * u).sum(-1)
    neg = torch.einsum("bd,bkd->bk", h, n)
    # sampled negatives that collide with the positive target drop out
    mask = (negs != target[:, None]).to(neg.dtype)
    loss = ((-F.logsigmoid(pos) - (F.logsigmoid(-neg) * mask).sum(-1))
            * valid).sum()
    dpos = -torch.sigmoid(-pos) * valid
    dneg = torch.sigmoid(neg) * mask * valid[:, None]
    gh = dpos[:, None] * u + torch.einsum("bk,bkd->bd", dneg, n)
    g1 = _scatter(syn1neg, target, dpos[:, None] * h)
    g1.index_add_(0, negs.reshape(-1),
                  (dneg[:, :, None] * h[:, None, :]).reshape(-1, h.shape[1]))
    return gh, g1, loss


def _hs_heads(h, syn1, points, codes, code_mask, valid):
    """The hierarchic-softmax head (JAX `_make_hs_step` :386-405): the
    Huffman path's inner nodes ``points``, code 0 -> +1, 1 -> -1."""
    p = syn1[points]                                    # [B, P, D]
    logits = torch.einsum("bd,bpd->bp", h, p)
    sign = 1.0 - 2.0 * codes
    loss = ((-(F.logsigmoid(sign * logits) * code_mask).sum(-1))
            * valid).sum()
    dlog = -torch.sigmoid(-sign * logits) * sign * code_mask * valid[:, None]
    gh = torch.einsum("bp,bpd->bd", dlog, p)
    g1 = _scatter(syn1, points, dlog[:, :, None] * h[:, None, :])
    return gh, g1, loss


def ns_grads(syn0, syn1neg, center, context, negs, valid):
    """Skip-gram, negative sampling (JAX `_make_neg_step` :186-199)."""
    gh, g1, loss = _ns_heads(syn0[center], syn1neg, context, negs, valid)
    return [_scatter(syn0, center, gh), g1], loss


def hs_grads(syn0, syn1, center, points, codes, code_mask, valid):
    """Skip-gram, hierarchic softmax (JAX :386-405)."""
    gh, g1, loss = _hs_heads(syn0[center], syn1, points, codes, code_mask,
                             valid)
    return [_scatter(syn0, center, gh), g1], loss


def _cbow_mean(syn0, ctx, cmask):
    """(the masked mean of the context rows, its divisor) (JAX :450)."""
    cnt = cmask.sum(-1, keepdim=True).clamp_min(1.0)
    return torch.einsum("bwd,bw->bd", syn0[ctx], cmask) / cnt, cnt


def _cbow_back(syn0, ctx, cmask, gh, cnt):
    """syn0's gradient through the context mean: ``gh / cnt`` into every
    unmasked context row (padding rows get zeros)."""
    return _scatter(syn0, ctx, (gh / cnt)[:, None, :] * cmask[:, :, None])


def cbow_grads(syn0, syn1neg, center, ctx, cmask, negs, valid):
    """CBOW, negative sampling (JAX `_make_cbow_step` :446-467)."""
    h, cnt = _cbow_mean(syn0, ctx, cmask)
    gh, g1, loss = _ns_heads(h, syn1neg, center, negs, valid)
    return [_cbow_back(syn0, ctx, cmask, gh, cnt), g1], loss


def cbow_hs_grads(syn0, syn1, ctx, cmask, points, codes, code_mask, valid):
    """CBOW, hierarchic softmax (JAX `_make_cbow_hs_step` :469-492)."""
    h, cnt = _cbow_mean(syn0, ctx, cmask)
    gh, g1, loss = _hs_heads(h, syn1, points, codes, code_mask, valid)
    return [_cbow_back(syn0, ctx, cmask, gh, cnt), g1], loss


def dm_grads(docvecs, syn0, syn1neg, doc, center, ctx, cmask, negs, valid):
    """PV-DM (JAX paragraph.py `_make_dm_step` :96-120): (the document row
    + the context rows) / (count + 1) predicts the center word."""
    cnt = (cmask.sum(-1, keepdim=True) + 1.0).clamp_min(1.0)
    h = (docvecs[doc] + torch.einsum("bwd,bw->bd", syn0[ctx], cmask)) / cnt
    gh, g1, loss = _ns_heads(h, syn1neg, center, negs, valid)
    return [_scatter(docvecs, doc, gh / cnt),
            _cbow_back(syn0, ctx, cmask, gh, cnt), g1], loss


def glove_grads(w, wc, b, bc, i, j, x, valid, x_max, alpha, den):
    """GloVe's weighted least squares (JAX glove.py :229-233), the mean
    over ``den`` valid rows: the gradients of w, wc, b, bc and the loss."""
    diff = (w[i] * wc[j]).sum(-1) + b[i] + bc[j] - torch.log(x)
    f = torch.clamp_max((x / x_max) ** alpha, 1.0)
    loss = (f * diff * diff * valid).sum() / den
    ddot = 2.0 * f * diff * valid / den
    return [_scatter(w, i, ddot[:, None] * wc[j]),
            _scatter(wc, j, ddot[:, None] * w[i]),
            torch.zeros_like(b).index_add_(0, i, ddot),
            torch.zeros_like(bc).index_add_(0, j, ddot)], loss


def sgd_clipped(tables: Sequence[Tensor], grads: Sequence[Tensor], lr: Tensor,
                clip: float) -> None:
    """``t -= lr * clip(g)`` in place (JAX :194-196)."""
    for t, g in zip(tables, grads):
        t.sub_(g.clamp_(-clip, clip).mul_(lr))


def adagrad(tables: Sequence[Tensor], accs: Sequence[Tensor],
            grads: Sequence[Tensor], lr: Tensor) -> None:
    """GloVe's AdaGrad (JAX glove.py :240-247): ``h += g * g``, then
    ``t -= lr * g / sqrt(h)``, in place."""
    for t, h, g in zip(tables, accs, grads):
        h.add_(g * g)
        t.sub_(g.mul_(lr).div_(h.sqrt()))


#: step kind -> (gradient function, the tables it trains, the batch
#: arrays it reads after them; "valid" last)
STEP_KINDS = {
    "neg": (ns_grads, ("syn0", "syn1neg")),
    "hs": (hs_grads, ("syn0", "syn1")),
    "cbow": (cbow_grads, ("syn0", "syn1neg")),
    "cbow_hs": (cbow_hs_grads, ("syn0", "syn1")),
    "dbow": (ns_grads, ("doc_vectors", "syn1neg")),
    "dm": (dm_grads, ("doc_vectors", "syn0", "syn1neg")),
}
GLOVE_TABLES = ("w", "wc", "b", "bc")
GLOVE_ACCS = ("hw", "hwc", "hb", "hbc")


def _as_batch(a, device) -> Tensor:
    """A host batch array on ``device``: indices int64, floats float32."""
    a = np.asarray(a)
    return to_device(a.astype(np.int64) if a.dtype.kind in "iu" else a,
                     device, torch.float32)


class GeneratorDraws:
    """A chunk's negative-table indices, ``[n_batches, B, K]`` uniform in
    ``[0, high)``, from one generator in call order (the default of
    ``SequenceVectors.draws``). A replacement has the same ``chunk``
    method; JAX's draws for chunk ``c`` come from
    ``fold_in(fold_in(PRNGKey(seed + 1), c), i)`` for batch ``i``."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def chunk(self, chunk: int, shape, high: int, device) -> Tensor:
        return torch.randint(0, high, tuple(shape), generator=self.gen,
                             device=device)


class InMemoryLookupTable:
    """syn0 / syn1 (HS) / syn1neg weight store on ``device``
    (reference InMemoryLookupTable.java:62-74; JAX :57-74): syn0 from
    numpy's generator as JAX makes it, the others zeros."""

    def __init__(self, vocab_size: int, layer_size: int, seed: int = 42,
                 use_hs: bool = False, use_neg: bool = True,
                 device: DeviceLike = "cuda"):
        dev = resolve_device(device)
        self.vocab_size = vocab_size
        self.layer_size = layer_size
        rng = np.random.default_rng(seed)
        self.syn0 = torch.as_tensor(
            (rng.random((vocab_size, layer_size), np.float32) - 0.5)
            / layer_size, device=dev)
        self.syn1 = (torch.zeros((max(vocab_size - 1, 1), layer_size),
                                 dtype=torch.float32, device=dev)
                     if use_hs else None)
        self.syn1neg = (torch.zeros((vocab_size, layer_size),
                                    dtype=torch.float32, device=dev)
                        if use_neg else None)

    @classmethod
    def of(cls, syn0: Tensor, syn1: Optional[Tensor] = None,
           syn1neg: Optional[Tensor] = None) -> "InMemoryLookupTable":
        """A table holding these tensors."""
        t = cls.__new__(cls)
        t.vocab_size, t.layer_size = syn0.shape
        t.syn0, t.syn1, t.syn1neg = syn0, syn1, syn1neg
        return t

    @classmethod
    def from_numpy(cls, syn0, syn1=None, syn1neg=None,
                   device: DeviceLike = "cuda") -> "InMemoryLookupTable":
        """A table holding copies of these arrays (the JAX package's tables
        carried across) on ``device``."""
        dev = resolve_device(device)

        def put(a):
            return None if a is None else torch.tensor(
                np.asarray(a, np.float32), device=dev)
        return cls.of(put(syn0), put(syn1), put(syn1neg))

    def vector(self, idx: int) -> np.ndarray:
        return self.syn0[idx].cpu().numpy()


class SequenceVectors:
    """Generic embedding trainer over element sequences
    (reference SequenceVectors.java:48). Subclasses/builders supply sequences
    of string elements; training is batched SkipGram/CBOW on ``device``."""

    #: batches per chunk on the chunk path (JAX's SCAN_BATCHES)
    SCAN_BATCHES = 64

    def __init__(self, layer_size=100, window=5, min_word_frequency=1,
                 negative=5, use_hierarchic_softmax=False, learning_rate=0.025,
                 min_learning_rate=1e-4, epochs=1, batch_size=2048, seed=42,
                 subsample=0.0, cbow=False, grad_clip=1.0, mesh=None,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.layer_size = layer_size
        self.window = window
        self.min_word_frequency = min_word_frequency
        self.negative = negative
        self.use_hs = use_hierarchic_softmax
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.subsample = subsample
        self.cbow = cbow
        # elementwise clip on the summed batch gradient: bounds the update a
        # single row can receive when it recurs many times in one batch (the
        # sequential reference bounds this naturally by updating incrementally)
        self.grad_clip = grad_clip
        self.mesh = mesh
        #: where the chunk path's negative draws come from: None until the
        #: chunk path first runs, then a GeneratorDraws; a test may set an
        #: object with the same ``chunk`` method first
        self.draws = None
        self.vocab: Optional[VocabCache] = None
        self.lookup_table: Optional[InMemoryLookupTable] = None
        self._max_code_len = 0
        self.words_per_sec_ = float("nan")
        #: the captured steps (captures / replays count them)
        self.graphs = StepGraphs(self.device, "on")
        self._bodies: Dict[str, object] = {}
        self._mesh_run: Optional[_MeshRun] = None
        self._scan_ready = False
        self._chunk_counter = 0
        self._neg_table_dev: Optional[Tensor] = None

    # -- data ------------------------------------------------------------------
    def _build_vocab(self, sequences: List[List[str]]):
        self.vocab = VocabConstructor(self.min_word_frequency).build_vocab(sequences)
        if self.use_hs:
            build_huffman(self.vocab)
            self._max_code_len = max(
                (len(v.codes) for v in self.vocab.vocab_words()), default=0)
        self.lookup_table = InMemoryLookupTable(
            self.vocab.num_words(), self.layer_size, self.seed,
            use_hs=self.use_hs, use_neg=self.negative > 0, device=self.device)
        # unigram^0.75 negative-sampling table (reference uses the same
        # power-law table inside ND4J's word2vec sampling)
        counts = np.array([v.count for v in self.vocab.vocab_words()], np.float64)
        probs = counts ** 0.75
        self._neg_probs = (probs / probs.sum()).astype(np.float64)
        # classic word2vec unigram table: index i appears proportional to
        # count^0.75, so sampling = one uniform integer draw (O(1)/draw)
        table_size = min(1 << 22, max(1 << 16, self.vocab.num_words() * 64))
        reps = np.maximum(np.rint(self._neg_probs * table_size), 1).astype(np.int64)
        self._neg_table = np.repeat(
            np.arange(len(reps), dtype=np.int32), reps)
        self._neg_table_dev = None  # a new vocab: upload its table anew

    def _encode(self, sequences: List[List[str]]) -> List[np.ndarray]:
        out = []
        for seq in sequences:
            idx = [self.vocab.index_of(w) for w in seq]
            out.append(np.array([i for i in idx if i >= 0], np.int32))
        return out

    def _pairs(self, encoded: List[np.ndarray], rng: np.random.Generator
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(center, context) pairs with word2vec's random reduced window
        (JAX :145-173): per window offset d, one boolean mask over the
        concatenated sequences; center i pairs with j iff |i-j| <= b_i."""
        seqs = [s for s in encoded if len(s) >= 2]
        if not seqs:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32))
        toks = np.concatenate(seqs)
        lens = np.array([len(s) for s in seqs])
        seq_id = np.repeat(np.arange(len(seqs)), lens)
        b = rng.integers(1, self.window + 1, toks.size)
        centers, contexts = [], []
        for d in range(1, self.window + 1):
            if d >= toks.size:
                break
            same = seq_id[:-d] == seq_id[d:]
            mr = same & (b[:-d] >= d)   # center i,   context i+d
            ml = same & (b[d:] >= d)    # center i+d, context i
            centers.append(toks[:-d][mr])
            contexts.append(toks[d:][mr])
            centers.append(toks[d:][ml])
            contexts.append(toks[:-d][ml])
        return (np.concatenate(centers).astype(np.int32),
                np.concatenate(contexts).astype(np.int32))

    def _sample_negatives(self, rng: np.random.Generator, shape
                          ) -> np.ndarray:
        """Unigram^0.75 sampling from the precomputed table — O(1) per draw
        instead of rng.choice's O(V) with an explicit prob vector."""
        return self._neg_table[rng.integers(0, self._neg_table.size, shape)]

    # -- the steps ---------------------------------------------------------------
    def _tables(self) -> Dict[str, Tensor]:
        """Every table the steps train, by name."""
        t = self.lookup_table
        out = {"syn0": t.syn0, "syn1": t.syn1, "syn1neg": t.syn1neg,
               "doc_vectors": getattr(self, "doc_vectors", None)}
        return {k: v for k, v in out.items() if v is not None}

    def _body(self, kind: str):
        """The batch step of ``kind``: its gradients, the clip and the
        update in place; returns the batch's mean loss (a device scalar)."""
        body = self._bodies.get(kind)
        if body is None:
            grads_fn, names = STEP_KINDS[kind]
            clip = self.grad_clip

            @torch.no_grad()
            def body(*args):
                tables = [self._tables()[n] for n in names]
                *batch, lr = args
                grads, loss = grads_fn(*tables, *batch)
                sgd_clipped(tables, grads, lr, clip)
                return loss / batch[-1].sum().clamp_min(1.0)
            self._bodies[kind] = body
        return body

    def _step(self, kind: str, batch, lr) -> Tensor:
        """One batch step (``batch`` host arrays or device tensors, in the
        order of ``kind``'s gradient function after its tables): on the
        mesh, or through the captured steps."""
        if self._mesh_run is not None:
            return self._mesh_run.step(kind, [np.asarray(a) for a in batch],
                                       float(lr))
        args = tuple(a if isinstance(a, Tensor) else _as_batch(a, self.device)
                     for a in batch)
        if not isinstance(lr, Tensor):
            lr = _as_batch(np.float32(lr), self.device)
        return self.graphs.run(kind, args + (lr,), self._body(kind),
                               list(self._tables().values()))

    def _ensure_scan_state(self):
        """The chunk path's device state: the unigram table (uploaded once
        a vocab) and the draws' generator, seeded from ``seed + 1``."""
        if self._neg_table_dev is None:
            self._neg_table_dev = torch.as_tensor(
                self._neg_table.astype(np.int64), device=self.device)
        if not self._scan_ready:
            if self.draws is None:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(self.seed + 1)
                self.draws = GeneratorDraws(gen)
            self._chunk_counter = 0
            self._scan_ready = True

    def _fit_epoch_stream(self, epoch_seqs, rng, seen, total_pairs):
        """One skip-gram negative-sampling epoch with host pair generation
        overlapped with the device (JAX :211-309): a producer thread slices
        the epoch into sequence groups, vectorizes each group through
        _pairs, and feeds full chunks through a bounded queue; the consumer
        trains one chunk per item while the producer makes the next.
        Returns (seen, last_loss).

        Cross-thread discipline: every producer<->consumer hand-off rides a
        happens-before channel — chunks through the bounded Queue, shutdown
        through the `stop` Event, `producer_error` read only after the join
        — and the producer touches no `self` state the consumer writes."""
        import queue as _queue
        import threading
        import time

        B = self.batch_size
        scan_n = self.SCAN_BATCHES
        chunk_pairs = scan_n * B
        self._ensure_scan_state()
        q: _queue.Queue = _queue.Queue(maxsize=4)
        prng = np.random.default_rng(rng.integers(0, 2 ** 63))
        GROUP = 512  # sequences per vectorized _pairs call

        producer_error: list = []
        stop = threading.Event()  # consumer failed: stop generating

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except _queue.Full:
                    continue
            return False

        def _produce():
            try:
                bc = np.zeros(0, np.int32)
                bt = np.zeros(0, np.int32)
                for gi in range(0, len(epoch_seqs), GROUP):
                    if stop.is_set():
                        return  # consumer died: don't pair-gen the rest
                    cg, tg = self._pairs(epoch_seqs[gi:gi + GROUP], prng)
                    if cg.size == 0:
                        continue
                    perm = prng.permutation(cg.size)
                    bc = np.concatenate([bc, cg[perm]])
                    bt = np.concatenate([bt, tg[perm]])
                    while bc.size >= chunk_pairs:
                        if not _put((bc[:chunk_pairs], bt[:chunk_pairs],
                                     chunk_pairs)):
                            return
                        bc, bt = bc[chunk_pairs:], bt[chunk_pairs:]
                if bc.size:
                    _put((bc, bt, int(bc.size)))
            except BaseException as e:  # surfaced to the consumer: a
                # swallowed producer failure would silently end the epoch
                # early and report success on partially-trained data
                producer_error.append(e)
            finally:
                q.put(None)

        th = threading.Thread(target=_produce, daemon=True)
        th.start()
        last_loss = float("nan")
        try:
            seen, last_loss = self._consume_stream(q, seen, total_pairs,
                                                   last_loss)
        finally:
            # consumer done or failed: stop the producer and drain to the
            # sentinel so a blocked q.put unblocks
            stop.set()
            while True:
                try:
                    if q.get_nowait() is None:
                        break
                except _queue.Empty:
                    if not th.is_alive():
                        break
                    time.sleep(0.01)
            th.join()
        if producer_error:
            raise producer_error[0]
        return seen, last_loss

    def _chunk_arrays(self, raw_c, raw_t, real, seen, total_pairs):
        """A chunk's host arrays, padded to SCAN_BATCHES x B (padding:
        index 0, valid 0), and each batch's learning rate (JAX :322-336)."""
        B = self.batch_size
        scan_n = self.SCAN_BATCHES
        chunk_pairs = scan_n * B
        cs = np.zeros(chunk_pairs, np.int64)
        ts = np.zeros(chunk_pairs, np.int64)
        cs[:real] = raw_c[:real]
        ts[:real] = raw_t[:real]
        seen_at = seen + np.arange(scan_n, dtype=np.float64) * B
        lrs = np.maximum(
            self.min_learning_rate,
            self.learning_rate
            * (1.0 - np.minimum(1.0, seen_at / total_pairs))
        ).astype(np.float32)
        valids = np.zeros(chunk_pairs, np.float32)
        valids[:real] = 1.0
        return (cs.reshape(scan_n, B), ts.reshape(scan_n, B),
                valids.reshape(scan_n, B), lrs)

    def _train_chunk(self, cs, ts, valids, lrs) -> Tensor:
        """One chunk on the device: staged once, its negatives drawn for
        all its batches before the first step, then one captured batch
        step per batch. Returns the batches' mean losses (device [n])."""
        self._chunk_counter += 1
        n, B = cs.shape
        dev = self.device
        draw = self.draws.chunk(self._chunk_counter & 0x7FFFFFFF,
                                (n, B, self.negative),
                                int(self._neg_table_dev.shape[0]), dev)
        if not isinstance(draw, Tensor):
            draw = _as_batch(draw, dev)
        negs = self._neg_table_dev[draw.to(dev)]
        cs, ts, valids, lrs = (_as_batch(a, dev)
                               for a in (cs, ts, valids, lrs))
        losses = torch.empty(n, dtype=torch.float32, device=dev)
        for i in range(n):
            losses[i].copy_(self._step("neg", (cs[i], ts[i], negs[i],
                                               valids[i]), lrs[i]))
        return losses

    def _consume_stream(self, q, seen, total_pairs, last_loss):
        """Consumer half of _fit_epoch_stream: one chunk per queue item
        until the producer's end-of-stream sentinel."""
        B = self.batch_size
        while True:
            item = q.get()
            if item is None:
                break
            raw_c, raw_t, real = item
            losses = self._train_chunk(*self._chunk_arrays(
                raw_c, raw_t, real, seen, total_pairs))
            last_loss = losses[(real - 1) // B]
            seen += real
        return seen, last_loss

    def _subsample(self, encoded: List[np.ndarray],
                   rng: np.random.Generator) -> List[np.ndarray]:
        """Frequent-word subsampling: drop token with prob 1 - sqrt(t/f)
        (word2vec convention; reference `sampling` option)."""
        if self.subsample <= 0:
            return encoded
        counts = np.array([v.count for v in self.vocab.vocab_words()], np.float64)
        freq = counts / max(self.vocab.total_word_count, 1)
        keep_prob = np.minimum(1.0, np.sqrt(self.subsample / np.maximum(freq, 1e-12)))
        out = []
        for seq in encoded:
            if seq.size == 0:
                out.append(seq)
                continue
            keep = rng.random(seq.size) < keep_prob[seq]
            out.append(seq[keep])
        return out

    def _cbow_batches(self, encoded: List[np.ndarray], rng: np.random.Generator):
        """(center, context-window [2W] padded, context mask) tuples."""
        W = self.window
        centers, ctxs, masks = [], [], []
        for seq in encoded:
            n = len(seq)
            if n < 2:
                continue
            b = rng.integers(1, W + 1, n)
            for i in range(n):
                lo, hi = max(0, i - b[i]), min(n, i + b[i] + 1)
                window = [seq[j] for j in range(lo, hi) if j != i]
                if not window:
                    continue
                pad = 2 * W - len(window)
                centers.append(seq[i])
                ctxs.append(window + [0] * pad)
                masks.append([1.0] * len(window) + [0.0] * pad)
        return (np.asarray(centers, np.int32), np.asarray(ctxs, np.int32),
                np.asarray(masks, np.float32))

    # -- the mesh ----------------------------------------------------------------
    def _start_mesh(self, tables: Dict[str, Tensor]) -> None:
        """Attach this fit's rank service (the tables' copies) to the mesh,
        dropping the previous fit's."""
        if self._mesh_run is not None:
            self._mesh_run.close()
            self._mesh_run = None
        if self.batch_size % self.mesh.size:
            raise ValueError(
                f"batch_size {self.batch_size} must divide the mesh size "
                f"{self.mesh.size}")
        self._mesh_run = _MeshRun(self.mesh, self.device, tables,
                                  self.grad_clip)

    def mesh_table_replicas(self, name: str = "syn0") -> List[np.ndarray]:
        """Every rank's copy of table ``name`` after the last mesh fit, in
        rank order (one all-gather)."""
        if self._mesh_run is None:
            raise ValueError("no mesh fit has run")
        return self._mesh_run.replicas(name)

    # -- training --------------------------------------------------------------
    def fit_sequences(self, sequences: List[List[str]]):
        import time as _time
        self._build_vocab(sequences)
        encoded = self._encode(sequences)
        rng = np.random.default_rng(self.seed)
        if self.mesh is not None:
            self._start_mesh(self._tables())
        step_neg = self.negative > 0
        if self.use_hs:
            P = max(self._max_code_len, 1)
            V = self.vocab.num_words()
            points_tbl = np.zeros((V, P), np.int32)
            codes_tbl = np.zeros((V, P), np.float32)
            mask_tbl = np.zeros((V, P), np.float32)
            for vw in self.vocab.vocab_words():
                L = len(vw.codes)
                points_tbl[vw.index, :L] = vw.points
                codes_tbl[vw.index, :L] = vw.codes
                mask_tbl[vw.index, :L] = 1.0

        # total pair estimate for linear lr decay (word2vec convention)
        total_pairs = max(1, sum(max(len(s) - 1, 0) for s in encoded)
                          * self.window * self.epochs)
        if self.negative <= 0 and not self.use_hs:
            raise ValueError("Enable negative sampling (negative > 0) and/or "
                             "hierarchic softmax (use_hierarchic_softmax=True)")
        step_cbow = self.cbow and self.negative > 0
        step_cbow_hs = self.cbow and self.use_hs
        seen = 0
        B = self.batch_size
        last_loss = float("nan")
        tokens_seen = 0
        # warm the steps on zero batches (their capture on the card) so
        # words_per_sec_ reports steady-state throughput; a zero-valid batch
        # leaves the tables unchanged (JAX :554-599)
        zi = np.zeros((B,), np.int32)
        zv = np.zeros((B,), np.float32)
        lr0 = np.float32(self.learning_rate)
        if step_neg and not self.cbow:
            self._step("neg", (zi, zi, np.zeros((B, self.negative), np.int32),
                               zv), lr0)
            if (not self.use_hs and self.mesh is None
                    and total_pairs // max(self.epochs, 1)
                    >= self.SCAN_BATCHES * B):
                # the chunk path's state, only when an epoch can reach it
                self._ensure_scan_state()
        Pmax = max(self._max_code_len, 1)
        zw = np.zeros((B, 2 * self.window), np.int32)
        zm = np.zeros((B, 2 * self.window), np.float32)
        zp = np.zeros((B, Pmax), np.int32)
        zc = np.zeros((B, Pmax), np.float32)
        if self.use_hs and not self.cbow:
            self._step("hs", (zi, zp, zc, zc, zv), lr0)
        if step_cbow:
            self._step("cbow", (zi, zw, zm, np.zeros((B, self.negative),
                                                     np.int32), zv), lr0)
        if step_cbow_hs:
            self._step("cbow_hs", (zw, zm, zp, zc, zc, zv), lr0)
        t0 = _time.perf_counter()
        for _ in range(self.epochs):
            order = rng.permutation(len(encoded))
            epoch_seqs = self._subsample([encoded[i] for i in order], rng)
            tokens_seen += sum(len(s) for s in epoch_seqs)
            if self.cbow:
                centers, ctxs, cmasks = self._cbow_batches(epoch_seqs, rng)
                for off in range(0, centers.size, B):
                    c = centers[off:off + B]
                    cx = ctxs[off:off + B]
                    cm = cmasks[off:off + B]
                    nv = c.size
                    if nv < B:
                        c = np.pad(c, (0, B - nv))
                        cx = np.pad(cx, ((0, B - nv), (0, 0)))
                        cm = np.pad(cm, ((0, B - nv), (0, 0)))
                    valid = np.zeros(B, np.float32)
                    valid[:nv] = 1.0
                    frac = min(1.0, seen / total_pairs)
                    lr = np.float32(max(self.min_learning_rate,
                                        self.learning_rate * (1.0 - frac)))
                    if step_cbow:
                        negs = self._sample_negatives(rng, (B, self.negative))
                        last_loss = self._step("cbow", (c, cx, cm, negs,
                                                        valid), lr)
                    if step_cbow_hs:
                        last_loss = self._step(
                            "cbow_hs", (cx, cm, points_tbl[c], codes_tbl[c],
                                        mask_tbl[c], valid), lr)
                    seen += nv
                continue
            # the chunk path (negative sampling only, one process): the
            # producer thread overlaps host pair generation with the device
            scan_n = self.SCAN_BATCHES
            # expected pairs per center is ~(window+1): b uniform in
            # [1,window] emits 2*E[b] = window+1 contexts
            est_pairs = sum(max(len(s) - 1, 0) for s in epoch_seqs) \
                * (self.window + 1)
            if (self.negative > 0 and not self.use_hs and self.mesh is None
                    and est_pairs >= scan_n * B):
                seen, last_loss = self._fit_epoch_stream(
                    epoch_seqs, rng, seen, total_pairs)
                continue
            centers, contexts = self._pairs(epoch_seqs, rng)
            if centers.size == 0:
                continue
            perm = rng.permutation(centers.size)
            centers, contexts = centers[perm], contexts[perm]
            for off in range(0, centers.size, B):
                c = centers[off:off + B]
                t = contexts[off:off + B]
                nvalid = c.size
                if nvalid < B:  # pad to static shape
                    c = np.pad(c, (0, B - nvalid))
                    t = np.pad(t, (0, B - nvalid))
                valid = np.zeros(B, np.float32)
                valid[:nvalid] = 1.0
                frac = min(1.0, seen / total_pairs)
                lr = np.float32(max(self.min_learning_rate,
                                    self.learning_rate * (1.0 - frac)))
                if self.negative > 0:
                    negs = self._sample_negatives(rng, (B, self.negative))
                    last_loss = self._step("neg", (c, t, negs, valid), lr)
                if self.use_hs:
                    last_loss = self._step(
                        "hs", (c, points_tbl[t], codes_tbl[t], mask_tbl[t],
                               valid), lr)
                seen += nvalid
        # the clock is read after a host read of the last loss: the steps
        # are asynchronous, and an earlier clock would overstate words/s
        self.score_ = float(last_loss)
        elapsed = max(_time.perf_counter() - t0, 1e-9)
        self.words_per_sec_ = tokens_seen / elapsed
        return self

    # -- query API (reference wordVectors interface) ---------------------------
    def has_word(self, word: str) -> bool:
        return self.vocab is not None and self.vocab.contains_word(word)

    def word_vector(self, word: str) -> Optional[np.ndarray]:
        if not self.has_word(word):
            return None
        return self.lookup_table.syn0[self.vocab.index_of(word)].cpu().numpy()

    def similarity(self, w1: str, w2: str) -> float:
        a, b = self.word_vector(w1), self.word_vector(w2)
        if a is None or b is None:
            return float("nan")
        denom = np.linalg.norm(a) * np.linalg.norm(b)
        return float(a @ b / denom) if denom else 0.0

    def words_nearest(self, word_or_vec, n: int = 10) -> List[str]:
        if isinstance(word_or_vec, str):
            vec = self.word_vector(word_or_vec)
            exclude = {word_or_vec}
        else:
            vec = np.asarray(word_or_vec)
            exclude = set()
        if vec is None:
            return []
        syn0 = self.lookup_table.syn0.cpu().numpy()
        norms = np.linalg.norm(syn0, axis=1) * (np.linalg.norm(vec) + 1e-12)
        sims = syn0 @ vec / np.maximum(norms, 1e-12)
        order = np.argsort(-sims)
        out = []
        for idx in order:
            w = self.vocab.word_at_index(int(idx))
            if w not in exclude:
                out.append(w)
            if len(out) >= n:
                break
        return out


# -- the mesh's ranks --------------------------------------------------------
OP_STEP, OP_GATHER = SERVICE_OPS, SERVICE_OPS + 1
_FACTORY = "deeplearning4j_tpu_torch.nlp.word2vec:_mesh_service"


def mesh_rank_step(comm, tables: Dict[str, Tensor], clip: float,
                   data) -> Tensor:
    """One batch step on this rank of ``comm``: the gradients of its
    B / n rows of the batch, summed over the ranks by one all-reduce (the
    loss sum with them), then the update on every rank — clip + SGD for
    the word2vec kinds, AdaGrad for "glove". Returns the batch's mean
    loss."""
    kind, batch = data["kind"], data["batch"]
    dev = next(iter(tables.values())).device
    n, r = comm.size, comm.rank
    b = batch[0].shape[0] // n
    rows = [_as_batch(a[r * b:(r + 1) * b], dev) for a in batch]
    den = float(max(np.sum(batch[-1], dtype=np.float32), 1.0))
    lr = torch.tensor(np.float32(data["lr"]), device=dev)
    with torch.no_grad():
        if kind == "glove":
            ts = [tables[k] for k in GLOVE_TABLES]
            grads, loss = glove_grads(*ts, *rows, data["x_max"],
                                      data["alpha"],
                                      torch.tensor(np.float32(den),
                                                   device=dev))
        else:
            grads_fn, names = STEP_KINDS[kind]
            ts = [tables[k] for k in names]
            grads, loss = grads_fn(*ts, *rows)
        sizes = [g.numel() for g in grads]
        flat = comm.all_reduce(torch.cat([g.reshape(-1) for g in grads]
                                         + [loss.reshape(1)]))
        grads = [p.view_as(g) for p, g in zip(
            flat[:-1].split(sizes), grads)]
        if kind == "glove":
            adagrad(ts, [tables[k] for k in GLOVE_ACCS], grads, lr)
            return flat[-1].clone()
        sgd_clipped(ts, grads, lr, clip)
        return flat[-1] / den


class _MeshService:
    """A follower's copy of the tables of one fit (the service
    `_MeshRun` attaches): it runs every batch step rank 0 runs."""

    def __init__(self, comm, payload):
        self.comm = comm
        self.clip = payload["clip"]
        self.tables = {k: torch.tensor(v, device=comm.device)
                       for k, v in payload["tables"].items()}

    def handle(self, cmd) -> None:
        data = pickle.loads(self.comm.broadcast_bytes(None, cmd.args[0]))
        if cmd.op == OP_STEP:
            mesh_rank_step(self.comm, self.tables, self.clip, data)
        elif cmd.op == OP_GATHER:
            self.comm.all_gather(self.tables[data][None], 0)
        else:
            raise ValueError(f"unknown embeddings command {cmd.op}")

    def close(self) -> None:
        self.tables = {}


def _mesh_service(comm, payload) -> _MeshService:
    return _MeshService(comm, payload)


class _MeshRun:
    """Rank 0's side of one mesh fit: the followers' service, holding
    copies of ``tables`` (rank 0's own are trained in place)."""

    def __init__(self, mesh, device: torch.device, tables: Dict[str, Tensor],
                 clip: float):
        if mesh.device != device:
            raise ValueError(f"the mesh's rank 0 runs on {mesh.device}, the "
                             f"model lives on {device}")
        self.mesh, self.tables, self.clip = mesh, tables, clip
        self.sid = mesh.attach(_FACTORY, {
            "clip": clip,
            "tables": {k: v.cpu().numpy() for k, v in tables.items()}})

    def _run(self, op: int, data, fn):
        if self.mesh.size == 1:
            return fn()
        blob = pickle.dumps(data, protocol=pickle.HIGHEST_PROTOCOL)
        with self.mesh.exclusive():
            self.mesh.command(op, self.sid, (len(blob),))
            self.mesh.broadcast_bytes(blob, len(blob))
            return fn()

    def step(self, kind: str, batch: List[np.ndarray], lr: float,
             **extra) -> Tensor:
        data = dict(kind=kind, batch=batch, lr=lr, **extra)
        return self._run(OP_STEP, data, lambda: mesh_rank_step(
            self.mesh, self.tables, self.clip, data))

    def replicas(self, name: str) -> List[np.ndarray]:
        t = self._run(OP_GATHER, name,
                      lambda: self.mesh.all_gather(self.tables[name][None], 0))
        return [a for a in t.cpu().numpy()]

    def close(self) -> None:
        self.mesh.detach(self.sid)


class MappedBuilder:
    """Shared fluent-builder machinery for the embedding model facades:
    subclasses define TARGET_CLS and MAPPING (fluent name -> ctor kwarg)."""

    TARGET_CLS: type = None
    MAPPING: Dict[str, str] = {}

    def __init__(self):
        self._kw = {}
        self._iterator = None
        self._tokenizer: TokenizerFactory = DefaultTokenizerFactory()

    def __getattr__(self, name):
        if name in type(self).MAPPING:
            def setter(value):
                self._kw[type(self).MAPPING[name]] = value
                return self
            return setter
        raise AttributeError(name)

    def iterate(self, iterator):
        if isinstance(iterator, (list, tuple)):
            iterator = CollectionSentenceIterator(iterator)
        self._iterator = iterator
        return self

    def tokenizer_factory(self, tf: TokenizerFactory):
        self._tokenizer = tf
        return self

    def build(self):
        model = type(self).TARGET_CLS(**self._kw)
        model._iterator = self._iterator
        model._tokenizer = self._tokenizer
        return model


_COMMON_MAPPING = {
    "layer_size": "layer_size", "window_size": "window",
    "min_word_frequency": "min_word_frequency",
    "learning_rate": "learning_rate", "epochs": "epochs",
    "iterations": "epochs", "batch_size": "batch_size", "seed": "seed",
    "grad_clip": "grad_clip", "device": "device",
}


class Word2Vec(SequenceVectors):
    """Builder facade (reference models/word2vec/Word2Vec.java)."""

    class Builder(MappedBuilder):
        MAPPING = dict(_COMMON_MAPPING,
                       negative_sample="negative",
                       min_learning_rate="min_learning_rate",
                       sampling="subsample",
                       use_hierarchic_softmax="use_hierarchic_softmax",
                       cbow="cbow",
                       use_mesh="mesh")

    @staticmethod
    def builder() -> "Word2Vec.Builder":
        return Word2Vec.Builder()

    def fit(self):
        sequences = [self._tokenizer.create(s).get_tokens()
                     for s in self._iterator]
        return self.fit_sequences(sequences)


Word2Vec.Builder.TARGET_CLS = Word2Vec
