"""Port parity: the embeddings steps and fits against the JAX package.

The same seeded inputs (numpy) go through the JAX package's jitted steps
(deeplearning4j_tpu/nlp/word2vec.py `_make_*_step`, paragraph.py
`_make_doc_step`/`_make_dm_step`) and the port's batch steps
(deeplearning4j_tpu_torch/nlp/word2vec.py ``SequenceVectors._step``), one
step and a few, with clipping active; then whole fits (Word2Vec's four
step kinds, subsampling, the chunk path fed JAX's own device draws, GloVe,
DBOW and DM, DeepWalk), `infer_vector` on carried-over tables, the Huffman
codes and points, and the word-vector files across the packages.

Tolerance: every table within ATOL = 1e-5 (absolute; the tables' entries
are at most about 2) of JAX's, and every loss within 1e-5 relative. Both
run float32 on the CPU; the port sums the dense gradients with
``index_add_`` and the batch products in other orders than XLA's fused
programs, a few ulp per step (measured: at most 5e-7 over a whole fit).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.graph.deepwalk import DeepWalk as JDeepWalk
from deeplearning4j_tpu.graph.graph import Graph as JGraph
from deeplearning4j_tpu.nlp import serializer as jser
from deeplearning4j_tpu.nlp.glove import Glove as JGlove
from deeplearning4j_tpu.nlp.paragraph import ParagraphVectors as JPV
from deeplearning4j_tpu.nlp.vocab import VocabConstructor as JVC
from deeplearning4j_tpu.nlp.vocab import build_huffman as j_huffman
from deeplearning4j_tpu.nlp.word2vec import InMemoryLookupTable as JTable
from deeplearning4j_tpu.nlp.word2vec import SequenceVectors as JSV
from deeplearning4j_tpu.nlp.word2vec import Word2Vec as JW2V
from deeplearning4j_tpu_torch.graph.deepwalk import DeepWalk as TDeepWalk
from deeplearning4j_tpu_torch.graph.graph import Graph as TGraph
from deeplearning4j_tpu_torch.nlp import serializer as tser
from deeplearning4j_tpu_torch.nlp.glove import Glove as TGlove
from deeplearning4j_tpu_torch.nlp.paragraph import ParagraphVectors as TPV
from deeplearning4j_tpu_torch.nlp.vocab import VocabConstructor as TVC
from deeplearning4j_tpu_torch.nlp.vocab import build_huffman as t_huffman
from deeplearning4j_tpu_torch.nlp.word2vec import InMemoryLookupTable as TTable
from deeplearning4j_tpu_torch.nlp.word2vec import STEP_KINDS
from deeplearning4j_tpu_torch.nlp.word2vec import SequenceVectors as TSV
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec as TW2V

ATOL = 1e-5
LOSS_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus(n=300, seed=7):
    rng = np.random.default_rng(seed)
    animals = ["cat", "dog", "pet", "fur", "paw"]
    vehicles = ["car", "truck", "road", "wheel", "engine"]
    sentences = []
    for _ in range(n):
        group = animals if rng.random() < 0.5 else vehicles
        words = [group[i] for i in rng.integers(0, len(group), 6)]
        sentences.append(" ".join(words))
    return sentences


def _zipf_corpus(V=300, n_tokens=6000, seed=0):
    """bench.py's word2vec corpus at a small size: zipf tokens in 40-token
    sentences (many words share a count, so the Huffman heap ties)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, V + 1)
    toks = rng.choice(V, size=n_tokens, p=p / p.sum())
    return [" ".join(f"w{t}" for t in toks[i:i + 40])
            for i in range(0, n_tokens, 40)]


def _close(got, want, what):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= ATOL, f"{what}: max |diff| {err} > {ATOL}"


def _loss_close(got, want, what):
    got, want = float(got), float(want)
    assert abs(got - want) <= LOSS_REL * max(1.0, abs(want)), \
        f"{what}: loss {got} against {want}"


@pytest.mark.parametrize("corpus", ["topics", "zipf"])
def test_huffman_codes_and_points_identical(corpus):
    """hierarchic softmax indexes syn1 by the points: they, and the codes,
    are JAX's for every word, heap ties included."""
    text = _corpus() if corpus == "topics" else _zipf_corpus()
    seqs = [s.split() for s in text]
    jv, tv = JVC(1).build_vocab(seqs), TVC(1).build_vocab(seqs)
    j_huffman(jv)
    t_huffman(tv)
    assert [w.word for w in jv.vocab_words()] == \
        [w.word for w in tv.vocab_words()]
    for a, b in zip(jv.vocab_words(), tv.vocab_words()):
        assert (a.codes, a.points, a.count) == (b.codes, b.points, b.count)


def test_initial_tables_identical():
    """The port's tables start as JAX's (numpy's generator in both), and
    `from_numpy` carries JAX's across unchanged."""
    j = JTable(37, 12, seed=9, use_hs=True, use_neg=True)
    t = TTable(37, 12, seed=9, use_hs=True, use_neg=True, device="cpu")
    for name in ("syn0", "syn1", "syn1neg"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))
    c = TTable.from_numpy(np.asarray(j.syn0), np.asarray(j.syn1),
                          np.asarray(j.syn1neg), device="cpu")
    np.testing.assert_array_equal(c.syn0.numpy(), np.asarray(j.syn0))
    assert c.syn1.shape == (36, 12) and c.vocab_size == 37


V, D, B, K, P, W, ND = 30, 16, 96, 5, 6, 3, 7


def _batch(kind, rng):
    """A batch of ``kind`` (STEP_KINDS' argument order after the tables):
    collisions between a target and its negatives, and the last 16 rows
    padding (index 0, valid 0)."""
    c = rng.integers(0, V, B)
    t = rng.integers(0, V, B)
    negs = rng.integers(0, V, (B, K))
    negs[:12, 1] = t[:12]
    negs[12:24, 2] = c[12:24]
    doc = rng.integers(0, ND, B)
    ctx = rng.integers(0, V, (B, 2 * W))
    cmask = (rng.random((B, 2 * W)) < 0.7).astype(np.float32)
    cmask[:4] = 0.0          # no context at all: the mean's divisor is 1
    points = rng.integers(0, V - 1, (B, P))
    codes = rng.integers(0, 2, (B, P)).astype(np.float32)
    code_mask = (np.arange(P)[None] < rng.integers(1, P + 1, B)[:, None]
                 ).astype(np.float32)
    valid = np.ones(B, np.float32)
    pad = slice(B - 16, B)
    for a in (c, t, negs, doc, ctx, points):
        a[pad] = 0
    for a in (cmask, codes, code_mask):
        a[pad] = 0.0
    valid[pad] = 0.0
    c, t, negs, doc, ctx, points = (a.astype(np.int32) for a in
                                    (c, t, negs, doc, ctx, points))
    return {"neg": (c, t, negs, valid),
            "hs": (c, points, codes, code_mask, valid),
            "cbow": (c, ctx, cmask, negs, valid),
            "cbow_hs": (ctx, cmask, points, codes, code_mask, valid),
            "dbow": (doc, t, negs, valid),
            "dm": (doc, c, ctx, cmask, negs, valid)}[kind]


def _jax_step(kind, clip):
    if kind in ("dbow", "dm"):
        pv = JPV()  # its constructor takes no grad_clip
        pv.grad_clip = clip
        return pv._make_doc_step() if kind == "dbow" else pv._make_dm_step()
    sv = JSV(grad_clip=clip)
    return {"neg": sv._make_neg_step, "hs": sv._make_hs_step,
            "cbow": sv._make_cbow_step,
            "cbow_hs": sv._make_cbow_hs_step}[kind]()


@pytest.mark.parametrize("steps", [1, 4])
@pytest.mark.parametrize("kind", list(STEP_KINDS))
def test_step_matches_jax(kind, steps):
    """One batch step and a few of each kind against JAX's jitted step on
    the same tables and batches: the dense gradients summed per row, the
    clip of the summed gradient (0.2: many entries clip), the update and
    the batch's mean loss."""
    rng = np.random.default_rng(3)
    shapes = {"syn0": (V, D), "syn1": (V - 1, D), "syn1neg": (V, D),
              "doc_vectors": (ND, D)}
    init = {k: (rng.standard_normal(s) * 0.5).astype(np.float32)
            for k, s in shapes.items()}
    names = STEP_KINDS[kind][1]
    clip, lr = 0.2, np.float32(0.3)
    sv = TSV(grad_clip=clip, device="cpu")
    sv.lookup_table = TTable.from_numpy(init["syn0"], init["syn1"],
                                        init["syn1neg"], device="cpu")
    sv.doc_vectors = torch.tensor(init["doc_vectors"])
    jstep = _jax_step(kind, clip)
    jt = [jnp.asarray(init[n]) for n in names]
    clipped = False
    for s in range(steps):
        batch = _batch(kind, rng)
        *jt, jloss = jstep(*jt, *batch, lr)
        before = {n: sv._tables()[n].clone() for n in names}
        loss = sv._step(kind, batch, lr)
        clipped |= any(float((sv._tables()[n] - before[n]).abs().max())
                       >= clip * float(lr) * (1 - 1e-6) for n in names)
        _loss_close(loss, jloss, f"{kind} step {s}")
        for n, want in zip(names, jt):
            _close(sv._tables()[n], want, f"{kind} step {s} {n}")
    assert clipped, "the clip never engaged"


class JaxDraws:
    """JAX's chunk draws (word2vec.py :338-339, :368-371): batch i of chunk
    c draws from fold_in(fold_in(PRNGKey(seed + 1), c), i)."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed + 1)
        self.chunks = []

    def chunk(self, chunk, shape, high, device):
        n, b, k = shape
        key = jax.random.fold_in(self.key, chunk)
        self.chunks.append(chunk)
        return np.stack([np.asarray(jax.random.randint(
            jax.random.fold_in(key, i), (b, k), 0, high)) for i in range(n)])


def _w2v(cls, port, **kw):
    b = (cls.builder().layer_size(kw.get("layer", 16)).window_size(3)
         .min_word_frequency(1).negative_sample(kw.get("neg", 5))
         .epochs(kw.get("epochs", 2)).learning_rate(0.05).seed(3)
         .batch_size(kw.get("batch", 64))
         .use_hierarchic_softmax(kw.get("hs", False))
         .cbow(kw.get("cbow", False)).sampling(kw.get("sampling", 0.0))
         .iterate(kw.get("corpus") or _corpus(100)))
    if port:
        b = b.device("cpu")
    return b.build()


FITS = {"neg": {}, "hs": dict(neg=0, hs=True), "neg_hs": dict(hs=True),
        "cbow": dict(cbow=True), "cbow_hs": dict(cbow=True, neg=0, hs=True),
        "cbow_subsample": dict(cbow=True, sampling=5e-2)}


@pytest.mark.parametrize("case", list(FITS))
def test_word2vec_fit_matches_jax(case):
    """A whole per-batch fit (two epochs): the host streams (vocab, pairs,
    windows, subsampling, negatives) are identical, so the tables and the
    score follow JAX's."""
    j = _w2v(JW2V, False, **FITS[case]).fit()
    t = _w2v(TW2V, True, **FITS[case]).fit()
    assert t._chunk_counter == 0
    for name in ("syn0", "syn1", "syn1neg"):
        a = getattr(j.lookup_table, name)
        if a is None:
            assert getattr(t.lookup_table, name) is None
            continue
        _close(getattr(t.lookup_table, name), a, f"{case} {name}")
    _loss_close(t.score_, j.score_, case)


def test_chunk_path_fed_jax_draws_matches_jax():
    """The chunk path (producer thread, 64-batch chunks, the batch step
    over each) fed JAX's own device draws through ``draws`` equals JAX's
    lax.scan chunks: the same chunks, tables and last real batch's loss."""
    kw = dict(batch=16, epochs=1, corpus=_corpus(400))
    j = _w2v(JW2V, False, **kw).fit()
    t = _w2v(TW2V, True, **kw)
    t.draws = JaxDraws(3)
    t.fit()
    assert j._chunk_counter == t._chunk_counter >= 3
    assert t.draws.chunks == list(range(1, t._chunk_counter + 1))
    _close(t.lookup_table.syn0, j.lookup_table.syn0, "syn0")
    _close(t.lookup_table.syn1neg, j.lookup_table.syn1neg, "syn1neg")
    _loss_close(t.score_, j.score_, "chunk path")


@pytest.mark.parametrize("epochs,batch", [(1, 4096), (3, 128)])
def test_glove_matches_jax(epochs, batch):
    """GloVe's AdaGrad step: one step (every co-occurrence in one padded
    batch, x = 1.0 on the padding) and a few (3 epochs of 128-row
    batches): w + wc and the last loss."""
    def fit(cls, port):
        b = (cls.builder().layer_size(12).window_size(4).epochs(epochs)
             .learning_rate(0.05).seed(3).batch_size(batch)
             .iterate(_corpus(60)))
        return (b.device("cpu") if port else b).build().fit()
    j, t = fit(JGlove, False), fit(TGlove, True)
    _close(t.lookup_table.syn0, j.lookup_table.syn0, "w + wc")
    _loss_close(t.score_, j.score_, "glove")


@pytest.mark.parametrize("dm", [False, True])
def test_paragraph_vectors_fit_matches_jax(dm):
    """DBOW and DM fits (two epochs each, on top of the word vectors' fit):
    the document vectors and the word tables."""
    sentences = _corpus(80)
    labels = [f"d{i % 5}" for i in range(len(sentences))]

    def fit(cls, port):
        b = (cls.builder().layer_size(12).window_size(3).negative_sample(4)
             .epochs(2).seed(11).batch_size(64).dm(dm)
             .documents(sentences, labels))
        return (b.device("cpu") if port else b).build().fit()
    j, t = fit(JPV, False), fit(TPV, True)
    assert t.label_index == j.label_index
    _close(t.doc_vectors, j.doc_vectors, "doc vectors")
    _close(t.lookup_table.syn0, j.lookup_table.syn0, "syn0")
    _close(t.lookup_table.syn1neg, j.lookup_table.syn1neg, "syn1neg")


def test_infer_vector_matches_jax():
    """`infer_vector` on JAX's trained tables carried across: the crc32
    seed, the numpy negatives, the ``isin`` mask and 20 gradient steps."""
    sentences = _corpus(60)
    labels = ["a" if "cat" in s else "b" for s in sentences]
    j = (JPV.builder().layer_size(12).window_size(3).epochs(1).seed(5)
         .batch_size(64).documents(sentences, labels).build().fit())
    t = (TPV.builder().layer_size(12).window_size(3).epochs(1).seed(5)
         .batch_size(64).documents(sentences, labels).device("cpu")
         .build().fit())
    t.lookup_table = TTable.from_numpy(
        np.asarray(j.lookup_table.syn0), None,
        np.asarray(j.lookup_table.syn1neg), device="cpu")
    for text in ("cat dog pet", "truck road road wheel", "cat car", "zzz"):
        want = j.infer_vector(text)
        got = t.infer_vector(text)
        assert got.shape == want.shape == (12,)
        _close(got, want, text)


def test_deepwalk_matches_jax():
    """DeepWalk over the copied walks and the port's SequenceVectors."""
    def graph(cls):
        g = cls(10)
        for a in range(10):
            g.add_edge(a, (a + 1) % 10)
            g.add_edge(a, (a + 3) % 10)
        return g
    kw = dict(vector_size=8, window_size=3, walk_length=12,
              walks_per_vertex=3, epochs=2, seed=4)

    def build(cls, port):
        b = cls.builder()
        for k, v in kw.items():
            b = getattr(b, k)(v)
        return (b.device("cpu") if port else b).build()
    j = build(JDeepWalk, False).fit(graph(JGraph))
    t = build(TDeepWalk, True).fit(graph(TGraph))
    for v in range(10):
        _close(t.vertex_vector(v), j.vertex_vector(v), f"vertex {v}")


def test_serializer_files_across_packages(tmp_path):
    """The text and binary files are the same bytes from either package,
    and each package reads the other's."""
    j = _w2v(JW2V, False, corpus=_corpus(40), epochs=1).fit()
    for write_j, write_t, load_j, load_t, name in (
            (jser.write_word_vectors, tser.write_word_vectors,
             jser.load_txt_vectors, tser.load_txt_vectors, "v.txt"),
            (jser.write_word_vectors_binary,
             tser.write_word_vectors_binary, jser.load_binary_vectors,
             tser.load_binary_vectors, "v.bin")):
        pj, pt = tmp_path / ("j-" + name), tmp_path / ("t-" + name)
        write_j(j, pj)
        t = load_t(pj, device="cpu")
        write_t(t, pt)
        assert pt.read_bytes() == pj.read_bytes(), name
        back = load_j(pt)
        for w in ("cat", "truck", "engine"):
            np.testing.assert_array_equal(back.word_vector(w),
                                          t.word_vector(w))
        # a port model's own file reads in the JAX package
        own = _w2v(TW2V, True, corpus=_corpus(40), epochs=1).fit()
        po = tmp_path / ("own-" + name)
        write_t(own, po)
        got = load_j(po)
        ref = load_t(po, device="cpu")
        assert got.vocab.num_words() == own.vocab.num_words()
        for w in ("dog", "road"):
            np.testing.assert_array_equal(got.word_vector(w),
                                          ref.word_vector(w))
