"""Port parity: Word2Vec and GloVe over a process mesh — the cases of
tests/test_nlp_distributed.py on the port.

Reference: dl4j-spark-nlp Spark Word2Vec/Glove
(spark/dl4j-spark-nlp/.../embeddings/word2vec/Word2Vec.java:134). The port's
mesh is a `parallel.mesh.ProcessMesh`: rank 0 is this process, the
followers are spawned gloo ranks on ``devices=["cpu"] * n``, one torch
thread a rank. Rank 0 makes every batch (the same host streams as one
process), each rank computes the dense gradients of its rows, one
all-reduce sums them, and every rank clips and applies the sum — so mesh
training must equal one process on the same batches within JAX's
tolerance (rtol 5e-4, atol 5e-5), and every rank's tables must be the
same. Every collective carries a 60 s timeout and the fixtures kill the
followers at teardown.
"""
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nlp.word2vec import Word2Vec as JW2V
from deeplearning4j_tpu_torch.nlp.glove import Glove
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
from deeplearning4j_tpu_torch.parallel import mesh as tmesh

TIMEOUT = 60.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh2():
    m = tmesh.default_mesh(2, ["cpu"] * 2, timeout=TIMEOUT).start()
    yield m
    m.kill()


@pytest.fixture(scope="module")
def mesh4():
    m = tmesh.default_mesh(4, ["cpu"] * 4, timeout=TIMEOUT).start()
    yield m
    m.kill()


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


def _w2v(mesh=None, corpus=None, cls=Word2Vec, **kw):
    b = (cls.builder()
         .layer_size(24).window_size(3).negative_sample(4)
         .min_word_frequency(1).epochs(3).seed(11).batch_size(512)
         .iterate(corpus or _corpus()))
    for k, v in kw.items():
        b = getattr(b, k)(v)
    if cls is Word2Vec:
        b = b.device("cpu")
    if mesh is not None:
        b = b.use_mesh(mesh)
    return b.build()


def _glove(mesh=None):
    b = (Glove.builder()
         .layer_size(16).window_size(5).epochs(20).seed(3).batch_size(1024)
         .device("cpu").iterate(_corpus(200)))
    if mesh is not None:
        b = b.use_mesh(mesh)
    return b.build().fit()


@pytest.mark.parametrize("kind", ["neg", "hs"])
def test_mesh_word2vec_equals_single_device(kind, mesh4):
    """Same seed => identical host-side pair/negative sampling; the mesh
    step must produce the same tables as one process (and, for skip-gram
    negative sampling, as the JAX package)."""
    corpus = _corpus(200)
    kw = {} if kind == "neg" else dict(negative_sample=0,
                                       use_hierarchic_softmax=True)
    single = _w2v(corpus=corpus, **kw).fit()
    dist = _w2v(mesh=mesh4, corpus=corpus, **kw).fit()
    for name in ("syn0", "syn1neg" if kind == "neg" else "syn1"):
        np.testing.assert_allclose(
            getattr(single.lookup_table, name).numpy(),
            getattr(dist.lookup_table, name).numpy(), rtol=5e-4, atol=5e-5)
    if kind == "neg":
        jax_single = _w2v(corpus=corpus, cls=JW2V).fit()
        np.testing.assert_allclose(np.asarray(jax_single.lookup_table.syn0),
                                   dist.lookup_table.syn0.numpy(),
                                   rtol=5e-4, atol=5e-5)


def test_mesh_word2vec_similarity(mesh2):
    w2v = _w2v(mesh=mesh2).fit()
    within = w2v.similarity("cat", "dog")
    across = w2v.similarity("cat", "truck")
    assert within > across
    assert w2v.words_per_sec_ > 0


def test_mesh_word2vec_tables_replicated(mesh4):
    """Every rank holds the same tables after the fit: the ranks apply the
    same all-reduced gradient, bit for bit."""
    w2v = _w2v(mesh=mesh4, corpus=_corpus(100), cbow=True).fit()
    for name in ("syn0", "syn1neg"):
        reps = w2v.mesh_table_replicas(name)
        assert len(reps) == 4
        mine = getattr(w2v.lookup_table, name).numpy()
        for r in reps:
            np.testing.assert_array_equal(r, mine)


def test_mesh_glove_similarity(mesh2):
    g = _glove(mesh2)
    assert g.similarity("cat", "dog") > g.similarity("cat", "truck")
    np.testing.assert_allclose(g.lookup_table.syn0.numpy(),
                               _glove().lookup_table.syn0.numpy(),
                               rtol=5e-4, atol=5e-5)
    assert all(np.array_equal(r, g._glove["w"].numpy())
               for r in g.mesh_table_replicas("w"))


def test_mesh_refusals(mesh4):
    """The batch must split over the mesh (JAX's message), and the ranks'
    tables can be read only after a mesh fit."""
    with pytest.raises(ValueError, match="must divide the mesh size"):
        _w2v(mesh=mesh4, batch_size=510).fit()
    with pytest.raises(ValueError, match="no mesh fit has run"):
        _w2v().mesh_table_replicas()
