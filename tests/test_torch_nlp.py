"""Port parity: the NLP stack's cases of tests/test_nlp.py on both packages.

Each case of tests/test_nlp.py runs twice, ``pkg`` "jax" (the JAX package,
deeplearning4j_tpu/nlp and graph/) and "port" (deeplearning4j_tpu_torch/nlp
and graph/, its models on ``device="cpu"``): the reference NLP suite's
full fits on a small synthetic corpus with similarity assertions, the
tokenizers, Huffman coding, TF-IDF, the serializers, the graph walks and
the co-occurrence counter. Then the port's own: its entry points default
to the card and raise without one, the chunk path's bookkeeping and
DeepWalk's hierarchic softmax.
"""
import types

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.graph import deepwalk as j_deepwalk
from deeplearning4j_tpu.graph import graph as j_graph
from deeplearning4j_tpu.nlp import glove as j_glove
from deeplearning4j_tpu.nlp import paragraph as j_paragraph
from deeplearning4j_tpu.nlp import serializer as j_serializer
from deeplearning4j_tpu.nlp import tfidf as j_tfidf
from deeplearning4j_tpu.nlp import tokenization as j_tokenization
from deeplearning4j_tpu.nlp import vocab as j_vocab
from deeplearning4j_tpu.nlp import word2vec as j_word2vec
from deeplearning4j_tpu_torch.graph import deepwalk as t_deepwalk
from deeplearning4j_tpu_torch.graph import graph as t_graph
from deeplearning4j_tpu_torch.nlp import glove as t_glove
from deeplearning4j_tpu_torch.nlp import paragraph as t_paragraph
from deeplearning4j_tpu_torch.nlp import serializer as t_serializer
from deeplearning4j_tpu_torch.nlp import tfidf as t_tfidf
from deeplearning4j_tpu_torch.nlp import tokenization as t_tokenization
from deeplearning4j_tpu_torch.nlp import vocab as t_vocab
from deeplearning4j_tpu_torch.nlp import word2vec as t_word2vec


def _ns(tok, voc, w2v, glv, par, tfi, ser, gra, dwk):
    return types.SimpleNamespace(
        CommonPreprocessor=tok.CommonPreprocessor,
        DefaultTokenizerFactory=tok.DefaultTokenizerFactory,
        EndingPreProcessor=tok.EndingPreProcessor,
        NGramTokenizerFactory=tok.NGramTokenizerFactory,
        VocabConstructor=voc.VocabConstructor, build_huffman=voc.build_huffman,
        Word2Vec=w2v.Word2Vec, Glove=glv.Glove,
        AbstractCoOccurrences=glv.AbstractCoOccurrences,
        ParagraphVectors=par.ParagraphVectors,
        BagOfWordsVectorizer=tfi.BagOfWordsVectorizer,
        TfidfVectorizer=tfi.TfidfVectorizer, wvserde=ser, Graph=gra.Graph,
        GraphLoader=gra.GraphLoader,
        RandomWalkIterator=gra.RandomWalkIterator, DeepWalk=dwk.DeepWalk)


PKGS = {
    "jax": _ns(j_tokenization, j_vocab, j_word2vec, j_glove, j_paragraph,
               j_tfidf, j_serializer, j_graph, j_deepwalk),
    "port": _ns(t_tokenization, t_vocab, t_word2vec, t_glove, t_paragraph,
                t_tfidf, t_serializer, t_graph, t_deepwalk),
}
both = pytest.mark.parametrize("pkg", list(PKGS))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several test files at once on a few cores; one torch
    intra-op thread keeps this file from starving the others' timings."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _on(builder, pkg):
    """The builder, on the CPU for the port (its default is the card)."""
    return builder.device("cpu") if pkg == "port" else builder


def _corpus(n=300, seed=7):
    """Two topic clusters: {cat,dog,pet,fur} and {car,truck,road,wheel}."""
    rng = np.random.default_rng(seed)
    animals = ["cat", "dog", "pet", "fur", "paw"]
    vehicles = ["car", "truck", "road", "wheel", "engine"]
    sentences = []
    for _ in range(n):
        group = animals if rng.random() < 0.5 else vehicles
        words = [group[i] for i in rng.integers(0, len(group), 6)]
        sentences.append(" ".join(words))
    return sentences


@both
def test_tokenizers(pkg):
    m = PKGS[pkg]
    tf = m.DefaultTokenizerFactory()
    assert tf.create("Hello  world foo").get_tokens() == ["Hello", "world", "foo"]
    tf.set_token_pre_processor(m.CommonPreprocessor())
    assert tf.create("Hello, World!").get_tokens() == ["hello", "world"]
    ng = m.NGramTokenizerFactory(1, 2)
    toks = ng.create("a b c").get_tokens()
    assert "a b" in toks and "b c" in toks and "a" in toks
    assert m.EndingPreProcessor().pre_process("running") == "runn"


@both
def test_vocab_and_huffman(pkg):
    m = PKGS[pkg]
    seqs = [["the", "cat", "sat"], ["the", "dog", "sat"], ["the", "end"]]
    vocab = m.VocabConstructor(min_word_frequency=1).build_vocab(seqs)
    assert vocab.num_words() == 5
    assert vocab.word_at_index(0) == "the"  # most frequent first
    assert vocab.word_frequency("the") == 3
    m.build_huffman(vocab)
    words = vocab.vocab_words()
    # Huffman: most frequent word gets shortest code
    the_len = len(vocab.word_for("the").codes)
    assert all(the_len <= len(w.codes) for w in words)
    # codes are prefix-free
    codes = {tuple(w.codes) for w in words}
    assert len(codes) == len(words)
    # min frequency filtering
    vocab2 = m.VocabConstructor(min_word_frequency=2).build_vocab(seqs)
    assert vocab2.num_words() == 2  # the, sat


@both
def test_word2vec_similarity(pkg):
    """Topic-cluster similarity (reference Word2VecTests.testRunWord2Vec)."""
    w2v = _on(PKGS[pkg].Word2Vec.builder()
              .layer_size(32).window_size(3).min_word_frequency(2)
              .negative_sample(5).epochs(10).learning_rate(0.05)
              .seed(42).batch_size(512)
              .iterate(_corpus()), pkg).build()
    w2v.fit()
    assert w2v.has_word("cat") and w2v.has_word("car")
    within = w2v.similarity("cat", "dog")
    across = w2v.similarity("cat", "truck")
    assert within > across, f"within={within} across={across}"
    nearest = w2v.words_nearest("cat", 3)
    animal_set = {"dog", "pet", "fur", "paw"}
    assert len(set(nearest) & animal_set) >= 2, nearest
    vec = w2v.word_vector("cat")
    assert vec.shape == (32,)


@both
def test_word2vec_hierarchic_softmax(pkg):
    w2v = _on(PKGS[pkg].Word2Vec.builder()
              .layer_size(24).window_size(3).min_word_frequency(2)
              .negative_sample(0).use_hierarchic_softmax(True)
              .epochs(10).learning_rate(0.05).seed(1)
              .iterate(_corpus(200)), pkg).build()
    w2v.fit()
    assert w2v.similarity("cat", "dog") > w2v.similarity("cat", "wheel")


@both
def test_glove(pkg):
    g = _on(PKGS[pkg].Glove.builder()
            .layer_size(24).window_size(5).min_word_frequency(2)
            .epochs(40).learning_rate(0.05).seed(3)
            .iterate(_corpus(200)), pkg).build()
    g.fit()
    assert g.similarity("cat", "dog") > g.similarity("cat", "truck")


def _labels(sentences):
    return ["animal" if any(w in s for w in ("cat", "dog", "pet", "fur", "paw"))
            else "vehicle" for s in sentences]


@both
def test_paragraph_vectors(pkg):
    """Label inference (reference ParagraphVectorsTest)."""
    sentences = _corpus(200)
    pv = _on(PKGS[pkg].ParagraphVectors.builder()
             .layer_size(24).window_size(3).min_word_frequency(2)
             .negative_sample(5).epochs(8).seed(11)
             .documents(sentences, _labels(sentences)), pkg).build()
    pv.fit()
    assert pv.doc_vector("animal") is not None
    sim_animal = pv.similarity_to_label("cat dog pet", "animal")
    sim_vehicle = pv.similarity_to_label("cat dog pet", "vehicle")
    assert sim_animal > sim_vehicle
    assert pv.nearest_labels("truck road wheel", 1) == ["vehicle"]
    v = pv.infer_vector("dog fur paw")
    assert v.shape == (24,)


@both
def test_tfidf_and_bow(pkg):
    m = PKGS[pkg]
    docs = ["the cat sat", "the dog sat", "rockets fly high"]
    tfidf = m.TfidfVectorizer().fit(docs)
    v = tfidf.transform("the cat")
    assert v.shape == (tfidf.vocab.num_words(),)
    # 'the' appears in 2/3 docs -> lower idf than 'rockets' (1/3)
    assert tfidf.idf("rockets") > tfidf.idf("the")
    bow = m.BagOfWordsVectorizer().fit(docs)
    counts = bow.transform("cat cat dog")
    assert counts[bow.vocab.index_of("cat")] == 2
    assert counts[bow.vocab.index_of("dog")] == 1


@both
def test_word_vector_serialization(pkg, tmp_path):
    m = PKGS[pkg]
    w2v = _on(m.Word2Vec.builder().layer_size(16).min_word_frequency(2)
              .epochs(2).seed(5).iterate(_corpus(50)), pkg).build()
    w2v.fit()
    kw = {"device": "cpu"} if pkg == "port" else {}
    # text format
    p = tmp_path / "vecs.txt"
    m.wvserde.write_word_vectors(w2v, p)
    loaded = m.wvserde.load_txt_vectors(p, **kw)
    np.testing.assert_allclose(loaded.word_vector("cat"), w2v.word_vector("cat"),
                               atol=1e-5)
    # binary format
    pb = tmp_path / "vecs.bin"
    m.wvserde.write_word_vectors_binary(w2v, pb)
    loaded_b = m.wvserde.load_binary_vectors(pb, **kw)
    np.testing.assert_allclose(loaded_b.word_vector("dog"), w2v.word_vector("dog"),
                               atol=1e-6)


def _two_cluster_graph(m):
    """Two 6-cliques joined by one edge."""
    g = m.Graph(12)
    for base in (0, 6):
        for i in range(6):
            for j in range(i + 1, 6):
                g.add_edge(base + i, base + j)
    g.add_edge(0, 6)
    return g


@both
def test_graph_and_walks(pkg):
    m = PKGS[pkg]
    g = _two_cluster_graph(m)
    assert g.num_vertices() == 12
    assert g.degree(1) == 5
    walks = list(m.RandomWalkIterator(g, walk_length=10, seed=1))
    assert len(walks) == 12
    assert all(len(w) == 10 for w in walks)
    # walks stay on connected vertices
    for w in walks:
        for a, b in zip(w, w[1:]):
            assert b in g.get_connected_vertices(a)


@both
def test_graph_loader(pkg, tmp_path):
    p = tmp_path / "edges.txt"
    p.write_text("0 1\n1 2\n2 0\n")
    g = PKGS[pkg].GraphLoader.load_undirected_graph_edge_list(p)
    assert g.num_vertices() == 3
    assert g.num_edges() == 3


@both
def test_deepwalk_clusters(pkg):
    """DeepWalk separates the two cliques (reference DeepWalk tests)."""
    m = PKGS[pkg]
    g = _two_cluster_graph(m)
    dw = _on(m.DeepWalk.builder().vector_size(16).window_size(3)
             .walk_length(20).walks_per_vertex(8).epochs(5).seed(2), pkg
             ).build()
    dw.fit(g)
    within = dw.similarity(1, 2)
    across = dw.similarity(1, 8)
    assert within > across, f"within={within} across={across}"


@both
def test_word2vec_cbow_hierarchic_softmax(pkg):
    """The CBOW+HS cell of the reference's 2x2 {SkipGram,CBOW} x {HS,NS}
    grid (CBOW.java supports all four)."""
    w2v = _on(PKGS[pkg].Word2Vec.builder()
              .layer_size(24).window_size(3).min_word_frequency(2)
              .negative_sample(0).use_hierarchic_softmax(True)
              .epochs(12).learning_rate(0.05).seed(9)
              .batch_size(512).cbow(True)
              .iterate(_corpus(200)), pkg).build()
    w2v.fit()
    assert w2v.similarity("cat", "dog") > w2v.similarity("cat", "wheel")


@both
def test_word2vec_cbow_and_subsample(pkg):
    w2v = _on(PKGS[pkg].Word2Vec.builder()
              .layer_size(32).window_size(3).min_word_frequency(2)
              .negative_sample(5).epochs(10).learning_rate(0.05)
              .seed(42).batch_size(512).cbow(True).sampling(1e-2)
              .iterate(_corpus()), pkg).build()
    w2v.fit()
    assert w2v.similarity("cat", "dog") > w2v.similarity("cat", "truck")


@both
def test_paragraph_vectors_dm(pkg):
    sentences = _corpus(150)
    pv = _on(PKGS[pkg].ParagraphVectors.builder()
             .layer_size(24).window_size(3).min_word_frequency(2)
             .negative_sample(5).epochs(6).seed(11).dm(True)
             .documents(sentences, _labels(sentences)), pkg).build()
    pv.fit()
    assert pv.nearest_labels("cat dog pet", 1) == ["animal"]


@both
def test_cooccurrence_vectorized_and_spilled(pkg):
    """AbstractCoOccurrences: the vectorized counter must equal the
    per-token reference loop (1/d weighting, symmetric), and disk-spilled
    shards (reference models/glove/count/) must merge to the same counts."""
    AbstractCoOccurrences = PKGS[pkg].AbstractCoOccurrences
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, 20, rng.integers(2, 30)).astype(np.int64)
            for _ in range(40)]
    ref = {}
    W = 5
    for seq in seqs:
        for i in range(len(seq)):
            for j in range(max(0, i - W), i):
                wgt = 1.0 / (i - j)
                a, b = int(seq[i]), int(seq[j])
                ref[(a, b)] = ref.get((a, b), 0.0) + wgt
                ref[(b, a)] = ref.get((b, a), 0.0) + wgt
    got = AbstractCoOccurrences(window=W).fit(seqs).counts
    assert set(got) == set(ref)
    for k in ref:  # counts accumulate in f64, emit in f32
        assert abs(got[k] - ref[k]) <= 1e-6 * max(1.0, abs(ref[k]))

    spilled = AbstractCoOccurrences(window=W, max_pairs_in_memory=50)
    spilled.fit(seqs[:20])
    spilled.fit(seqs[20:])
    assert spilled._shards  # actually spilled to disk
    got2 = spilled.counts
    for k in ref:
        assert abs(got2[k] - ref[k]) <= 1e-6 * max(1.0, abs(ref[k]))


@both
def test_cooccurrence_incremental_vocab_growth(pkg, tmp_path):
    """Incremental fits may introduce new token ids; stored keys re-base
    (or pass vocab_size up front). Shared spill dirs must not collide."""
    AbstractCoOccurrences = PKGS[pkg].AbstractCoOccurrences
    a = AbstractCoOccurrences(window=2)
    a.fit([np.array([0, 1, 0])])
    a.fit([np.array([0, 5, 0])])  # vocab grew: keys re-based, no error
    got = a.counts
    assert got[(0, 1)] > 0 and got[(0, 5)] > 0

    # two counters sharing one spill dir keep distinct shards
    d = str(tmp_path)
    c1 = AbstractCoOccurrences(window=2, max_pairs_in_memory=1, spill_dir=d,
                               vocab_size=10)
    c2 = AbstractCoOccurrences(window=2, max_pairs_in_memory=1, spill_dir=d,
                               vocab_size=10)
    c1.fit([np.array([0, 1, 2, 3])])
    c2.fit([np.array([4, 5, 6, 7])])
    k1 = set(c1.counts)
    k2 = set(c2.counts)
    assert k1 and k2 and not (k1 & k2)  # no shard cross-talk


@both
def test_word2vec_scan_path_quality(pkg):
    """The chunk path (engaged when an epoch has >= 64*batch pairs) must
    learn the same structure as the per-batch path."""
    w2v = _on(PKGS[pkg].Word2Vec.builder()
              .layer_size(32).window_size(3).min_word_frequency(2)
              .negative_sample(5).epochs(6).learning_rate(0.05)
              .seed(42).batch_size(32).iterate(_corpus(400)), pkg).build()
    w2v.fit()
    assert w2v._chunk_counter > 0  # the chunk path actually ran
    assert w2v.similarity("cat", "dog") > w2v.similarity("cat", "truck")
    assert w2v.similarity("car", "truck") > w2v.similarity("car", "paw")


# -- the port's own ------------------------------------------------------------
def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Every entry point that holds tables takes ``device``, defaults to
    "cuda" and raises where there is no card; nothing carries on on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = PKGS["port"]
    p = tmp_path / "v.txt"
    p.write_text("1 2\nw 0.5 0.25\n")
    pb = tmp_path / "v.bin"
    pb.write_bytes(b"1 2\nw " + np.float32([0.5, 0.25]).tobytes() + b"\n")
    for make in (lambda: m.Word2Vec.builder().build(),
                 lambda: m.Glove.builder().build(),
                 lambda: m.ParagraphVectors.builder().build(),
                 lambda: m.DeepWalk.builder().build(),
                 lambda: t_word2vec.SequenceVectors(),
                 lambda: t_word2vec.InMemoryLookupTable(4, 2),
                 lambda: m.wvserde.load_txt_vectors(p),
                 lambda: m.wvserde.load_binary_vectors(pb)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    cpu = m.wvserde.load_txt_vectors(p, device="cpu")
    assert cpu.lookup_table.syn0.device.type == "cpu"
    np.testing.assert_array_equal(cpu.word_vector("w"), [0.5, 0.25])


def test_chunk_path_bookkeeping():
    """The chunk path's draws come through ``draws`` once per chunk, one
    [64, B, K] table of indices into the unigram table; its learning rates
    decay per batch as JAX's (:328-333), and the last real batch's loss
    is the fit's score."""
    calls = []
    inner = {}

    class Recording(t_word2vec.GeneratorDraws):
        def chunk(self, chunk, shape, high, device):
            calls.append((chunk, tuple(shape), high))
            return super().chunk(chunk, shape, high, device)

    w2v = (t_word2vec.Word2Vec.builder().layer_size(8).window_size(3)
           .negative_sample(3).epochs(1).seed(4).batch_size(16)
           .device("cpu").iterate(_corpus(300)).build())
    gen = torch.Generator()
    gen.manual_seed(5)
    w2v.draws = Recording(gen)
    orig = w2v._train_chunk

    def spy(cs, ts, valids, lrs):
        inner.setdefault("lrs", []).append(lrs.copy())
        inner.setdefault("real", []).append(int(valids.sum()))
        return orig(cs, ts, valids, lrs)
    w2v._train_chunk = spy
    w2v.fit()
    n = len(calls)
    assert n == w2v._chunk_counter >= 2
    assert [c[0] for c in calls] == list(range(1, n + 1))
    assert all(c[1] == (64, 16, 3) and c[2] == w2v._neg_table.size
               for c in calls)
    lrs = np.concatenate(inner["lrs"])
    assert np.all(np.diff(lrs) <= 0) and lrs[0] == np.float32(0.025)
    assert lrs[-1] < lrs[0] and lrs.min() >= np.float32(1e-4)
    assert all(r == 64 * 16 for r in inner["real"][:-1])
    assert 0 < inner["real"][-1] <= 64 * 16
    assert np.isfinite(w2v.score_)


def test_padding_adds_nothing_to_row_zero():
    """Padding gives index 0 with valid 0: the padded rows add nothing to
    row 0's gradient, so a batch of only padding leaves every table as it
    was, and a half-padded batch equals its real half."""
    rng = np.random.default_rng(1)
    V, D, K, B = 12, 4, 3, 8
    syn0 = rng.standard_normal((V, D)).astype(np.float32)
    syn1 = rng.standard_normal((V, D)).astype(np.float32)
    c = rng.integers(1, V, B)
    t = rng.integers(1, V, B)
    negs = rng.integers(1, V, (B, K))
    valid = np.ones(B, np.float32)

    def run(c, t, negs, valid):
        s = t_word2vec.SequenceVectors(device="cpu", grad_clip=0.1)
        s.lookup_table = t_word2vec.InMemoryLookupTable.from_numpy(
            syn0, None, syn1, "cpu")
        s._step("neg", (c, t, negs, valid), np.float32(0.5))
        return s.lookup_table.syn0.numpy(), s.lookup_table.syn1neg.numpy()

    z = np.zeros(B, np.int64)
    zero = run(z, z, np.zeros((B, K), np.int64), np.zeros(B, np.float32))
    np.testing.assert_array_equal(zero[0], syn0)
    np.testing.assert_array_equal(zero[1], syn1)
    half = run(np.r_[c[:4], z[:4]], np.r_[t[:4], z[:4]],
               np.r_[negs[:4], np.zeros((4, K), np.int64)],
               np.r_[valid[:4], np.zeros(4, np.float32)])
    real = run(c[:4], t[:4], negs[:4], valid[:4])
    np.testing.assert_array_equal(half[0], real[0])
    np.testing.assert_array_equal(half[1], real[1])


def test_deepwalk_hierarchic_softmax_and_weighted_walks():
    """DeepWalk over HS (the GraphHuffman analog) on the port; weighted
    walks follow the edge weights and equal the JAX copy's walks."""
    g = _two_cluster_graph(PKGS["port"])
    dw = (t_deepwalk.DeepWalk.builder().vector_size(16).window_size(3)
          .walk_length(20).walks_per_vertex(8).epochs(5).seed(2)
          .negative_sample(0).use_hierarchic_softmax(True).device("cpu")
          .build())
    dw.fit(g)
    assert dw.similarity(1, 2) > dw.similarity(1, 8)
    assert dw.vertex_vector(3).shape == (16,)
    assert len(dw.verts_nearest(1, 4)) == 4
    gj, gt = j_graph.Graph(5), t_graph.Graph(5)
    for a, b, w in ((0, 1, 5.0), (1, 2, 0.5), (2, 3, 1.0), (3, 4, 2.0),
                    (4, 0, 1.0)):
        gj.add_edge(a, b, w)
        gt.add_edge(a, b, w)
    assert (list(j_graph.WeightedRandomWalkIterator(gj, 8, 3, 2))
            == list(t_graph.WeightedRandomWalkIterator(gt, 8, 3, 2)))


def test_refit_uploads_the_new_vocab_table():
    """A second fit on another corpus trains on its own vocab's unigram
    table: the chunk path uploads it anew (indices into the first fit's
    table could name rows the second vocab lacks)."""
    big = [" ".join(f"w{i % 40}" for i in range(j, j + 12))
           for j in range(300)]
    w2v = (t_word2vec.Word2Vec.builder().layer_size(8).window_size(3)
           .negative_sample(3).epochs(1).seed(4).batch_size(16)
           .device("cpu").iterate(big).build())
    w2v.fit()
    first = w2v._chunk_counter
    assert first > 0 and w2v.vocab.num_words() == 40
    w2v._iterator = t_word2vec.CollectionSentenceIterator(_corpus(400))
    w2v.fit()
    assert w2v.vocab.num_words() == 10
    assert w2v._chunk_counter > first
    np.testing.assert_array_equal(w2v._neg_table_dev.numpy(),
                                  w2v._neg_table)
    assert np.isfinite(w2v.score_)
