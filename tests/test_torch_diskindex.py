"""Port parity: the disk-backed inverted index (nlp/diskindex.py), a
host-only copy of the JAX package's.

The small cases of tests/test_diskindex.py run against both packages
(``pkg``); an index written by either package opens in the other with the
same answers and the same files, byte for byte; and the million-document
case runs once, against the port's index, in a fresh subprocess with
bounded peak RSS.
"""
import subprocess
import sys
from pathlib import Path

import pytest

from deeplearning4j_tpu.nlp.diskindex import DiskInvertedIndex as JIndex
from deeplearning4j_tpu.nlp.invertedindex import InvertedIndex as JMem
from deeplearning4j_tpu_torch.nlp.diskindex import DiskInvertedIndex as TIndex
from deeplearning4j_tpu_torch.nlp.invertedindex import InvertedIndex as TMem

PKGS = {"jax": (JIndex, JMem), "port": (TIndex, TMem)}
both = pytest.mark.parametrize("pkg", list(PKGS))

DOCS = [
    ["the", "quick", "brown", "fox"],
    ["the", "lazy", "dog"],
    ["quick", "quick", "fox"],
    ["a", "dog", "and", "a", "fox"],
    [],
]


def _build(index_cls, path, flush_every=4):
    idx = index_cls(str(path), flush_every=flush_every)
    for i, d in enumerate(DOCS):
        idx.add_document(d, label=f"L{i}" if i % 2 == 0 else None)
    return idx.commit()


def _answers(idx):
    """Everything the query surface says about DOCS' index."""
    terms = idx.terms()
    return {"n": idx.num_documents(), "terms": terms,
            "postings": {w: (idx.documents(w), idx.doc_frequency(w))
                         for w in terms + ["missing"]},
            "tfidf": {(w, d): idx.tfidf(w, d) for w in terms
                      for d in range(len(DOCS))},
            "docs": [(idx.document(d), idx.document_label(d))
                     for d in range(len(DOCS))],
            "search": idx.search(["quick", "fox", "dog"], top_k=5)}


@both
def test_matches_in_memory_index(pkg, tmp_path):
    """Query-for-query parity with the in-memory InvertedIndex duck-type,
    including multi-segment spills (flush_every=4 forces several)."""
    index_cls, mem_cls = PKGS[pkg]
    disk = _build(index_cls, tmp_path / "ix")
    mem = mem_cls()
    for i, d in enumerate(DOCS):
        mem.add_document(d, label=f"L{i}" if i % 2 == 0 else None)
    assert disk.num_documents() == mem.num_documents()
    assert disk.terms() == mem.terms()
    for w in mem.terms() + ["missing"]:
        assert disk.documents(w) == mem.documents(w), w
        assert disk.doc_frequency(w) == mem.doc_frequency(w), w
        assert disk.doc_appeared_in_percent(w) == pytest.approx(
            mem.doc_appeared_in_percent(w))
        for d in range(len(DOCS)):
            assert disk.tfidf(w, d) == pytest.approx(mem.tfidf(w, d)), (w, d)
    for d in range(len(DOCS)):
        assert disk.document(d) == mem.document(d)
        assert disk.document_label(d) == mem.document_label(d)
    assert ([b for b in disk.batch_iter(2)]
            == [b for b in mem.batch_iter(2)])


@both
def test_reopen_and_search(pkg, tmp_path):
    index_cls = PKGS[pkg][0]
    _build(index_cls, tmp_path / "ix").close()
    idx = index_cls.open(str(tmp_path / "ix"))
    assert idx.num_documents() == 5
    hits = idx.search(["quick", "fox"], top_k=3)
    assert [d for d, _ in hits][0] == 2  # "quick quick fox" ranks first
    assert all(s > 0 for _, s in hits)
    assert idx.documents("dog") == [1, 3]


@both
def test_add_after_commit_rejected(pkg, tmp_path):
    idx = _build(PKGS[pkg][0], tmp_path / "ix")
    with pytest.raises(RuntimeError, match="committed"):
        idx.add_document(["x"])


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_index_opens_in_the_other_package(writer, reader, tmp_path):
    """The on-disk layout is shared: the files are the same bytes from
    either package, and an index written by one opens in the other with
    the writer's answers."""
    w_idx = _build(PKGS[writer][0], tmp_path / "w")
    want = _answers(w_idx)
    w_idx.close()
    r_idx = PKGS[reader][0].open(str(tmp_path / "w"))
    assert _answers(r_idx) == want
    r_idx.close()
    _build(PKGS[reader][0], tmp_path / "r").close()
    for name in ("docs.dat", "docs.idx", "postings.dat", "terms.dat"):
        assert ((tmp_path / "w" / name).read_bytes()
                == (tmp_path / "r" / name).read_bytes()), name


_MILLION_DOC_SCRIPT = r"""
import os, resource, sys, time
import numpy as np
sys.path.insert(0, sys.argv[2])
from deeplearning4j_tpu_torch.nlp.diskindex import DiskInvertedIndex

N = 1_000_000
V = 30_000
BLOCK = 100_000
rng = np.random.default_rng(0)
zipf = 1.0 / np.arange(1, V + 1) ** 0.9
zipf /= zipf.sum()
def rss():
    # current VmRSS, not ru_maxrss: a child forked from a large parent
    # starts with the parent's resident set as its "peak"
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return float("nan")

peak = 0.0
def sample():
    global peak
    peak = max(peak, rss())

sample()
print(f"rss_after_imports={rss():.0f}", flush=True)
idx = DiskInvertedIndex(sys.argv[1], flush_every=2_000_000)
t0 = time.time()
vocab = np.array([f"w{i}" for i in range(V)])
done = 0
while done < N:  # generate per block: bounds the generator's own RSS too
    nblk = min(BLOCK, N - done)
    lens = rng.integers(4, 13, nblk)
    flat = rng.choice(V, size=int(lens.sum()), p=zipf)
    pos = 0
    for n in lens:
        idx.add_document(vocab[flat[pos:pos + n]].tolist())
        pos += n
    done += nblk
    sample()  # per block: catches the pre-spill postings-buffer high water
print(f"rss_after_add={rss():.0f}", flush=True)
idx.commit()
sample()
print(f"rss_after_commit={rss():.0f}", flush=True)
build_s = time.time() - t0
assert idx.num_documents() == N
hits = idx.search(["w0", "w17", "w123"], top_k=5)
assert len(hits) == 5 and hits[0][1] >= hits[-1][1] > 0
d0 = hits[0][0]
assert idx.tfidf("w0", d0) >= 0.0
df = idx.doc_frequency("w0")
assert 0 < df <= N
doc = idx.document(d0)
assert 4 <= len(doc) <= 12
sample()
print(f"OK build_s={build_s:.1f} rss_mb={peak:.0f} df_w0={df}", flush=True)
"""


def test_million_documents_bounded_memory(tmp_path):
    """Index 1e6 docs (~8e6 postings) with the port's index in a fresh
    subprocess; peak RSS must stay far below what resident postings and
    documents would need, and the committed index reopens."""
    script = tmp_path / "index_million.py"
    script.write_text(_MILLION_DOC_SCRIPT)
    repo = str(Path(__file__).resolve().parent.parent)
    out = None
    for attempt in (1, 2):  # retry only signal deaths (an OOM kill under
        # host memory pressure); an index fault exits positive at once
        out = subprocess.run(
            [sys.executable, str(script), str(tmp_path / "bigix"), repo],
            capture_output=True, text=True, timeout=900)
        if out.returncode >= 0:
            break
        import shutil
        shutil.rmtree(tmp_path / "bigix", ignore_errors=True)
    assert out.returncode == 0, (out.stdout[-500:], out.stderr[-2000:])
    assert "OK" in out.stdout, out.stdout[-500:]
    rss_mb = float(out.stdout.split("rss_mb=")[1].split()[0])
    assert rss_mb < 800, (f"peak RSS {rss_mb} MB — memory not bounded; "
                          f"stages: {out.stdout[:300]}")
    idx = TIndex.open(str(tmp_path / "bigix"))
    assert idx.num_documents() == 1_000_000
    assert idx.doc_frequency("w0") > 0
    idx.close()
