"""Port parity: the downloader, the fetchers and the record readers
(datasets/downloader.py, fetchers.py, records.py).

  - the downloader cases of the JAX package's tests/test_downloader.py,
    against a loopback ThreadingHTTPServer only (nothing leaves the
    host), the fetched files read by both packages' IDX readers;
  - the IDX, gzipped IDX and CIFAR pickle branches of
    tests/test_real_data_paths.py on files fabricated in a tmp dir, read
    by both packages: the same arrays, bit for bit, and the same
    ``source`` labels;
  - with DL4J_TPU_DATA_DIR an empty tmp dir: the digits stand-in for
    MNIST (train and test, binarised too), the synthetic CIFAR-10, LFW
    and Curves sets, bit for bit the JAX package's;
  - the packaged digits file, byte for byte scikit-learn 1.9.0's;
  - every record reader and record iterator against the JAX package's on
    the same files: the same records and the same arrays, exact.
"""
import gzip
import hashlib
import pickle
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest

from deeplearning4j_tpu.datasets import fetchers as jf
from deeplearning4j_tpu.datasets import records as jr
from deeplearning4j_tpu_torch.datasets import downloader as tdl
from deeplearning4j_tpu_torch.datasets import fetchers as tf
from deeplearning4j_tpu_torch.datasets import records as tr

DIGITS_SHA256 = \
    "09f66e6debdee2cd2b5ae59e0d6abbb73fc2b0e0185d2e1957e9ebb51e23aa22"


def _idx_bytes(arr: np.ndarray) -> bytes:
    head = struct.pack(">HBB", 0, 0x08, arr.ndim)
    head += b"".join(struct.pack(">I", d) for d in arr.shape)
    return head + arr.astype(np.uint8).tobytes()


class _Server:
    """A loopback HTTP server of in-memory files."""

    def __init__(self, files):
        server = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                body = server.files.get(self.path.lstrip("/"))
                if body is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.files = files
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def url(self, name):
        return f"http://127.0.0.1:{self.port}/{name}"

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


# -- the downloader ----------------------------------------------------------------

def test_download_atomic_checksum_gunzip(tmp_path):
    payload = b"hello dataset " * 100
    srv = _Server({"plain.bin": payload,
                   "zipped.bin.gz": gzip.compress(payload)})
    try:
        p = tdl.download(srv.url("plain.bin"), tmp_path / "plain.bin",
                         sha256=hashlib.sha256(payload).hexdigest())
        assert p.read_bytes() == payload
        assert tdl.download(srv.url("plain.bin"), p, sha256="x") == p
        g = tdl.download(srv.url("zipped.bin.gz"), tmp_path / "unzipped.bin",
                         gunzip=True)
        assert g.read_bytes() == payload
        with pytest.raises(IOError):
            tdl.download(srv.url("plain.bin"), tmp_path / "bad.bin",
                         sha256="0" * 64)
        assert not (tmp_path / "bad.bin").exists()
        assert not list(tmp_path.glob("*.part"))
    finally:
        srv.stop()


def test_fetch_mnist_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 255, (10, 28, 28)).astype(np.uint8)
    labels = rng.integers(0, 10, (10,)).astype(np.uint8)
    srv = _Server({
        "train-images-idx3-ubyte.gz": gzip.compress(_idx_bytes(imgs)),
        "train-labels-idx1-ubyte.gz": gzip.compress(_idx_bytes(labels))})
    try:
        urls = {"train-images-idx3-ubyte":
                srv.url("train-images-idx3-ubyte.gz"),
                "train-labels-idx1-ubyte":
                srv.url("train-labels-idx1-ubyte.gz")}
        got = tdl.fetch_mnist(tmp_path, train=True, urls=urls,
                              allow_download=True)
        assert got is not None
        for read in (tf.read_idx, jf.read_idx):
            np.testing.assert_array_equal(read(got[0]), imgs)
            np.testing.assert_array_equal(read(got[1]), labels)
    finally:
        srv.stop()


def test_download_disabled_by_default(monkeypatch, tmp_path):
    monkeypatch.delenv("DL4J_TPU_DOWNLOAD", raising=False)
    assert not tdl.downloads_enabled()
    assert tdl.fetch_mnist(tmp_path, train=True) is None
    monkeypatch.setenv("DL4J_TPU_DOWNLOAD", "1")
    assert tdl.downloads_enabled()
    # enabled, but the loopback port refuses: None, the offline fallback
    with pytest.warns(UserWarning):
        assert tdl.fetch_mnist(tmp_path, train=True, urls={
            "train-images-idx3-ubyte": "http://127.0.0.1:9/none.gz",
            "train-labels-idx1-ubyte": "http://127.0.0.1:9/none.gz"}) is None


def test_fetch_mnist_rejects_corrupt_payload(tmp_path):
    srv = _Server({
        "train-images-idx3-ubyte.gz": gzip.compress(b"<html>mirror moved"),
        "train-labels-idx1-ubyte.gz": gzip.compress(b"nope")})
    try:
        urls = {"train-images-idx3-ubyte":
                srv.url("train-images-idx3-ubyte.gz"),
                "train-labels-idx1-ubyte":
                srv.url("train-labels-idx1-ubyte.gz")}
        with pytest.warns(UserWarning):
            assert tdl.fetch_mnist(tmp_path, train=True, urls=urls,
                                   allow_download=True) is None
        assert not list(tmp_path.glob("*ubyte*"))
    finally:
        srv.stop()


# -- the real-file branches ----------------------------------------------------------

@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    monkeypatch.delenv("DL4J_TPU_DOWNLOAD", raising=False)
    return tmp_path


def _same_ds(a, b):
    np.testing.assert_array_equal(a.features, b.features)
    np.testing.assert_array_equal(a.labels, b.labels)
    assert a.features.dtype == b.features.dtype
    assert getattr(a, "source", None) == getattr(b, "source", None)


def test_mnist_idx_branch(data_dir):
    rng = np.random.default_rng(0)
    base = data_dir / "mnist"
    base.mkdir()
    imgs = rng.integers(0, 256, (64, 28, 28)).astype(np.uint8)
    labs = rng.integers(0, 10, 64).astype(np.uint8)
    (base / "train-images-idx3-ubyte").write_bytes(_idx_bytes(imgs))
    (base / "train-labels-idx1-ubyte").write_bytes(_idx_bytes(labs))
    ds = tf.load_mnist(num=64, train=True)
    assert ds.source == "mnist_idx"
    assert ds.features.shape == (64, 784)
    np.testing.assert_allclose(ds.features[0], imgs[0].reshape(-1) / 255.0,
                               atol=1e-6)
    _same_ds(ds, jf.load_mnist(num=64, train=True))
    it = tf.MnistDataSetIterator(batch=32, num_examples=64)
    assert it.source == "mnist_idx"
    _same_ds(next(iter(it)), next(iter(jf.MnistDataSetIterator(
        batch=32, num_examples=64))))


def test_mnist_gzipped_idx_branch(data_dir):
    rng = np.random.default_rng(1)
    base = data_dir / "mnist"
    base.mkdir()
    imgs = rng.integers(0, 256, (16, 28, 28)).astype(np.uint8)
    labs = rng.integers(0, 10, 16).astype(np.uint8)
    (base / "t10k-images-idx3-ubyte.gz").write_bytes(
        gzip.compress(_idx_bytes(imgs)))
    (base / "t10k-labels-idx1-ubyte.gz").write_bytes(
        gzip.compress(_idx_bytes(labs)))
    ds = tf.load_mnist(num=16, train=False, binarize=True)
    assert ds.source == "mnist_idx" and ds.features.shape == (16, 784)
    _same_ds(ds, jf.load_mnist(num=16, train=False, binarize=True))
    with gzip.open(base / "t10k-images-idx3-ubyte.gz", "rb") as f:
        assert tf.read_idx_header(f) == (0x08, (16, 28, 28))


def test_cifar_pickle_batch_branch(data_dir):
    rng = np.random.default_rng(2)
    base = data_dir / "cifar-10-batches-py"
    base.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        data = rng.integers(0, 256, (20, 3 * 1024)).astype(np.uint8)
        labels = rng.integers(0, 10, 20).tolist()
        with open(base / name, "wb") as f:
            pickle.dump({b"data": data, b"labels": labels}, f)
    for train in (True, False):
        ds = tf.load_cifar10(num=100, train=train)
        assert ds.source == "cifar10_batches"
        assert 0.0 <= ds.features.min() and ds.features.max() <= 1.0
        _same_ds(ds, jf.load_cifar10(num=100, train=train))
    assert tf.CifarDataSetIterator(batch=50,
                                   num_examples=100).source == \
        "cifar10_batches"


# -- the offline stand-ins ------------------------------------------------------------

def test_packaged_digits_file_is_scikit_learns():
    data = tf.DIGITS_CSV_GZ.read_bytes()
    assert len(data) == 57523
    assert hashlib.sha256(data).hexdigest() == DIGITS_SHA256
    # where scikit-learn 1.9.0 is installed, its own file (found without
    # importing it)
    import importlib.metadata
    import importlib.util
    spec = importlib.util.find_spec("sklearn")
    if spec is None or importlib.metadata.version("scikit-learn") != "1.9.0":
        return
    theirs = Path(spec.submodule_search_locations[0]) / "datasets" / \
        "data" / "digits.csv.gz"
    assert theirs.read_bytes() == data


@pytest.mark.parametrize("train,binarize", [(True, False), (False, False),
                                            (True, True)])
def test_digits_stand_in_is_jax_bitwise(data_dir, train, binarize):
    num = 2000 if train else 400
    ds = tf.load_mnist(num=num, train=train, binarize=binarize)
    assert ds.source == "sklearn_digits_8x8_upscaled"
    _same_ds(ds, jf.load_mnist(num=num, train=train, binarize=binarize))
    _same_ds(next(iter(tf.MnistDataSetIterator(batch=100,
                                               num_examples=num))),
             next(iter(jf.MnistDataSetIterator(batch=100,
                                               num_examples=num))))


def test_synthetic_sets_are_jax_bitwise(data_dir):
    _same_ds(tf.load_cifar10(num=300), jf.load_cifar10(num=300))
    assert tf.load_cifar10(num=8).source == "synthetic_class_structured"
    _same_ds(tf.load_lfw(num=60, height=12, width=10, num_people=5),
             jf.load_lfw(num=60, height=12, width=10, num_people=5))
    _same_ds(tf.load_curves(num=40), jf.load_curves(num=40))
    for t_it, j_it in ((tf.LFWDataSetIterator(16, 40),
                        jf.LFWDataSetIterator(16, 40)),
                       (tf.CurvesDataSetIterator(16, 40),
                        jf.CurvesDataSetIterator(16, 40))):
        for a, b in zip(t_it, j_it):
            _same_ds(a, b)


def test_lfw_directory_branch(data_dir):
    from PIL import Image
    rng = np.random.default_rng(3)
    for person in ("ann", "bob", "cy"):
        d = data_dir / "lfw" / person
        d.mkdir(parents=True)
        for k in range(3):
            Image.fromarray(rng.integers(0, 256, (20, 16)).astype(
                np.uint8)).save(d / f"{k}.png")
    _same_ds(tf.load_lfw(num=7, height=10, width=8, num_people=3),
             jf.load_lfw(num=7, height=10, width=8, num_people=3))


# -- record readers -----------------------------------------------------------------

def _csv(tmp_path, name, rows):
    p = tmp_path / name
    p.write_text("\n".join(",".join(str(v) for v in r) for r in rows) + "\n")
    return p


def _same_batches(t_it, j_it):
    a, b = list(t_it), list(j_it)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        if hasattr(y, "features_masks"):
            for u, v in zip(x.features + x.labels, y.features + y.labels):
                np.testing.assert_array_equal(u, np.asarray(v))
            continue
        np.testing.assert_array_equal(x.features, y.features)
        np.testing.assert_array_equal(x.labels, y.labels)
        for m in ("features_mask", "labels_mask"):
            u, v = getattr(x, m), getattr(y, m)
            assert (u is None) == (v is None)
            if u is not None:
                np.testing.assert_array_equal(u, v)


def test_csv_and_list_string_readers(tmp_path):
    rng = np.random.default_rng(4)
    rows = [[*np.round(rng.normal(size=3), 4), int(rng.integers(0, 3))]
            for _ in range(11)]
    p = _csv(tmp_path, "d.csv", [["a", "b", "c", "y"]] + rows)
    t = tr.CSVRecordReader(skip_lines=1).initialize(p)
    j = jr.CSVRecordReader(skip_lines=1).initialize(p)
    assert list(t) == list(j)
    _same_batches(tr.RecordReaderDataSetIterator(t, 4, num_classes=3),
                  jr.RecordReaderDataSetIterator(j, 4, num_classes=3))
    _same_batches(tr.RecordReaderDataSetIterator(t, 5, label_index=0,
                                                 regression=True),
                  jr.RecordReaderDataSetIterator(j, 5, label_index=0,
                                                 regression=True))
    srows = [[str(v) for v in r] for r in rows]
    t = tr.ListStringRecordReader().initialize(srows)
    j = jr.ListStringRecordReader().initialize(srows)
    assert list(t) == list(j) == srows
    _same_batches(tr.RecordReaderDataSetIterator(t, 3),
                  jr.RecordReaderDataSetIterator(j, 3))


def test_sequence_reader_and_iterator(tmp_path):
    rng = np.random.default_rng(5)
    feats, labs = [], []
    for i, n in enumerate((4, 2, 5, 3, 1)):
        feats.append(_csv(tmp_path, f"f{i}.csv",
                          np.round(rng.normal(size=(n, 3)), 3).tolist()))
        labs.append(_csv(tmp_path, f"l{i}.csv",
                         rng.integers(0, 4, (n, 1)).tolist()))
    for with_labels, kw in ((True, {"num_classes": 4}), (True, {}),
                            (False, {})):
        tf_, jf_ = (tr.CSVSequenceRecordReader().initialize(feats),
                    jr.CSVSequenceRecordReader().initialize(feats))
        tl = tr.CSVSequenceRecordReader().initialize(labs) if with_labels \
            else None
        jl = jr.CSVSequenceRecordReader().initialize(labs) if with_labels \
            else None
        _same_batches(
            tr.SequenceRecordReaderDataSetIterator(tf_, tl, 2, **kw),
            jr.SequenceRecordReaderDataSetIterator(jf_, jl, 2, **kw))
    t = tr.CSVSequenceRecordReader().initialize(feats)
    j = jr.CSVSequenceRecordReader().initialize(feats)
    assert t.next_sequence() == j.next_sequence()


def test_image_reader(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(6)
    for label in ("cat", "dog"):
        (tmp_path / label).mkdir()
        for k in range(3):
            arr = rng.integers(0, 256, (6, 5, 3)).astype(np.uint8)
            if k == 0:
                np.save(tmp_path / label / f"{k}.npy",
                        (arr / 255.0).astype(np.float32))
            else:
                Image.fromarray(arr).save(tmp_path / label / f"{k}.png")
    t = tr.ImageRecordReader(6, 5, 3).initialize(tmp_path)
    j = jr.ImageRecordReader(6, 5, 3).initialize(tmp_path)
    assert t.labels == j.labels == ["cat", "dog"]
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]
    _same_batches(tr.RecordReaderDataSetIterator(t, 4, num_classes=2),
                  jr.RecordReaderDataSetIterator(j, 4, num_classes=2))


def test_multi_dataset_iterator(tmp_path):
    rng = np.random.default_rng(7)
    rows = [[f"id{i}", *np.round(rng.normal(size=4), 3),
             int(rng.integers(0, 3))] for i in range(9)]
    other = [[*np.round(rng.normal(size=2), 3)] for _ in range(9)]
    pa, pb = _csv(tmp_path, "a.csv", rows), _csv(tmp_path, "b.csv", other)

    def build(mod):
        return (mod.RecordReaderMultiDataSetIterator.builder(batch_size=4)
                .add_reader("a", mod.CSVRecordReader().initialize(pa))
                .add_reader("b", mod.CSVRecordReader().initialize(pb))
                .add_input("a", 1, 4)
                .add_input("b")
                .add_output_one_hot("a", 5, 3)
                .add_output("b", 0, 0)
                .build())
    _same_batches(build(tr), build(jr))
    with pytest.raises(ValueError):
        (tr.RecordReaderMultiDataSetIterator.builder(2)
         .add_input("missing", 0, 1).build())
