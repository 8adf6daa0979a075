"""Dataset fetchers — port of deeplearning4j_tpu/datasets/fetchers.py:
Iris, MNIST, CIFAR-10, LFW and Curves, their iterators, and the IDX
readers.

Offline first. MNIST and CIFAR-10 load from files under `data_dir()`
(``DL4J_TPU_DATA_DIR``, default ``~/.dl4j_tpu_data``) when present
(``mnist/`` IDX files, gzipped or not; ``cifar-10-batches-py/``), and
MNIST downloads only where `downloader.downloads_enabled()`. Otherwise:

- MNIST falls back to the 8x8 handwritten digits upscaled to 28x28, as
  the JAX package does through scikit-learn's `load_digits`. The port
  keeps its own byte-for-byte copy of that file,
  ``datasets/data/digits.csv.gz`` (57,523 bytes, from scikit-learn
  1.9.0, BSD-3-Clause; the UCI Optical Recognition of Handwritten Digits
  test set: 1,797 rows of 64 pixel counts 0-16 and the digit), parsed
  as scikit-learn does, so the stand-in equals the JAX package's bit for
  bit with nothing else installed. Its ``source`` is
  "sklearn_digits_8x8_upscaled".
- CIFAR-10 falls back to the JAX package's seeded synthetic
  class-structured set ("synthetic_class_structured").
- LFW reads ``lfw/<person>/<image>`` under `data_dir()` (with PIL), else
  scikit-learn's LFW cache where scikit-learn imports and the cache
  exists (nothing is downloaded), else the JAX package's seeded
  synthetic faces.
- Curves is generated from its seed, as in the JAX package.

The JAX package keeps its Iris through scikit-learn's `load_iris`. The
port keeps its own byte-for-byte copy of that 150-row CSV
(``datasets/data/iris.csv``: a header ``150,4,<class names>``, then four
features and the class index per row) and parses it as scikit-learn
does (float64 features, int classes), so `load_iris_dataset` gives the
JAX package's arrays bit for bit.
"""
from __future__ import annotations

import csv
import gzip
import io
import os
import pickle
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .dataset import DataSet
from .iterators import ListDataSetIterator

IRIS_CSV = Path(__file__).with_name("data") / "iris.csv"
DIGITS_CSV_GZ = Path(__file__).with_name("data") / "digits.csv.gz"


def data_dir() -> Path:
    return Path(os.environ.get("DL4J_TPU_DATA_DIR",
                               Path.home() / ".dl4j_tpu_data"))


def one_hot(labels: np.ndarray, n_classes: int) -> np.ndarray:
    out = np.zeros((labels.shape[0], n_classes), np.float32)
    out[np.arange(labels.shape[0]), labels.astype(int)] = 1.0
    return out


def _read_iris():
    """(features [150, 4] float64, classes [150] int) of the CSV."""
    with open(IRIS_CSV, newline="") as f:
        rows = csv.reader(f)
        head = next(rows)
        n, n_features = int(head[0]), int(head[1])
        data = np.empty((n, n_features), np.float64)
        target = np.empty((n,), int)
        for i, row in enumerate(rows):
            data[i] = np.asarray(row[:-1], dtype=np.float64)
            target[i] = np.asarray(row[-1], dtype=int)
    return data, target


def load_iris_dataset(shuffle_seed: Optional[int] = 12345) -> DataSet:
    """Iris with each feature standardised (f32) and one-hot classes,
    shuffled by ``shuffle_seed`` (None: file order) — JAX :84."""
    data, target = _read_iris()
    x = data.astype(np.float32)
    x = (x - x.mean(axis=0)) / x.std(axis=0)
    ds = DataSet(x, one_hot(target, 3))
    if shuffle_seed is not None:
        ds.shuffle(shuffle_seed)
    return ds


class IrisDataSetIterator(ListDataSetIterator):
    """Minibatches of the first ``num_examples`` shuffled Iris rows (JAX
    :98)."""

    def __init__(self, batch: int = 150, num_examples: int = 150,
                 seed: int = 12345):
        ds = load_iris_dataset(seed)
        ds = DataSet(ds.features[:num_examples], ds.labels[:num_examples])
        super().__init__(ds, batch)


# -- IDX format ----------------------------------------------------------------

def _read_bytes(path: Path) -> bytes:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def read_idx(path: Path) -> np.ndarray:
    """An IDX file (gzipped or not) as an array of its own dtype."""
    return _read_idx_py(io.BytesIO(_read_bytes(path)))


def read_idx_f32(path: Path, scale: float = 1.0) -> np.ndarray:
    """An IDX file as float32 times ``scale`` (JAX :45, whose native
    decoder the port does without)."""
    return read_idx(path).astype(np.float32) * scale


def read_idx_header(f):
    """(dtype code, dims) of the IDX header at the start of a binary
    stream."""
    zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
    if zero != 0:
        raise ValueError("bad IDX magic")
    dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
    return dtype_code, dims


def _read_idx_py(f) -> np.ndarray:
    dtype_code, dims = read_idx_header(f)
    dtype = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
             0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64}[dtype_code]
    data = np.frombuffer(f.read(), dtype=np.dtype(dtype).newbyteorder(">"))
    return data.reshape(dims)


# -- MNIST ---------------------------------------------------------------------

_MNIST_FILES = {
    "train_images": ("train-images-idx3-ubyte", "train-images-idx3-ubyte.gz"),
    "train_labels": ("train-labels-idx1-ubyte", "train-labels-idx1-ubyte.gz"),
    "test_images": ("t10k-images-idx3-ubyte", "t10k-images-idx3-ubyte.gz"),
    "test_labels": ("t10k-labels-idx1-ubyte", "t10k-labels-idx1-ubyte.gz"),
}


def _find_mnist(train: bool) -> Optional[Tuple[Path, Path]]:
    base = data_dir() / "mnist"
    img_key = "train_images" if train else "test_images"
    lab_key = "train_labels" if train else "test_labels"
    for img_name in _MNIST_FILES[img_key]:
        for lab_name in _MNIST_FILES[lab_key]:
            ip, lp = base / img_name, base / lab_name
            if ip.exists() and lp.exists():
                return ip, lp
    from .downloader import fetch_mnist
    return fetch_mnist(base, train)


def _load_digits():
    """(images [1797, 8, 8] float64, digits [1797] int) of the packaged
    CSV, parsed as scikit-learn's `load_digits` parses its copy."""
    with gzip.open(DIGITS_CSV_GZ, "rt", encoding="utf-8") as f:
        data = np.loadtxt(f, delimiter=",")
    return data[:, :-1].reshape(-1, 8, 8), data[:, -1].astype(int)


def _digits_as_mnist(num: int, train: bool, binarize: bool) -> DataSet:
    """The 8x8 digits upscaled to 28x28 (JAX :132): the first 1500 for
    training, the other 297 for test, tiled to ``num``."""
    images, target = _load_digits()
    x8 = images.astype(np.float32) / 16.0
    if train:
        x8, y = x8[:1500], target[:1500]
    else:
        x8, y = x8[1500:], target[1500:]
    reps = int(np.ceil(num / x8.shape[0]))
    x8 = np.tile(x8, (reps, 1, 1))[:num]
    y = np.tile(y, reps)[:num]
    # 8x8 -> 24x24 by pixel repetition, padded to 28x28
    x28 = np.pad(x8.repeat(3, axis=1).repeat(3, axis=2),
                 ((0, 0), (2, 2), (2, 2)))
    if binarize:
        x28 = (x28 > 0.5).astype(np.float32)
    return DataSet(x28.reshape(num, 784), one_hot(y, 10))


def load_mnist(num: int = 60000, train: bool = True,
               binarize: bool = False) -> DataSet:
    """MNIST [num, 784] in [0, 1] and one-hot labels, from the IDX files
    or the digits stand-in; ``source`` says which."""
    found = _find_mnist(train)
    if found is None:
        ds = _digits_as_mnist(num, train, binarize)
        ds.source = "sklearn_digits_8x8_upscaled"
        return ds
    images = read_idx_f32(found[0], scale=1.0 / 255.0)
    labels = read_idx(found[1])
    images, labels = images[:num], labels[:num]
    if binarize:
        images = (images > 0.5).astype(np.float32)
    ds = DataSet(images.reshape(images.shape[0], 784), one_hot(labels, 10))
    ds.source = "mnist_idx"
    return ds


class MnistDataSetIterator(ListDataSetIterator):
    """Minibatches of `load_mnist`, shuffled by ``seed`` (JAX :174)."""

    def __init__(self, batch: int, num_examples: int = 60000,
                 binarize: bool = False, train: bool = True,
                 shuffle: bool = True, seed: int = 123):
        ds = load_mnist(num_examples, train, binarize)
        if shuffle:
            ds.shuffle(seed)
        super().__init__(ds, batch)


# -- CIFAR-10 ------------------------------------------------------------------

def load_cifar10(num: int = 50000, train: bool = True) -> DataSet:
    """CIFAR-10 [num, 32*32*3] (NHWC rows in [0, 1]) from the python
    batches, else the seeded synthetic 32x32x3 class-structured set (JAX
    :189)."""
    base = data_dir() / "cifar-10-batches-py"
    files = ([base / f"data_batch_{i}" for i in range(1, 6)] if train
             else [base / "test_batch"])
    if all(f.exists() for f in files):
        xs, ys = [], []
        for f in files:
            with open(f, "rb") as fh:
                d = pickle.load(fh, encoding="bytes")
            xs.append(np.asarray(d[b"data"], np.float32) / 255.0)
            ys.append(np.asarray(d[b"labels"]))
        x = np.concatenate(xs)[:num]
        y = np.concatenate(ys)[:num]
        # stored as [N, 3*1024] channel-major; to NHWC
        x = x.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        ds = DataSet(x.reshape(x.shape[0], -1), one_hot(y, 10))
        ds.source = "cifar10_batches"
        return ds
    rng = np.random.default_rng(7)
    y = rng.integers(0, 10, num)
    # class-dependent colored blobs + noise: learnable but nontrivial
    base_img = rng.normal(0, 1, (10, 32, 32, 3)).astype(np.float32)
    x = base_img[y] * 0.5 + rng.normal(0, 0.5, (num, 32, 32, 3)).astype(
        np.float32)
    ds = DataSet(x.reshape(num, -1), one_hot(y, 10))
    ds.source = "synthetic_class_structured"
    return ds


class CifarDataSetIterator(ListDataSetIterator):
    """Minibatches of `load_cifar10` (JAX :223)."""

    def __init__(self, batch: int, num_examples: int = 50000,
                 train: bool = True):
        super().__init__(load_cifar10(num_examples, train), batch)


# -- LFW (Labeled Faces in the Wild) -------------------------------------------

def load_lfw(num: int = 1000, height: int = 28, width: int = 28,
             num_people: int = 20, seed: int = 42) -> DataSet:
    """Grayscale faces [num, height*width] and one-hot identities (JAX
    :232): ``lfw/<person>/<image>`` under `data_dir()`, else
    scikit-learn's LFW cache (never downloaded), else seeded synthetic
    faces (a base pattern per person plus noise)."""
    base = data_dir() / "lfw"
    if base.is_dir():
        people = sorted(p for p in base.iterdir() if p.is_dir())[:num_people]
        xs, ys = [], []
        for label, person in enumerate(people):
            for img_path in sorted(person.glob("*")):
                try:
                    from PIL import Image
                    img = Image.open(img_path).convert("L").resize(
                        (width, height))
                    xs.append(np.asarray(img, np.float32) / 255.0)
                    ys.append(label)
                except Exception:
                    continue
                if len(xs) >= num:
                    break
            if len(xs) >= num:
                break
        if xs:
            x = np.stack(xs)
            return DataSet(x.reshape(len(xs), -1),
                           one_hot(np.asarray(ys), len(people)))
    try:
        from sklearn.datasets import fetch_lfw_people
    except ImportError:
        fetch_lfw_people = None
    if fetch_lfw_people is not None:
        try:
            d = fetch_lfw_people(min_faces_per_person=20, resize=0.4,
                                 download_if_missing=False)
            # the num_people most frequent identities, resampled to
            # (height, width) by nearest neighbour
            people = np.argsort(-np.bincount(d.target))[:num_people]
            remap = {int(p): i for i, p in enumerate(people)}
            keep = np.isin(d.target, people)
            imgs = d.images[keep][:num].astype(np.float32)
            y = np.asarray([remap[int(t)] for t in d.target[keep][:num]])
            ih, iw = imgs.shape[1:]
            ri = (np.arange(height) * ih // height)[:, None]
            ci = (np.arange(width) * iw // width)[None, :]
            x = imgs[:, ri, ci]
            return DataSet(x.reshape(x.shape[0], -1), one_hot(y, num_people))
        except Exception:
            pass
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_people, num)
    base_faces = rng.normal(0.5, 0.2, (num_people, height, width)).astype(
        np.float32)
    base_faces = (base_faces + np.roll(base_faces, 1, 1)
                  + np.roll(base_faces, 1, 2)) / 3.0
    x = np.clip(base_faces[y] + rng.normal(0, 0.1, (num, height, width))
                .astype(np.float32), 0, 1)
    return DataSet(x.reshape(num, -1), one_hot(y, num_people))


class LFWDataSetIterator(ListDataSetIterator):
    """Minibatches of `load_lfw` (JAX :287)."""

    def __init__(self, batch: int, num_examples: int = 1000,
                 height: int = 28, width: int = 28, num_people: int = 20):
        super().__init__(load_lfw(num_examples, height, width, num_people),
                         batch)


# -- Curves --------------------------------------------------------------------

def load_curves(num: int = 10000, size: int = 28, seed: int = 7) -> DataSet:
    """Seeded cubic Bezier strokes rasterised to [size, size], labelled by
    the octant of their end-to-end direction (JAX :298)."""
    rng = np.random.default_rng(seed)
    xs = np.zeros((num, size, size), np.float32)
    ys = np.zeros(num, np.int64)
    t = np.linspace(0.0, 1.0, 64)
    for i in range(num):
        p = rng.uniform(0.15, 0.85, (4, 2))  # control points
        curve = ((1 - t)[:, None] ** 3 * p[0] + 3 * (1 - t)[:, None] ** 2
                 * t[:, None] * p[1] + 3 * (1 - t)[:, None] * t[:, None] ** 2
                 * p[2] + t[:, None] ** 3 * p[3])
        pix = np.clip((curve * size).astype(int), 0, size - 1)
        xs[i, pix[:, 1], pix[:, 0]] = 1.0
        d = p[3] - p[0]
        ys[i] = int(np.floor((np.arctan2(d[1], d[0]) + np.pi)
                             / (np.pi / 4))) % 8
    return DataSet(xs.reshape(num, -1), one_hot(ys, 8))


class CurvesDataSetIterator(ListDataSetIterator):
    """Minibatches of `load_curves` (JAX :319)."""

    def __init__(self, batch: int, num_examples: int = 10000):
        super().__init__(load_curves(num_examples), batch)
