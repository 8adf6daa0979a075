"""Dataset download — port of deeplearning4j_tpu/datasets/downloader.py.

Off unless ``DL4J_TPU_DOWNLOAD=1`` is set (or a caller passes
``allow_download=True``): the fetchers then fetch MNIST's IDX archives
when no local copy exists. A download is atomic (a per-call temporary
name, then a rename), optionally checked against a sha256, and
optionally gunzipped; a fetched IDX file is checked for its magic, rank
and payload size, and deleted when it fails.
"""
from __future__ import annotations

import gzip
import hashlib
import os
import shutil
import urllib.request
import uuid
import warnings
from pathlib import Path
from typing import Optional

#: the JAX package's MNIST sources
MNIST_URLS = {
    "train-images-idx3-ubyte": "https://storage.googleapis.com/cvdf-datasets/mnist/train-images-idx3-ubyte.gz",
    "train-labels-idx1-ubyte": "https://storage.googleapis.com/cvdf-datasets/mnist/train-labels-idx1-ubyte.gz",
    "t10k-images-idx3-ubyte": "https://storage.googleapis.com/cvdf-datasets/mnist/t10k-images-idx3-ubyte.gz",
    "t10k-labels-idx1-ubyte": "https://storage.googleapis.com/cvdf-datasets/mnist/t10k-labels-idx1-ubyte.gz",
}


def downloads_enabled() -> bool:
    return os.environ.get("DL4J_TPU_DOWNLOAD", "0") == "1"


def download(url: str, dest: Path, sha256: Optional[str] = None,
             gunzip: bool = False, timeout: float = 30.0) -> Path:
    """Fetch ``url`` to ``dest`` (kept if it exists), check the sha256,
    optionally gunzip. No partial file is left behind on failure."""
    dest = Path(dest)
    if dest.exists():
        return dest
    dest.parent.mkdir(parents=True, exist_ok=True)
    tag = uuid.uuid4().hex[:12]
    tmp = dest.with_name(f".{dest.name}.{tag}.part")
    plain = dest.with_name(f".{dest.name}.{tag}.plain")
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp, \
                open(tmp, "wb") as out:
            shutil.copyfileobj(resp, out)
        if sha256 is not None:
            h = hashlib.sha256(tmp.read_bytes()).hexdigest()
            if h != sha256:
                raise IOError(f"checksum mismatch for {url}: {h} != {sha256}")
        if gunzip:
            with gzip.open(tmp, "rb") as fin, open(plain, "wb") as fout:
                shutil.copyfileobj(fin, fout)
            os.replace(plain, dest)
        else:
            os.replace(tmp, dest)
        return dest
    finally:
        tmp.unlink(missing_ok=True)
        plain.unlink(missing_ok=True)


_failed_urls: set = set()  # URLs that failed in this process


def fetch_mnist(data_dir: Path, train: bool = True,
                urls: Optional[dict] = None,
                allow_download: Optional[bool] = None) -> Optional[tuple]:
    """Download the MNIST IDX pair into ``data_dir`` if allowed: (images
    path, labels path), or None when downloads are off or fail (the
    caller falls back to the offline stand-in; a failure after opting in
    warns)."""
    if allow_download is None:
        allow_download = downloads_enabled()
    if not allow_download:
        return None
    urls = urls or MNIST_URLS
    prefix = "train" if train else "t10k"
    img_name = f"{prefix}-images-idx3-ubyte"
    lbl_name = f"{prefix}-labels-idx1-ubyte"
    img_url, lbl_url = urls[img_name], urls[lbl_name]
    if img_url in _failed_urls or lbl_url in _failed_urls:
        return None
    try:
        # the server's .gz form is kept: the IDX readers open .gz
        img_dest = Path(data_dir) / (
            img_name + (".gz" if img_url.endswith(".gz") else ""))
        lbl_dest = Path(data_dir) / (
            lbl_name + (".gz" if lbl_url.endswith(".gz") else ""))
        img = download(img_url, img_dest)
        _verify_idx(img, ndim=3)
        lbl = download(lbl_url, lbl_dest)
        _verify_idx(lbl, ndim=1)
        return img, lbl
    except Exception as e:
        _failed_urls.update((img_url, lbl_url))
        warnings.warn(f"MNIST download failed ({e!r}); falling back to the "
                      "offline digits stand-in. Unset DL4J_TPU_DOWNLOAD or "
                      "fix connectivity to silence this.")
        return None


def _verify_idx(path: Path, ndim: int) -> None:
    """A u8 IDX file of rank ``ndim`` whose payload is the size its
    header declares, else deleted and IOError."""
    opener = gzip.open if str(path).endswith(".gz") else open
    try:
        with opener(path, "rb") as f:
            from .fetchers import read_idx_header
            dtype_code, dims = read_idx_header(f)
            if dtype_code != 0x08 or len(dims) != ndim:
                raise IOError(f"{path}: not a u8 rank-{ndim} IDX file")
            want = 1
            for d in dims:
                want *= d
            got = 0
            while True:
                chunk = f.read(1 << 20)
                if not chunk:
                    break
                got += len(chunk)
            if got != want:
                raise IOError(f"{path}: payload {got} != declared {want}")
    except Exception:
        path.unlink(missing_ok=True)
        raise
