"""Dataset factory (port of ``fedtorch_tpu/data/datasets.py``).

The loaders that need only numpy, each the JAX package's, so the arrays
are equal: the MNIST family (idx files), CIFAR-10/100 (the python pickle
batches, normalised to NHWC with ``MEAN_STD``), STL-10 (binary), the
synthetic tasks, and the LibSVM datasets through a numpy svmlight parser
that takes what the JAX package's native parser takes and refuses what
it refuses. Every loader returns :class:`DatasetSplits` of numpy arrays.

Refused by name, with the reason:

- ``emnist``, ``emnist_full`` and ``shakespeare``: their TFF files are
  HDF5, read through ``h5py``;
- ``adult``, and svmlight text the numpy parser rejects: the JAX package
  reads them through ``sklearn`` (``StandardScaler``, its svmlight
  fallback);
- ``download=True``: the machines the port is built and tested on have
  no network, so a fetch could never be tested. Place the files under
  ``data_dir``.

A missing file raises the JAX package's error, which names the expected
files and their source.
"""
from __future__ import annotations

import bz2
import gzip
import os
import pickle
import struct
from typing import List, NamedTuple, Optional

import numpy as np

from fedtorch_tpu_torch.config import DataConfig
from fedtorch_tpu_torch.data.synthetic import generate_synthetic

MEAN_STD = {
    # channel mean/std used by the reference transforms
    # (preprocess_toolkit.py:84-121 presets).
    "cifar10": ((0.4914, 0.4822, 0.4465), (0.2470, 0.2435, 0.2616)),
    "cifar100": ((0.5071, 0.4865, 0.4409), (0.2673, 0.2564, 0.2762)),
    "mnist": ((0.1307,), (0.3081,)),
    "fashion_mnist": ((0.286,), (0.353,)),
}

URLS = {
    "mnist": "http://yann.lecun.com/exdb/mnist/",
    "fashion_mnist": "http://fashion-mnist.s3-website.eu-central-1"
                     ".amazonaws.com/",
    "cifar10": "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz",
    "cifar100": "https://www.cs.toronto.edu/~kriz/cifar-100-python.tar.gz",
    "stl10": "http://ai.stanford.edu/~acoates/stl10/stl10_binary.tar.gz",
    "libsvm": "https://www.csie.ntu.edu.tw/~cjlin/libsvmtools/datasets/",
}

# datasets whose readers need a package the port does not use
_REFUSED = {
    "emnist": "its TFF files are HDF5 and need h5py",
    "emnist_full": "its TFF files are HDF5 and need h5py",
    "shakespeare": "its TFF files are HDF5 and need h5py",
    "adult": "its loader encodes and standardises through pandas and "
             "sklearn",
}


class DatasetSplits(NamedTuple):
    train_x: np.ndarray
    train_y: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray
    # natural per-client partitions of the train arrays (index lists),
    # None for centrally-partitioned datasets
    client_partitions: Optional[List[np.ndarray]] = None
    # metadata for fair partitioning (adult)
    sensitive_values: Optional[np.ndarray] = None


def _missing(dataset: str, path: str) -> FileNotFoundError:
    return FileNotFoundError(
        f"{dataset}: expected local data at {path}. This environment has "
        f"no network egress; place the files there manually (source: "
        f"{URLS.get(dataset, URLS['libsvm'])}) or run with download=True "
        f"where networking exists.")


# -- MNIST-family (idx format) ---------------------------------------------

def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def load_mnist_family(dataset: str, data_dir: str) -> DatasetSplits:
    base = os.path.join(data_dir, dataset)
    names = {
        "train_x": "train-images-idx3-ubyte",
        "train_y": "train-labels-idx1-ubyte",
        "test_x": "t10k-images-idx3-ubyte",
        "test_y": "t10k-labels-idx1-ubyte",
    }

    def find(stem):
        for suffix in ("", ".gz"):
            p = os.path.join(base, stem + suffix)
            if os.path.exists(p):
                return p
        raise _missing(dataset, os.path.join(base, stem + "[.gz]"))

    arrays = {k: _read_idx(find(v)) for k, v in names.items()}
    mean, std = MEAN_STD[dataset]

    def norm(x):
        return ((x.astype(np.float32) / 255.0 - mean[0]) / std[0])[..., None]

    return DatasetSplits(
        train_x=norm(arrays["train_x"]),
        train_y=arrays["train_y"].astype(np.int64),
        test_x=norm(arrays["test_x"]),
        test_y=arrays["test_y"].astype(np.int64))


# -- CIFAR (pickle batches) -------------------------------------------------

def load_cifar(dataset: str, data_dir: str) -> DatasetSplits:
    """The extracted python-pickle tree (``cifar-10-batches-py`` or
    ``cifar-100-python``); the JAX package also extracts the archive when
    only the archive is there, the port asks for the extracted tree."""
    sub = "cifar-10-batches-py" if dataset == "cifar10" else "cifar-100-python"
    base = os.path.join(data_dir, sub)
    if not os.path.isdir(base):
        raise _missing(dataset, base)

    def load_batch(name, label_key):
        # the pickle batches are the dataset's own files, read as the
        # JAX package reads them
        with open(os.path.join(base, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        return d[b"data"], np.asarray(d[label_key])

    if dataset == "cifar10":
        xs, ys = zip(*[load_batch(f"data_batch_{i}", b"labels")
                       for i in range(1, 6)])
        train_x, train_y = np.concatenate(xs), np.concatenate(ys)
        test_x, test_y = load_batch("test_batch", b"labels")
    else:
        train_x, train_y = load_batch("train", b"fine_labels")
        test_x, test_y = load_batch("test", b"fine_labels")

    mean, std = MEAN_STD[dataset]
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)

    def norm(x):
        x = x.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # NHWC
        return (x.astype(np.float32) / 255.0 - mean) / std

    return DatasetSplits(train_x=norm(train_x),
                         train_y=train_y.astype(np.int64),
                         test_x=norm(test_x),
                         test_y=test_y.astype(np.int64))


# -- LibSVM datasets --------------------------------------------------------

_LIBSVM_FILES = {
    "epsilon": ("epsilon_normalized", "epsilon_normalized.t"),
    "rcv1": ("rcv1_train.binary", "rcv1_test.binary"),
    "higgs": ("HIGGS", None),
    "MSD": ("YearPredictionMSD", "YearPredictionMSD.t"),
}


def _read_file_bytes(path: str) -> bytes:
    """Whole file as bytes; ``.bz2`` decompressed (concatenated streams
    too), a truncated archive refused as the JAX package refuses it."""
    if path.endswith(".bz2"):
        out, dec = bytearray(), bz2.BZ2Decompressor()
        with open(path, "rb") as f:
            while True:
                data = f.read(1 << 24)
                if not data:
                    break
                while data:
                    if dec.eof:
                        dec = bz2.BZ2Decompressor()
                    out += dec.decompress(data)
                    data = dec.unused_data if dec.eof else b""
        if not dec.eof:
            raise ValueError(
                f"{path}: compressed data ended before the "
                "end-of-stream marker was reached")
        return bytes(out)
    with open(path, "rb") as f:
        return f.read()


_BLANK = b" \t\r"


def _svmlight_rows(data: bytes):
    """(label, [(index, value text), ...]) per data line — lines that are
    not blank and not ``#`` comments — with a trailing ``#`` comment cut
    off; ValueError on a line the JAX package's native parser refuses
    (a bad ``index:value`` pair, an index below 1 or not ascending)."""
    rows = []
    for line in data.split(b"\n"):
        line = line.lstrip(_BLANK)
        if not line or line.startswith(b"#"):
            continue
        toks = line.split(b"#", 1)[0].split()
        label = float(toks[0])
        pairs, prev = [], 0
        for tok in toks[1:]:
            idx, sep, val = tok.partition(b":")
            if not sep or not val or not idx.isdigit() \
                    or int(idx) <= prev:
                raise ValueError(f"malformed svmlight pair {tok!r}")
            prev = int(idx)
            pairs.append((prev, val))
        rows.append((label, pairs))
    return rows


def _read_svmlight_dense(path: str, n_features=None):
    """One svmlight file -> (dense float32 ``[n, f]``, float32 labels),
    ``f`` the largest index unless given. Values go through Python's
    float (a double) to float32, where the JAX package's native parser
    reads float32 directly: the two differ only for a decimal within
    2^-53 of a float32 rounding midpoint. Input the native parser refuses
    (where the JAX package falls back to sklearn) raises."""
    try:
        rows = _svmlight_rows(_read_file_bytes(path))
        if n_features is None:
            n_features = max((p[-1][0] for _, p in rows if p), default=0)
        labels = np.asarray([lab for lab, _ in rows], np.float32)
        dense = np.zeros((len(rows), n_features), np.float32)
        for r, (_, pairs) in enumerate(rows):
            if pairs and pairs[-1][0] > n_features:
                raise ValueError(f"index {pairs[-1][0]} past {n_features}")
            for idx, val in pairs:
                dense[r, idx - 1] = float(val)
    except ValueError as e:
        raise ValueError(
            f"{path}: svmlight text the port's parser refuses ({e}); the "
            "JAX package falls back to sklearn's parser there, which is "
            "not ported") from e
    return dense, labels


def load_libsvm(dataset: str, data_dir: str) -> DatasetSplits:
    """svmlight parse + standardize for MSD
    (ref: loader/libsvm_datasets.py:26-146)."""
    train_name, test_name = _LIBSVM_FILES[dataset]
    base = os.path.join(data_dir, dataset)

    def find(stem):
        for suffix in ("", ".bz2"):
            p = os.path.join(base, stem + suffix)
            if os.path.exists(p):
                return p
        raise _missing(dataset, os.path.join(base, stem))

    x, y = _read_svmlight_dense(find(train_name))
    if test_name:
        tx, ty = _read_svmlight_dense(find(test_name), n_features=x.shape[1])
    else:
        tx, ty = x[-1000:], y[-1000:]
        x, y = x[:-1000], y[:-1000]
    if dataset == "MSD":
        mu, sd = x.mean(0), x.std(0) + 1e-8
        x, tx = (x - mu) / sd, (tx - mu) / sd
        y = y.astype(np.float32)
        ty = ty.astype(np.float32)
    else:
        # binary labels in {-1, +1} or {0, 1} -> {0, 1}
        y = (np.asarray(y) > 0).astype(np.int64)
        ty = (np.asarray(ty) > 0).astype(np.int64)
    return DatasetSplits(x, y, tx, ty)


# -- STL10 ------------------------------------------------------------------

def load_stl10(data_dir: str) -> DatasetSplits:
    base = os.path.join(data_dir, "stl10_binary")
    paths = {k: os.path.join(base, k + ".bin")
             for k in ("train_X", "train_y", "test_X", "test_y")}
    for p in paths.values():
        if not os.path.exists(p):
            raise _missing("stl10", p)

    def rx(p):
        x = np.fromfile(p, dtype=np.uint8).reshape(-1, 3, 96, 96)
        return (x.transpose(0, 3, 2, 1).astype(np.float32) / 255.0 - 0.5) / 0.5

    def ry(p):
        return np.fromfile(p, dtype=np.uint8).astype(np.int64) - 1

    return DatasetSplits(rx(paths["train_X"]), ry(paths["train_y"]),
                         rx(paths["test_X"]), ry(paths["test_y"]))


# -- Factory ----------------------------------------------------------------

def get_dataset(cfg: DataConfig, num_clients: int,
                download: bool = False) -> DatasetSplits:
    """Dispatch on dataset name (prepare_data.py:124-163)."""
    name, root = cfg.dataset, cfg.data_dir
    if download:
        raise ValueError("download=True (fetching a dataset) is not yet "
                         "ported: no machine the port runs on has a "
                         f"network to test it; place the {name} files "
                         f"under {root}")
    if name in _REFUSED:
        raise ValueError(f"dataset {name!r} is not yet ported: "
                         f"{_REFUSED[name]}, which the port does not use")
    if name == "synthetic":
        # synthetic_samples_per_client scales the reference's 500/1000
        # lognormal size window (federated_datasets.py:253 defaults)
        # proportionally: min = the knob, max = 2x — the default 500
        # reproduces the reference exactly
        spc = cfg.synthetic_samples_per_client
        data = generate_synthetic(
            num_tasks=num_clients, alpha=cfg.synthetic_alpha,
            beta=cfg.synthetic_beta, num_dim=cfg.synthetic_dim,
            num_classes=cfg.synthetic_num_classes,
            regression=cfg.synthetic_regression,
            min_num_samples=spc, max_num_samples=2 * spc)
        sizes = [len(y) for y in data.client_y]
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        parts = [np.arange(offsets[i], offsets[i + 1])
                 for i in range(num_clients)]
        return DatasetSplits(
            train_x=np.concatenate(data.client_x),
            train_y=np.concatenate(data.client_y),
            test_x=data.test_x, test_y=data.test_y,
            client_partitions=parts)
    if name in ("mnist", "fashion_mnist"):
        return load_mnist_family(name, root)
    if name in ("cifar10", "cifar100"):
        return load_cifar(name, root)
    if name in _LIBSVM_FILES:
        return load_libsvm(name, root)
    if name == "stl10":
        return load_stl10(root)
    raise ValueError(f"Unknown dataset {name!r}")
