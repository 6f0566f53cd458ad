"""Dataset factory (port of ``fedtorch_tpu/data/datasets.py``).

Each loader is the JAX package's, so the arrays are equal: the MNIST
family (idx files), CIFAR-10/100 (the python pickle batches, normalised
to NHWC with ``MEAN_STD``), STL-10 (binary), the synthetic tasks, the
TFF federated HDF5 files of EMNIST (digits and full) and Shakespeare
(read through ``h5py``, with their natural per-writer or per-character
partitions), UCI adult (``pandas`` and ``sklearn``'s ``StandardScaler``,
with the sensitive feature's values for the fair partition), and the
LibSVM datasets through a numpy svmlight parser that takes what the JAX
package's native parser takes; text it rejects goes to ``sklearn``'s
parser, as in the JAX package. ``h5py``, ``pandas`` and ``sklearn`` are
imported inside the readers that need them, so the module imports
without them. Every loader returns :class:`DatasetSplits` of numpy
arrays.

``download=True`` is refused by name: the machines the port is built and
tested on have no network, so a fetch could never be tested. Place the
files under ``data_dir``. A missing file raises the JAX package's error,
which names the expected files and their source.
"""
from __future__ import annotations

import bz2
import gzip
import os
import pickle
import struct
import sys
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
    "emnist": "https://storage.googleapis.com/tff-datasets-public/"
              "fed_emnist_digitsonly.tar.bz2",
    "emnist_full": "https://storage.googleapis.com/tff-datasets-public/"
                   "fed_emnist.tar.bz2",
    "shakespeare": "https://storage.googleapis.com/tff-datasets-public/"
                   "shakespeare.tar.bz2",
    "adult": "https://archive.ics.uci.edu/ml/machine-learning-databases/"
             "adult/",
    "stl10": "http://ai.stanford.edu/~acoates/stl10/stl10_binary.tar.gz",
    "libsvm": "https://www.csie.ntu.edu.tw/~cjlin/libsvmtools/datasets/",
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


# -- TFF federated HDF5 (EMNIST / Shakespeare) ------------------------------

def load_emnist(data_dir: str, full: bool = False,
                allow_train_as_test: bool = False) -> DatasetSplits:
    """TFF fed_emnist HDF5: naturally federated handwriting, one client
    per writer in ``sorted()`` key order (ref:
    federated_datasets.py:15-138). A missing test split raises unless
    ``allow_train_as_test``, which takes the first 256 training rows as
    the test set (and says so on stderr): that reports train accuracy as
    test accuracy."""
    import h5py
    name = "fed_emnist" if full else "fed_emnist_digitsonly"
    base = os.path.join(data_dir, "emnist_full" if full else "emnist")
    train_p = os.path.join(base, f"{name}_train.h5")
    test_p = os.path.join(base, f"{name}_test.h5")
    if not os.path.exists(train_p):
        raise _missing("emnist_full" if full else "emnist", train_p)

    def read(path):
        xs, ys, parts = [], [], []
        with h5py.File(path, "r") as f:
            ex = f["examples"]
            offset = 0
            for client in sorted(ex.keys()):
                px = np.asarray(ex[client]["pixels"])
                py = np.asarray(ex[client]["label"])
                xs.append(px)
                ys.append(py)
                parts.append(np.arange(offset, offset + len(py)))
                offset += len(py)
        x = np.concatenate(xs).astype(np.float32)[..., None]
        y = np.concatenate(ys).astype(np.int64)
        return x, y, parts

    train_x, train_y, parts = read(train_p)
    if os.path.exists(test_p):
        test_x, test_y, _ = read(test_p)
    else:
        if not allow_train_as_test:
            raise FileNotFoundError(
                f"EMNIST test split missing: {test_p}. Refusing to "
                "silently substitute training rows as the test set — "
                "that reports train accuracy as test accuracy. Fetch "
                "the full archive (--download), or opt in explicitly "
                "with --allow_train_as_test if a train-slice pseudo "
                "test set is acceptable for this run.")
        print(f"warning: {test_p} missing — using a 256-sample slice of "
              "the training data as the test set (allow_train_as_test "
              "opt-in)", file=sys.stderr)
        test_x, test_y = train_x[:256], train_y[:256]
    return DatasetSplits(train_x, train_y, test_x, test_y,
                         client_partitions=parts)


# The 86-character TFF shakespeare vocabulary: a character's place is
# its token id; characters outside it map to id 0 (the JAX package's
# _SHAKESPEARE_CHARS, byte for byte).
_SHAKESPEARE_CHARS = (
    "dhlptx@DHLPTX $(,048cgkoswCGKOSW[_#'/37;?bfjnrvzBFJNRVZ\"&*.26:"
    "\naeimquyAEIMQUY]!%)-159\r"
)


def shakespeare_vocab():
    """char -> id mapping over the 86-char TFF vocabulary."""
    return {c: i for i, c in enumerate(_SHAKESPEARE_CHARS)}


def shakespeare_windows(snippets, seq_len: int = 50):
    """One client's snippets (UTF-8 bytes, undecodable bytes dropped) ->
    ``[n_win, seq_len]`` int32 token windows and their next-character
    targets, ``n_win = (len - 1) // seq_len``; (None, None) for a client
    with no whole window (ref: federated_datasets.py:366-368)."""
    vocab = shakespeare_vocab()
    text = b"".join(np.asarray(snippets).tolist()).decode(
        "utf-8", errors="ignore")
    ids = np.asarray([vocab.get(c, 0) for c in text], np.int32)
    n_win = (len(ids) - 1) // seq_len
    if n_win == 0:
        return None, None
    x = ids[:n_win * seq_len].reshape(n_win, seq_len)
    y = ids[1:n_win * seq_len + 1].reshape(n_win, seq_len)
    return x, y


def load_shakespeare(data_dir: str, seq_len: int = 50) -> DatasetSplits:
    """TFF shakespeare HDF5 -> per-client char windows with next-char
    targets (ref: federated_datasets.py:309-479). Clients in ``sorted()``
    key order; a client with no whole window is skipped, so the
    partitions stay contiguous. The test split is the first training
    window, as in the JAX package."""
    import h5py
    train_p = os.path.join(data_dir, "shakespeare", "shakespeare_train.h5")
    if not os.path.exists(train_p):
        raise _missing("shakespeare", train_p)
    xs, ys, parts = [], [], []
    offset = 0
    with h5py.File(train_p, "r") as f:
        ex = f["examples"]
        for client in sorted(ex.keys()):
            x, y = shakespeare_windows(ex[client]["snippets"], seq_len)
            if x is None:
                continue
            xs.append(x)
            ys.append(y)
            parts.append(np.arange(offset, offset + len(x)))
            offset += len(x)
    train_x = np.concatenate(xs)
    train_y = np.concatenate(ys)
    return DatasetSplits(train_x, train_y, train_x[:1], train_y[:1],
                         client_partitions=parts)


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


def _parse_svmlight(data: bytes, n_features=None):
    """svmlight text -> (dense float32 ``[n, f]``, float32 labels), ``f``
    the largest index unless given; ValueError where the JAX package's
    native parser refuses the text. Values go through Python's float (a
    double) to float32, where the native parser reads float32 directly:
    the two differ only for a decimal within 2^-53 of a float32 rounding
    midpoint."""
    rows = _svmlight_rows(data)
    if n_features is None:
        n_features = max((p[-1][0] for _, p in rows if p), default=0)
    labels = np.asarray([lab for lab, _ in rows], np.float32)
    dense = np.zeros((len(rows), n_features), np.float32)
    for r, (_, pairs) in enumerate(rows):
        if pairs and pairs[-1][0] > n_features:
            raise ValueError(f"index {pairs[-1][0]} past {n_features}")
        for idx, val in pairs:
            dense[r, idx - 1] = float(val)
    return dense, labels


def _read_svmlight_dense(path: str, n_features=None):
    """One svmlight file -> (dense float32 ``[n, f]``, labels): the numpy
    parser, which takes the place of the JAX package's native one; text
    it rejects, and a corrupt ``.bz2``, go to
    ``sklearn.datasets.load_svmlight_file`` after the JAX package's
    warning on stderr."""
    try:
        return _parse_svmlight(_read_file_bytes(path), n_features)
    # ValueError: the parser rejected the text; OSError/EOFError: a
    # corrupt or trailing-garbage .bz2 — sklearn gets its own chance
    except (ValueError, OSError, EOFError) as e:
        print(f"warning: native svmlight parser rejected {path} "
              f"({e}); falling back to sklearn", file=sys.stderr)
    from sklearn.datasets import load_svmlight_file
    x, y = load_svmlight_file(path, n_features=n_features)
    return np.asarray(x.todense(), np.float32), y


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


# -- Adult ------------------------------------------------------------------

_ADULT_COLUMNS = ["age", "workclass", "fnlwgt", "education", "education-num",
                  "marital-status", "occupation", "relationship", "race",
                  "sex", "capital-gain", "capital-loss", "hours-per-week",
                  "native-country", "income"]


def load_adult(data_dir: str, sensitive_feature: int = 9) -> DatasetSplits:
    """UCI adult CSV: categorical codes, standardisation, and the
    sensitive feature's unscaled values (ref: loader/adult_loader.py:
    28-160; default sensitive feature 9 = sex, parameters.py:37). The
    categorical codes are taken over the concatenated train and test
    frames, so both files share them."""
    import pandas as pd
    from sklearn.preprocessing import StandardScaler
    base = os.path.join(data_dir, "adult")
    train_p = os.path.join(base, "adult.data")
    test_p = os.path.join(base, "adult.test")
    for p in (train_p, test_p):
        if not os.path.exists(p):
            raise _missing("adult", p)

    def read(path, skip=0):
        return pd.read_csv(path, names=_ADULT_COLUMNS, skiprows=skip,
                           skipinitialspace=True, na_values="?").dropna()

    df_train, df_test = read(train_p), read(test_p, skip=1)
    df = pd.concat([df_train, df_test], keys=["train", "test"])
    y_all = df["income"].str.contains(">50K").astype(np.int64)
    df = df.drop(columns=["income"])
    for col in df.columns:
        if not pd.api.types.is_numeric_dtype(df[col]):
            df[col] = df[col].astype("category").cat.codes
    train_x = df.loc["train"].to_numpy(np.float32)
    test_x = df.loc["test"].to_numpy(np.float32)
    train_y = y_all.loc["train"].to_numpy()
    test_y = y_all.loc["test"].to_numpy()
    sensitive = train_x[:, sensitive_feature].copy()
    scaler = StandardScaler().fit(train_x)
    return DatasetSplits(scaler.transform(train_x).astype(np.float32),
                         train_y,
                         scaler.transform(test_x).astype(np.float32),
                         test_y, sensitive_values=sensitive)


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
                download: bool = False, seq_len: int = 50) -> DatasetSplits:
    """Dispatch on dataset name (prepare_data.py:124-163); ``seq_len``
    is the Shakespeare window (the model's ``rnn_seq_len``)."""
    name, root = cfg.dataset, cfg.data_dir
    if download:
        raise ValueError("download=True (fetching a dataset) is not yet "
                         "ported: no machine the port runs on has a "
                         f"network to test it; place the {name} files "
                         f"under {root}")
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
    if name in ("emnist", "emnist_full"):
        return load_emnist(root, full=name == "emnist_full",
                           allow_train_as_test=cfg.allow_train_as_test)
    if name == "shakespeare":
        return load_shakespeare(root, seq_len=seq_len)
    if name in _LIBSVM_FILES:
        return load_libsvm(name, root)
    if name == "adult":
        return load_adult(root, cfg.sensitive_feature)
    if name == "stl10":
        return load_stl10(root)
    raise ValueError(f"Unknown dataset {name!r}")
