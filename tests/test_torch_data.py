"""The data layer, port vs the JAX package, on the CPU.

The partitioners and the synthetic generator are numpy in both packages
and must be bitwise equal (the same ``RandomState`` draws in the same
order). The loaders read files this test writes (no dataset is in the
repo) and must return equal arrays; ``build_federated_data`` must give
equal per-client tensors for each partition scheme. ``--download`` is
refused by name. The readers that need h5py, pandas or sklearn are held
in ``test_torch_readers.py``.
"""
import bz2
import dataclasses
import gzip
import os
import pickle
import struct

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import config as jcfg
from fedtorch_tpu.data import build_federated_data as jbuild
from fedtorch_tpu.data import datasets as jds
from fedtorch_tpu.data import partition as jpart
from fedtorch_tpu.data.synthetic import generate_synthetic as jsynth
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.data import build_federated_data as tbuild
from fedtorch_tpu_torch.data import datasets as tds
from fedtorch_tpu_torch.data import partition as tpart
from fedtorch_tpu_torch.data.batching import stack_partitions
from fedtorch_tpu_torch.data.synthetic import generate_synthetic as tsynth


def _same_parts(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert np.asarray(g).dtype == np.asarray(w).dtype


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("n, parts, fractions", [
    (100, 10, None), (97, 7, None), (1000, 3, (0.5, 0.3, 0.2))])
def test_iid_partition_is_bitwise(seed, n, parts, fractions):
    _same_parts(tpart.iid_partition(n, parts, seed, fractions),
                jpart.iid_partition(n, parts, seed, fractions))


@pytest.mark.parametrize("clients, per_client, unbalanced", [
    (10, 1, False), (10, 2, False), (5, 2, True), (20, 1, True)])
def test_label_sorted_partition_is_bitwise(clients, per_client, unbalanced):
    labels = np.random.RandomState(clients).randint(0, 10, 2000)
    _same_parts(
        tpart.label_sorted_partition(labels, clients, per_client, unbalanced),
        jpart.label_sorted_partition(labels, clients, per_client, unbalanced))


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("clients, alpha", [(10, 0.1), (25, 1.0), (4, 10.0)])
def test_dirichlet_partition_is_bitwise(seed, clients, alpha):
    labels = np.random.RandomState(seed + 100).randint(0, 10, 3000)
    _same_parts(tpart.dirichlet_partition(labels, clients, alpha, seed),
                jpart.dirichlet_partition(labels, clients, alpha, seed))


def test_sensitive_group_and_growing_batch_partitions_are_bitwise():
    values = np.random.RandomState(0).randint(0, 2, 500).astype(np.float32)
    _same_parts(tpart.sensitive_group_partition(values, 6),
                jpart.sensitive_group_partition(values, 6))
    for reshuffle in (False, True):
        _same_parts(
            tpart.growing_batch_partition(300, 3, 3, (0.7, 0.2, 0.1),
                                          reshuffle, seed=5),
            jpart.growing_batch_partition(300, 3, 3, (0.7, 0.2, 0.1),
                                          reshuffle, seed=5))
    parts = jpart.iid_partition(50, 4)
    np.testing.assert_array_equal(tpart.partition_sizes(parts),
                                  jpart.partition_sizes(parts))
    with pytest.raises(ValueError, match="multiple"):
        tpart.sensitive_group_partition(values, 5)


@pytest.mark.parametrize("kw", [
    dict(num_tasks=5, seed=931231),
    dict(num_tasks=8, alpha=0.5, beta=0.5, num_classes=10, seed=3),
    dict(num_tasks=4, alpha=1.0, beta=1.0, regression=True, seed=9),
    dict(num_tasks=6, num_dim=12, min_num_samples=20, max_num_samples=40,
         test_ratio=0.3, seed=1),
])
def test_generate_synthetic_is_bitwise(kw):
    kw.setdefault("min_num_samples", 30)
    kw.setdefault("max_num_samples", 60)
    got, want = tsynth(**kw), jsynth(**kw)
    for g, w in zip(got, want):
        if isinstance(w, list):
            _same_parts(g, w)
        else:
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


# -- files the loaders read ---------------------------------------------------

def _write_cifar(root, dataset, rng):
    if dataset == "cifar10":
        base = os.path.join(root, "cifar-10-batches-py")
        files = [(f"data_batch_{i}", 12) for i in range(1, 6)] \
            + [("test_batch", 9)]
        key, classes = b"labels", 10
    else:
        base = os.path.join(root, "cifar-100-python")
        files, key, classes = [("train", 30), ("test", 9)], b"fine_labels", 100
    os.makedirs(base)
    for name, n in files:
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump({b"data": rng.randint(0, 256, (n, 3072))
                         .astype(np.uint8),
                         key: rng.randint(0, classes, n).tolist()}, f)


def _write_idx(path, array, compress):
    header = struct.pack(">I", 0x0800 | array.ndim) \
        + struct.pack(">" + "I" * array.ndim, *array.shape)
    opener = gzip.open if compress else open
    with opener(path + (".gz" if compress else ""), "wb") as f:
        f.write(header + array.astype(np.uint8).tobytes())


def _write_mnist(root, dataset, rng):
    base = os.path.join(root, dataset)
    os.makedirs(base)
    for i, (stem, shape) in enumerate([
            ("train-images-idx3-ubyte", (20, 28, 28)),
            ("train-labels-idx1-ubyte", (20,)),
            ("t10k-images-idx3-ubyte", (6, 28, 28)),
            ("t10k-labels-idx1-ubyte", (6,))]):
        hi = 10 if len(shape) == 1 else 256
        _write_idx(os.path.join(base, stem), rng.randint(0, hi, shape),
                   compress=bool(i % 2))


def _write_stl10(root, rng):
    base = os.path.join(root, "stl10_binary")
    os.makedirs(base)
    for split, n in (("train", 5), ("test", 3)):
        rng.randint(0, 256, (n, 3, 96, 96)).astype(np.uint8).tofile(
            os.path.join(base, f"{split}_X.bin"))
        rng.randint(1, 11, n).astype(np.uint8).tofile(
            os.path.join(base, f"{split}_y.bin"))


def _svm_text(rng, rows, features, labels):
    lines = ["# a comment line", ""]
    for _ in range(rows):
        idx = np.sort(rng.choice(np.arange(1, features + 1),
                                 rng.randint(0, features), replace=False))
        pairs = " ".join(f"{i}:{rng.randn():.6g}" for i in idx)
        lines.append(f"{rng.choice(labels)} {pairs}".rstrip()
                     + ("  # trailing" if rng.rand() < 0.1 else ""))
    return "\n".join(lines) + "\n"


def _write_libsvm(root, dataset, rng):
    base = os.path.join(root, dataset)
    os.makedirs(base)
    train, test = jds._LIBSVM_FILES[dataset]
    rows = 1010 if test is None else 40
    labels = ["1990", "2001.5"] if dataset == "MSD" else ["-1", "+1"]
    text = _svm_text(rng, rows, 8, labels)
    if dataset == "rcv1":  # the bz2 path
        with open(os.path.join(base, train + ".bz2"), "wb") as f:
            f.write(bz2.compress(text.encode()))
    else:
        with open(os.path.join(base, train), "w") as f:
            f.write(text)
    if test is not None:
        with open(os.path.join(base, test), "w") as f:
            f.write(_svm_text(rng, 15, 8, labels))


WRITERS = {
    "cifar10": lambda r, g: _write_cifar(r, "cifar10", g),
    "cifar100": lambda r, g: _write_cifar(r, "cifar100", g),
    "mnist": lambda r, g: _write_mnist(r, "mnist", g),
    "fashion_mnist": lambda r, g: _write_mnist(r, "fashion_mnist", g),
    "stl10": _write_stl10,
    "rcv1": lambda r, g: _write_libsvm(r, "rcv1", g),
    "higgs": lambda r, g: _write_libsvm(r, "higgs", g),
    "MSD": lambda r, g: _write_libsvm(r, "MSD", g),
}


def _data_cfgs(**kw):
    return jcfg.DataConfig(**kw), tcfg.DataConfig(**kw)


@pytest.mark.parametrize("dataset", sorted(WRITERS))
def test_get_dataset_reads_the_files_as_the_jax_package(dataset, tmp_path):
    WRITERS[dataset](str(tmp_path), np.random.RandomState(len(dataset)))
    jc, tc = _data_cfgs(dataset=dataset, data_dir=str(tmp_path))
    want, got = jds.get_dataset(jc, 4), tds.get_dataset(tc, 4)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    assert got.client_partitions is None and want.client_partitions is None


def test_get_dataset_synthetic_is_the_jax_package_s():
    jc, tc = _data_cfgs(dataset="synthetic", synthetic_alpha=0.5,
                        synthetic_beta=0.5, synthetic_samples_per_client=25)
    want, got = jds.get_dataset(jc, 6), tds.get_dataset(tc, 6)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, w)
    _same_parts(got.client_partitions, want.client_partitions)


@pytest.mark.parametrize("dataset", ["cifar10", "mnist", "stl10", "MSD"])
def test_a_missing_file_raises_the_jax_package_s_error(dataset, tmp_path):
    jc, tc = _data_cfgs(dataset=dataset, data_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError) as want:
        jds.get_dataset(jc, 2)
    with pytest.raises(FileNotFoundError) as got:
        tds.get_dataset(tc, 2)
    assert str(got.value) == str(want.value)


def test_download_is_refused_by_name(tmp_path):
    cfg = tcfg.DataConfig(dataset="cifar10", data_dir=str(tmp_path))
    with pytest.raises(ValueError, match="download.*not yet ported"):
        tds.get_dataset(cfg, 2, download=True)


def _experiment(mod, data, clients=6, **fed):
    return mod.ExperimentConfig(
        data=mod.DataConfig(**data),
        federated=mod.FederatedConfig(federated=True, num_clients=clients,
                                      **fed),
        train=mod.TrainConfig(manual_seed=4)).finalize()


@pytest.mark.parametrize("scheme", [
    dict(iid=True), dict(iid=False, dirichlet=True),
    dict(iid=False, num_class_per_client=2),
    dict(iid=False, unbalanced=True)])
def test_build_federated_data_matches_per_scheme(scheme, tmp_path):
    rng = np.random.RandomState(3)
    base = tmp_path / "cifar-10-batches-py"
    base.mkdir()
    for name, n in [(f"data_batch_{i}", 120) for i in range(1, 6)] \
            + [("test_batch", 20)]:
        with open(base / name, "wb") as f:
            pickle.dump({b"data": rng.randint(0, 256, (n, 3072))
                         .astype(np.uint8),
                         b"labels": rng.randint(0, 10, n).tolist()}, f)
    data = dict(dataset="cifar10", data_dir=str(tmp_path), **scheme)
    want = jbuild(_experiment(jcfg, data))
    got = tbuild(_experiment(tcfg, data))
    for g, w in zip(got.train, want.train):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got.test_x, want.test_x)
    np.testing.assert_array_equal(got.test_y, want.test_y)
    assert got.val is None and got.num_clients == 6


def test_build_federated_data_keeps_regression_targets():
    """stack_partitions keeps float targets (it once cast every label to
    int64, which truncated the synthetic regression targets)."""
    data = dict(dataset="synthetic", synthetic_regression=True,
                synthetic_samples_per_client=20)
    want = jbuild(_experiment(jcfg, data, clients=4))
    got = tbuild(_experiment(tcfg, data, clients=4))
    assert got.train.y.dtype.is_floating_point
    np.testing.assert_array_equal(got.train.y.numpy(),
                                  np.asarray(want.train.y))
    labels = np.arange(6, dtype=np.int32)
    stacked = stack_partitions(np.zeros((6, 2)), labels, [[0, 1], [2]])
    assert stacked.y.tolist() == [[0, 1], [2, 2]]


def test_personal_split_keeps_every_row_once():
    """``personal``: each client's partition splits into train and val
    rows, together each row once, ``val_fraction`` of it in val (at
    least one row)."""
    cfg = _experiment(tcfg, dict(dataset="synthetic"), clients=2)
    plain = tbuild(cfg)
    cfg = dataclasses.replace(cfg, federated=dataclasses.replace(
        cfg.federated, personal=True))
    split = tbuild(cfg)
    assert plain.val is None and split.val is not None
    for c, size in enumerate(plain.train.sizes.tolist()):
        n_val = int(split.val.sizes[c])
        assert n_val == max(int(size * cfg.data.val_fraction), 1)
        assert int(split.train.sizes[c]) + n_val == size
        rows = torch.cat([split.train.x[c, :size - n_val],
                          split.val.x[c, :n_val]])
        want = plain.train.x[c, :size]
        assert sorted(map(tuple, rows.tolist())) == \
            sorted(map(tuple, want.tolist()))
