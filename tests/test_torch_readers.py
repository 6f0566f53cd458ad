"""The federated tasks' readers of the port (``data/datasets.py``)
against the JAX package's, on the CPU: TFF EMNIST (digits and full) and
Shakespeare HDF5 files, UCI adult CSV files, and svmlight text the numpy
parser rejects, each written here in the file's own format
(``tests/format_fixtures.py``). Every array, dtype and natural partition
(and adult's ``sensitive_values``) is equal bit for bit; so are the
errors and the stderr warnings. The readers import ``h5py``, ``pandas``
and ``sklearn`` inside themselves, so a subprocess with the three
blocked still imports every module of the port and ``chip_smoke.py``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import config as jcfg
from fedtorch_tpu.data import build_federated_data as jbuild
from fedtorch_tpu.data import datasets as jds
from fedtorch_tpu_torch import config as tcfg
from fedtorch_tpu_torch.data import build_federated_data as tbuild
from fedtorch_tpu_torch.data import datasets as tds
from format_fixtures import (
    emnist_writer_id, write_svmlight, write_tff_emnist,
    write_tff_shakespeare,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# per-writer sizes of the EMNIST fixture; ids in an order sorted() changes
EMNIST_SIZES = {emnist_writer_id(i): n for i, n in
                zip((7, 2, 11, 0, 5), (5, 3, 9, 1, 4))}
SNIPPETS = {
    "THE_TRAGEDY_OF_HAMLET_HAMLET": [
        "To be, or not to be: that is the question:\n",
        "Whether 'tis nobler in the mind to suffer\r\n"],
    "KING_LEAR_FOOL": ["Have more than thou showest, {speak} less ~ "
                       "than thou knowest;\n", "Lend less than thou owest."],
    "A_MIDSUMMER_NIGHTS_DREAM_PUCK": ["Lord, what fools"],  # one window
    "AS_YOU_LIKE_IT_JAQUES": ["All"],  # no whole window: skipped
    "MACBETH_WITCH": ["Double, double toil and trouble; fire burn, é "
                      "and caldron bubble."],
}
ADULT_TRAIN = [
    "39, State-gov, 77516, Bachelors, 13, Never-married, Adm-clerical, "
    "Not-in-family, White, Male, 2174, 0, 40, United-States, <=50K",
    "50, Self-emp-not-inc, 83311, Bachelors, 13, Married-civ-spouse, "
    "Exec-managerial, Husband, White, Male, 0, 0, 13, United-States, <=50K",
    "38, Private, 215646, HS-grad, 9, Divorced, Handlers-cleaners, "
    "Not-in-family, White, Male, 0, 0, 40, United-States, <=50K",
    "53, Private, 234721, 11th, 7, Married-civ-spouse, Handlers-cleaners, "
    "Husband, Black, Male, 0, 0, 40, United-States, <=50K",
    "28, Private, 338409, Bachelors, 13, Married-civ-spouse, "
    "Prof-specialty, Wife, Black, Female, 0, 0, 40, Cuba, <=50K",
    "37, Private, 284582, Masters, 14, Married-civ-spouse, "
    "Exec-managerial, Wife, White, Female, 0, 0, 40, United-States, >50K",
    "49, ?, 160187, 9th, 5, Married-spouse-absent, Other-service, "
    "Not-in-family, Black, Female, 0, 0, 16, Jamaica, <=50K",
    "31, Private, 45781, Masters, 14, Never-married, Prof-specialty, "
    "Not-in-family, White, Female, 14084, 0, 50, United-States, >50K",
]
ADULT_TEST = [
    "25, Private, 226802, 11th, 7, Never-married, Machine-op-inspct, "
    "Own-child, Black, Male, 0, 0, 40, United-States, <=50K.",
    "44, Private, 160323, Some-college, 10, Married-civ-spouse, "
    "Machine-op-inspct, Husband, Black, Male, 7688, 0, 40, Holand-"
    "Netherlands, >50K.",
    "18, ?, 103497, Some-college, 10, Never-married, ?, Own-child, White, "
    "Female, 0, 0, 30, United-States, <=50K.",
]


def _write_emnist(root, full, test=True):
    name = "fed_emnist" if full else "fed_emnist_digitsonly"
    base = os.path.join(root, "emnist_full" if full else "emnist")
    write_tff_emnist(os.path.join(base, f"{name}_train.h5"), EMNIST_SIZES,
                     seed=1)
    if test:
        write_tff_emnist(os.path.join(base, f"{name}_test.h5"),
                         {emnist_writer_id(3): 2, emnist_writer_id(1): 3},
                         seed=2, label_dtype=np.int64)


def _write_adult(root):
    base = os.path.join(root, "adult")
    os.makedirs(base)
    with open(os.path.join(base, "adult.data"), "w") as f:
        f.write("\n".join(ADULT_TRAIN) + "\n")
    with open(os.path.join(base, "adult.test"), "w") as f:
        f.write("|1x3 Cross validator\n" + "\n".join(ADULT_TEST) + "\n")


def _assert_splits_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    for name in ("train_x", "train_y", "test_x", "test_y",
                 "sensitive_values"):
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    if want.client_partitions is None:
        assert got.client_partitions is None
    else:
        assert len(got.client_partitions) == len(want.client_partitions)
        for g, w in zip(got.client_partitions, want.client_partitions):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("full", [False, True], ids=["digits", "full"])
def test_emnist(full, tmp_path):
    _write_emnist(tmp_path, full)
    got = tds.load_emnist(str(tmp_path), full=full)
    _assert_splits_equal(got, jds.load_emnist(str(tmp_path), full=full))
    # the writers in sorted() key order, one partition each
    assert [len(p) for p in got.client_partitions] == [
        EMNIST_SIZES[k] for k in sorted(EMNIST_SIZES)]
    assert got.train_x.shape == (22, 28, 28, 1)


def test_emnist_missing_test_split_raises_the_jax_package_s_error(tmp_path):
    _write_emnist(tmp_path, full=False, test=False)
    with pytest.raises(FileNotFoundError) as want:
        jds.load_emnist(str(tmp_path))
    with pytest.raises(FileNotFoundError) as got:
        tds.load_emnist(str(tmp_path))
    assert str(got.value) == str(want.value)
    assert "allow_train_as_test" in str(got.value)


def test_emnist_allow_train_as_test_takes_256_train_rows(tmp_path, capsys):
    """The opt-in: the first 256 training rows (here all 22) as the test
    set, and the JAX package's warning on stderr."""
    _write_emnist(tmp_path, full=True, test=False)
    cfg = tcfg.DataConfig(dataset="emnist_full", data_dir=str(tmp_path),
                          allow_train_as_test=True)
    got = tds.get_dataset(cfg, 5)
    got_err = capsys.readouterr().err
    want = jds.load_emnist(str(tmp_path), full=True,
                           allow_train_as_test=True)
    assert capsys.readouterr().err == got_err
    assert "256-sample slice" in got_err
    _assert_splits_equal(got, want)
    np.testing.assert_array_equal(got.test_x, got.train_x[:256])


def test_shakespeare(tmp_path):
    """Windows of 8 with next-character targets; characters outside the
    86-character vocabulary (the "é", "{", "~") map to 0, and
    a client with no whole window is skipped."""
    write_tff_shakespeare(
        os.path.join(tmp_path, "shakespeare", "shakespeare_train.h5"),
        SNIPPETS)
    got = tds.load_shakespeare(str(tmp_path), seq_len=8)
    _assert_splits_equal(got, jds.load_shakespeare(str(tmp_path),
                                                   seq_len=8))
    assert got.train_x.dtype == np.int32 and got.train_x.shape[1] == 8
    assert len(got.client_partitions) == len(SNIPPETS) - 1
    np.testing.assert_array_equal(got.train_x[:, 1:], got.train_y[:, :-1])
    assert tds._SHAKESPEARE_CHARS == jds._SHAKESPEARE_CHARS
    assert tds.shakespeare_vocab() == jds.shakespeare_vocab()


def test_svmlight_the_numpy_parser_rejects_falls_back_to_sklearn(
        tmp_path, capsys):
    """``qid:`` fields (which the JAX package's native parser also
    refuses) and a corrupt .bz2: sklearn reads the first, and both
    packages print the same warning; on the second, sklearn's own error
    is the one raised."""
    p = tmp_path / "ranking.txt"
    p.write_bytes(b"1 qid:1 1:0.5 3:2.0\n-1 qid:1 2:1.5\n"
                  b"0 qid:2 2:-1 4:0.25\n")
    got = tds._read_svmlight_dense(str(p))
    assert "falling back to sklearn" in capsys.readouterr().err
    want = jds._read_svmlight_dense(str(p))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (3, 4)
    bad = tmp_path / "bad.bz2"
    bad.write_bytes(b"NOT A BZ2 FILE")
    with pytest.raises(Exception) as e:
        tds._read_svmlight_dense(str(bad))
    assert "bz2" not in type(e.value).__module__
    assert "falling back to sklearn" in capsys.readouterr().err


def test_libsvm_dataset_through_the_fallback(tmp_path):
    """rcv1 whose train file has a ``qid:`` field: the port's numpy
    parser rejects it, sklearn reads it; the dataset equals the JAX
    package's."""
    base = tmp_path / "rcv1"
    write_svmlight(str(base / "rcv1_test.binary"), 20, 6, labels="pm1",
                   seed=3)
    write_svmlight(str(base / "rcv1_train.binary"), 30, 6, labels="pm1",
                   seed=4)
    with open(base / "rcv1_train.binary", "a") as f:
        f.write("1 qid:3 2:0.5 5:0.75\n")
    cfg = dict(dataset="rcv1", data_dir=str(tmp_path))
    _assert_splits_equal(tds.get_dataset(tcfg.DataConfig(**cfg), 2),
                         jds.get_dataset(jcfg.DataConfig(**cfg), 2))


@pytest.mark.parametrize("sensitive_feature", [9, 8])
def test_adult(sensitive_feature, tmp_path):
    _write_adult(tmp_path)
    got = tds.load_adult(str(tmp_path), sensitive_feature)
    _assert_splits_equal(got, jds.load_adult(str(tmp_path),
                                             sensitive_feature))
    # rows with '?' dropped; the unscaled codes of the sensitive column
    assert got.train_x.shape == (7, 14) and got.test_x.shape == (2, 14)
    assert set(got.sensitive_values.tolist()) == {0.0, 1.0} \
        if sensitive_feature == 9 else len(set(got.sensitive_values)) > 1


@pytest.mark.parametrize("dataset", ["emnist", "emnist_full", "shakespeare",
                                     "adult"])
def test_missing_files_raise_the_jax_package_s_error(dataset, tmp_path):
    cfgs = [mod.DataConfig(dataset=dataset, data_dir=str(tmp_path))
            for mod in (jcfg, tcfg)]
    with pytest.raises(FileNotFoundError) as want:
        jds.get_dataset(cfgs[0], 2)
    with pytest.raises(FileNotFoundError) as got:
        tds.get_dataset(cfgs[1], 2)
    assert str(got.value) == str(want.value)


def _experiment(mod, data, clients, **fed):
    return mod.ExperimentConfig(
        data=mod.DataConfig(**data),
        federated=mod.FederatedConfig(federated=True, num_clients=clients,
                                      **fed),
        model=mod.ModelConfig(rnn_seq_len=8),
        train=mod.TrainConfig(manual_seed=4)).finalize()


@pytest.mark.parametrize("dataset, clients, extra", [
    ("emnist", 4, {}),
    ("emnist_full", 5, dict(allow_train_as_test=True)),
    ("shakespeare", 3, {}),
    ("adult", 2, dict(iid=False)),
    ("adult", 3, {}),
], ids=["emnist", "emnist_full", "shakespeare", "adult_sensitive",
        "adult_iid"])
def test_build_federated_data_takes_the_natural_partitions(
        dataset, clients, extra, tmp_path):
    """``build_federated_data`` end to end: EMNIST's writers and
    Shakespeare's characters as the clients (the first ``clients`` of
    them), adult by its sensitive feature's groups (or IID): the padded
    client tensors, sizes and test set equal the JAX package's."""
    if dataset.startswith("emnist"):
        _write_emnist(tmp_path, dataset == "emnist_full",
                      test=dataset == "emnist")
    elif dataset == "shakespeare":
        write_tff_shakespeare(
            os.path.join(tmp_path, "shakespeare", "shakespeare_train.h5"),
            SNIPPETS)
    else:
        _write_adult(tmp_path)
    data = dict(dataset=dataset, data_dir=str(tmp_path), **extra)
    want = jbuild(_experiment(jcfg, data, clients))
    got = tbuild(_experiment(tcfg, data, clients))
    for name in ("x", "y", "sizes"):
        g, w = getattr(got.train, name).numpy(), np.asarray(
            getattr(want.train, name))
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)
    np.testing.assert_array_equal(got.test_x, want.test_x)
    np.testing.assert_array_equal(got.test_y, want.test_y)
    assert got.train.num_clients == clients


def test_the_port_imports_without_h5py_pandas_or_sklearn():
    """A subprocess whose imports of h5py, pandas and sklearn raise:
    every module of the port and ``chip_smoke.py`` still import, and the
    Shakespeare window encoder runs."""
    code = (
        "import importlib, pkgutil, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('h5py', 'pandas', 'sklearn'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import fedtorch_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(fedtorch_tpu_torch.__path__,\n"
        "                               'fedtorch_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from fedtorch_tpu_torch.data.datasets import shakespeare_windows\n"
        "x, y = shakespeare_windows([b'abcdefghij'], 4)\n"
        "assert x.shape == (2, 4)\n"
        "assert not {'h5py', 'pandas', 'sklearn'} & set(sys.modules)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
