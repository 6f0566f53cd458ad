"""The port's command line on the stream data plane, on the CPU: the
device plane's results from the same seed, the JAX CLI's ``data_plane``
field and its refusal of an mmap store without a directory.
"""
import glob
import os

import pytest

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu import cli as jcli
from fedtorch_tpu_torch import cli as tcli
from test_torch_cli import _TRAIN, _VAL, _synthetic_argv


def _store_of(argv, store_dir):
    """The CLI's training population for ``argv``, written as an on-disk
    client store."""
    from fedtorch_tpu_torch.data import build_federated_data
    from fedtorch_tpu_torch.data.streaming import save_client_store
    cfg = tcli.args_to_config(tcli.build_parser().parse_args(argv))
    save_client_store(str(store_dir), build_federated_data(cfg).train,
                      clients_per_shard=3)
    return ["--data_store", "mmap", "--data_store_dir", str(store_dir)]


@pytest.mark.parametrize("store, words", [
    ("ram", []),
    ("mmap", []),
    ("ram", ["--participation_mode", "sparse"]),
    ("mmap", ["--participation_mode", "sparse", "--federated_type",
              "qffl", "--qffl_q", "1.0"]),
], ids=["ram", "mmap", "ram_sparse", "mmap_sparse_qffl"])
def test_stream_plane_cli_run_returns_the_device_plane_s_results(
        store, words, tmp_path):
    """``--data_plane stream`` (the population in RAM, or in a store
    written from the same data) from one seed draws the device plane's
    cohorts and rows: the same results dict, bitwise, but for the plane
    and the timer; its log holds the same train and val lines."""
    base = _synthetic_argv(tmp_path, "mlp")[:-2] + words
    want = tcli.main(base + ["-c", str(tmp_path / "dev")])
    argv = base + ["-c", str(tmp_path / "ck"), "--data_plane", "stream"]
    if store == "mmap":
        argv += _store_of(base, tmp_path / "store")
    got = tcli.main(argv)
    assert (got.pop("data_plane"), want.pop("data_plane")) == ("stream",
                                                               "device")
    got.pop("timer"), want.pop("timer")
    assert got == want

    def lines(root):
        (record,) = glob.glob(str(root / "synthetic" / "mlp" / "*"
                                  / "record0"))
        text = open(record).read()
        return _TRAIN.findall(text), _VAL.findall(text)

    assert lines(tmp_path / "ck") == lines(tmp_path / "dev")
    assert len(lines(tmp_path / "ck")[0]) == 3


def test_stream_plane_results_carry_the_jax_cli_s_data_plane(tmp_path):
    """The JAX CLI records its run's data plane in the run's metrics
    header; the port's results dict carries the same field."""
    import json
    argv = _synthetic_argv(tmp_path, "mlp", rounds=1)[:-2] + [
        "--data_plane", "stream"]
    jcli.main(argv + ["-c", str(tmp_path / "jax")])
    (metrics,) = glob.glob(str(tmp_path / "jax" / "**" / "metrics.jsonl"),
                           recursive=True)
    with open(metrics) as f:
        header = json.loads(f.readline())
    got = tcli.main(argv + ["-c", str(tmp_path / "ck")])
    assert got["data_plane"] == header["run"]["data_plane"] == "stream"


def test_mmap_store_without_a_directory_is_refused_as_the_jax_cli_does(
        tmp_path):
    argv = _synthetic_argv(tmp_path, "mlp")[:-2] + [
        "--data_plane", "stream", "--data_store", "mmap"]
    with pytest.raises(ValueError) as want:
        jcli.main(argv + ["-c", str(tmp_path / "jax")])
    with pytest.raises(ValueError) as got:
        tcli.main(argv + ["-c", str(tmp_path / "ck")])
    assert "store_dir" in str(got.value)
    assert str(got.value) == str(want.value)
    assert not os.path.exists(tmp_path / "ck")
