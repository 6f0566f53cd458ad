"""Host-plane chaos and recovery in the port (``robustness/host_chaos.py``,
``robustness/host_recovery.py``, the stream plane's retried gather and
rebuilt producer, the checkpoint and telemetry write seams), mirroring
the JAX package's ``test_host_chaos.py`` on the CPU.

* With one seed, the port's injector and the JAX package's fire the same
  schedule (the same booleans, check for check) on every seam both
  packages have; ``native.load`` — the JAX package's native-library
  seam, which the port has no library for — is refused by name.
* A faulted gather is retried and the streamed run stays bitwise
  (sha256 of every state byte) to a fault-free one; a producer whose
  gather exhausts its retries dies, is rebuilt from the live
  (generator, round), and the run stays bitwise; an uncapped fault
  exhausts the rebuilds and raises naming ``stream.producer``.
"""
import errno
import os

import pytest

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu.robustness import host_chaos as jchaos
from fedtorch_tpu_torch import cli as tcli
from fedtorch_tpu_torch.config import FaultConfig, HOST_FAULT_SEAMS
from fedtorch_tpu_torch.robustness import host_chaos, host_recovery
from fedtorch_tpu_torch.utils import checkpoint as tck
from torch_lifecycle import cli_argv, make_trainer, state_digest

PORTED_SEAMS = tuple(s for s in HOST_FAULT_SEAMS
                     if s not in host_chaos.UNPORTED_SEAMS)


@pytest.fixture
def ledger():
    """A fresh installed recovery ledger with no backoff sleeps."""
    rec = host_recovery.HostRecovery(
        policy=host_recovery.RetryPolicy(backoff_base_s=0.0),
        sleep_fn=lambda s: None).install()
    yield rec
    rec.uninstall()


@pytest.fixture
def injector():
    """Installs the injectors a test builds; uninstalls them after."""
    made = []

    def install(*a, **kw):
        inj = host_chaos.HostFaultInjector(*a, **kw).install()
        made.append(inj)
        return inj
    yield install
    for inj in made:
        inj.uninstall()


# -- the injector ----------------------------------------------------------
@pytest.mark.parametrize("seam", PORTED_SEAMS)
@pytest.mark.parametrize("rate, seed", [(0.3, 0), (0.5, 7)])
def test_one_seed_fires_the_jax_package_s_schedule(seam, rate, seed):
    mine = host_chaos.HostFaultInjector((seam,), rate=rate, seed=seed)
    theirs = jchaos.HostFaultInjector((seam,), rate=rate, seed=seed)
    got = [mine.fire(seam) for _ in range(200)]
    assert got == [theirs.fire(seam) for _ in range(200)]
    assert any(got) and not all(got)


def test_native_load_is_refused_by_name(tmp_path):
    assert "native.load" in HOST_FAULT_SEAMS
    with pytest.raises(ValueError, match="native.load.*not ported"):
        host_chaos.HostFaultInjector(("native.load",), rate=1.0)
    with pytest.raises(ValueError, match="--host_fault_seams 'native.load'"):
        tcli.main(cli_argv(tmp_path / "run", extra=[
            "--backend", "cpu", "--host_fault_seams", "native.load"]))
    assert not os.path.exists(tmp_path / "run")  # refused before it ran


def test_rate_edges_caps_and_independent_seams():
    never = host_chaos.HostFaultInjector(("ckpt.write",), rate=0.0)
    assert not any(never.fire("ckpt.write") for _ in range(32))
    capped = host_chaos.HostFaultInjector(("ckpt.write",), rate=1.0,
                                          max_fires=3)
    assert sum(capped.fire("ckpt.write") for _ in range(20)) == 3
    assert capped.stats() == {"host_faults": 3.0}
    both = host_chaos.HostFaultInjector(("ckpt.write", "stream.gather"),
                                        rate=0.5)
    assert [both.fire("ckpt.write") for _ in range(64)] != \
        [both.fire("stream.gather") for _ in range(64)]
    assert not both.fire("stream.h2d")  # armed subset only
    with pytest.raises(ValueError, match="unknown host-fault seam"):
        host_chaos.HostFaultInjector(("nope",))


def test_helpers_noop_uninstalled_and_raise_the_real_classes(injector):
    assert host_chaos.get_active() is None
    host_chaos.maybe_raise("stream.gather")
    assert host_chaos.maybe_truncate("ckpt.torn", b"abcd") == b"abcd"
    injector(("stream.gather", "ckpt.write", "ckpt.torn"), rate=1.0)
    with pytest.raises(RuntimeError, match="stream.gather"):
        host_chaos.maybe_raise("stream.gather")
    with pytest.raises(OSError) as ei:
        host_chaos.maybe_raise_io("ckpt.write")
    assert ei.value.errno == errno.ENOSPC
    assert host_chaos.maybe_truncate("ckpt.torn", b"x" * 100) == b"x" * 50


def test_from_config_builds_only_when_armed():
    assert host_chaos.HostFaultInjector.from_config(FaultConfig()) is None
    inj = host_chaos.HostFaultInjector.from_config(FaultConfig(
        host_fault_seams="stream.gather,ckpt.write", host_fault_rate=0.5,
        host_fault_seed=9, host_fault_max=2))
    assert inj.seams == {"stream.gather", "ckpt.write"}
    assert (inj.rate, inj.seed, inj.max_fires) == (0.5, 9, 2)


# -- the recovery layer ------------------------------------------------------
def test_retry_recovers_counts_and_exhaustion_names_the_seam(ledger):
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    assert host_recovery.retry_io(flaky, "ckpt.write") == "ok"
    assert ledger.retries["ckpt.write"] == 2
    assert ledger.recovered["ckpt.write"] == 1
    with pytest.raises(host_recovery.HostSeamError) as ei:
        host_recovery.retry_io(lambda: (_ for _ in ()).throw(OSError("x")),
                               "ckpt.write")
    assert ei.value.seam == "ckpt.write"
    assert isinstance(ei.value.__cause__, OSError)
    with pytest.raises(ValueError):
        host_recovery.retry_io(
            lambda: (_ for _ in ()).throw(ValueError("not io")),
            "ckpt.write")


def test_backoff_doubles_and_caps():
    sleeps = []
    rec = host_recovery.HostRecovery(
        policy=host_recovery.RetryPolicy(max_retries=4, backoff_base_s=0.5,
                                         backoff_max_s=1.0),
        sleep_fn=sleeps.append).install()
    try:
        with pytest.raises(host_recovery.HostSeamError):
            host_recovery.retry(lambda: 1 / 0, "stream.gather",
                                retryable=(ZeroDivisionError,))
    finally:
        rec.uninstall()
    assert sleeps == [0.5, 1.0, 1.0, 1.0]


# -- the stream plane --------------------------------------------------------
def _stream_digest(fault=None, rounds=3, window=0):
    t = make_trainer(plane="stream", fault=fault)
    try:
        s, c = t.init_state(0)
        for _ in range(rounds):
            if window:
                s, c, _ = t.run_rounds(s, c, window)
            else:
                s, c, _ = t.run_round(s, c)
        return state_digest(s, c), t._stream_rebuilds
    finally:
        t.close()


@pytest.mark.parametrize("seam", ["stream.gather", "stream.h2d"])
def test_injected_stream_fault_is_retried_and_stays_bitwise(
        seam, ledger, injector):
    base, _ = _stream_digest()
    inj = injector((seam, "stream.delay"), rate=0.5, seed=1,
                   delay_s=0.001)
    got, rebuilds = _stream_digest()
    assert inj.fire_counts()[seam] >= 1
    assert ledger.retries[seam] >= 1 and rebuilds == 0
    assert got == base


@pytest.mark.parametrize("window", [0, 2])
def test_producer_death_rebuilds_and_stays_bitwise(window, ledger,
                                                   injector):
    base, _ = _stream_digest(window=window, rounds=2)
    retry_max = FaultConfig().host_retry_max
    # rate 1.0 capped at retries + 1: the gather's retries exhaust once,
    # the producer dies, the trainer rebuilds it
    injector(("stream.gather",), rate=1.0, max_fires=retry_max + 1)
    got, rebuilds = _stream_digest(window=window, rounds=2)
    assert rebuilds == 1 and ledger.retries["stream.producer"] == 1
    assert got == base


def test_rebuild_budget_exhaustion_names_the_seam(ledger, injector):
    injector(("stream.gather",), rate=1.0)
    t = make_trainer(plane="stream", fault=dict(host_retry_max=1))
    try:
        s, c = t.init_state(0)
        with pytest.raises(host_recovery.HostSeamError) as ei:
            t.run_round(s, c)
        assert ei.value.seam == "stream.producer"
        assert t._stream_rebuilds == 1
        assert t.telemetry_gauges()["stream_rebuilds"] == 1.0
    finally:
        t.close()


# -- the checkpoint and telemetry seams ---------------------------------------
def test_atomic_write_retries_through_enospc(tmp_path, ledger, injector):
    injector(("ckpt.write",), rate=1.0, max_fires=2)
    tck._atomic_write(str(tmp_path / "f.bin"), b"payload")
    assert open(tmp_path / "f.bin", "rb").read() == b"payload"
    assert ledger.retries["ckpt.write"] == 2
    assert not os.path.exists(tmp_path / "f.bin.tmp")


def test_torn_seam_lands_torn_frames_that_resume_skips(tmp_path, ledger,
                                                       injector):
    t = make_trainer()
    s, c = t.init_state(0)
    d = str(tmp_path)
    s, c, _ = t.run_round(s, c)
    good = state_digest(s, c)
    tck.save_checkpoint(d, s, c, t.cfg, 0.0, False, save_all=True)
    s, c, _ = t.run_round(s, c)
    injector(("ckpt.torn",), rate=1.0)
    tck.save_checkpoint(d, s, c, t.cfg, 0.0, False, save_all=True)
    assert not tck.frame_quick_ok(os.path.join(d, "checkpoint.ckpt"))
    host_chaos.get_active().uninstall()
    with pytest.warns(RuntimeWarning, match="checkpoint_r1.ckpt"):
        s2, c2, _, resumed = tck.maybe_resume(d, *t.init_state(9), t.cfg)
    assert resumed and state_digest(s2, c2) == good


def test_jsonl_writer_keeps_rows_through_transient_faults_then_degrades(
        tmp_path, ledger, injector):
    from fedtorch_tpu_torch.telemetry.metrics import JsonlWriter
    from fedtorch_tpu_torch.telemetry.schema import iter_jsonl
    w = JsonlWriter(str(tmp_path / "m.jsonl"), "s/v1")
    inj = injector(("telemetry.write",), rate=0.25, seed=1)
    for r in range(20):
        w.write({"round": r}, flush=True)
    inj.uninstall()
    w.close()
    assert [x["round"] for x in iter_jsonl(str(tmp_path / "m.jsonl"))
            if "round" in x] == list(range(20))
    assert inj.total_fires() >= 1 and not w.degraded
    degraded = []
    w2 = JsonlWriter(str(tmp_path / "m2.jsonl"), "s/v1",
                     on_degrade=degraded.append)
    injector(("telemetry.write",), rate=1.0)
    for r in range(5):
        w2.write({"round": r}, flush=True)
    assert w2.degraded and degraded == [w2]
    assert "telemetry.write" in ledger.degraded


def test_health_degrades_to_off_after_consecutive_failures(
        tmp_path, ledger, injector):
    from fedtorch_tpu_torch.telemetry.health import HealthFile
    hf = HealthFile(str(tmp_path / "health.json"), min_interval_s=0.0)
    injector(("telemetry.write",), rate=1.0)
    for i in range(4):
        hf.update("running", round_idx=i)
    assert hf.degraded and hf.write_errors >= 3
    assert hf.update("running", round_idx=99)["round"] == 99
    assert not os.path.exists(tmp_path / "health.json")


def test_cli_run_with_an_armed_drill_completes_and_reports(tmp_path):
    words = ["--backend", "cpu", "--data_plane", "stream",
             "--host_fault_seams", "stream.gather,ckpt.write",
             "--host_fault_rate", "0.3", "--host_fault_seed", "2",
             "--host_retry_backoff_s", "0"]
    res = tcli.main(cli_argv(tmp_path / "run", rounds=3, extra=words))
    rec = res["host_recovery"]
    assert rec["host_faults"] >= 1 and rec["host_retries"] >= 1
    assert set(rec["host_fault_fires"]) == {"stream.gather", "ckpt.write"}
    ref = tcli.main(cli_argv(tmp_path / "ref", rounds=3, extra=[
        "--backend", "cpu", "--data_plane", "stream"]))
    assert res["test_top1"] == ref["test_top1"]
    from fedtorch_tpu_torch.telemetry.schema import load_jsonl
    _, rows, _ = load_jsonl(str(tmp_path / "run" / "metrics.jsonl"))
    assert rows[-1]["host_retries"] == rec["host_retries"]
    assert "stream_rebuilds" in rows[-1]
