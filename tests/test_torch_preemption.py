"""The port's process lifecycle (``robustness/preemption.py``,
``robustness/watchdog.py``, ``robustness/harness.py`` and the CLI's
drain), mirroring the JAX package's ``test_preemption.py`` on the CPU.

* ``PreemptionHandler``: SIGTERM/SIGUSR1 set the flag, one stray SIGINT
  during a drain keeps draining, a second raises, handlers are restored,
  and off the main thread it stays inert.
* ``StallWatchdog``: fires exit code 75 with the thread stacks and the
  runtime snapshot in the log after its timeout; heartbeats defer it.
* ``ElasticRunner``: relaunches on 75 with ``--resume``, never twice,
  gives up on a crash loop, resets its budget on progress, backs off.
* The CLI: a stop requested mid-run drains at the round boundary with a
  durable checkpoint the resume continues from bitwise (sha256 of every
  state byte), sync and ``--async_checkpoint``, device and stream
  planes; ``main`` raises ``SystemExit(75)``; ``supervise`` routes to
  the harness.
"""
import json
import os
import signal
import threading
import time

import pytest

import torch_threads  # noqa: F401 (two torch threads a worker)
from fedtorch_tpu_torch import cli as tcli
from fedtorch_tpu_torch.robustness import (
    RESTART_EXIT_CODE, ElasticRunner, PreemptionHandler, StallWatchdog,
    read_checkpoint_round,
)
from fedtorch_tpu_torch.robustness.harness import main as harness_main
from fedtorch_tpu_torch.robustness.watchdog import format_thread_stacks
from fedtorch_tpu_torch.telemetry import load_jsonl, read_health
from torch_lifecycle import cli_argv, file_digest


class ListLogger:
    def __init__(self):
        self.lines = []

    def log(self, msg, display=None):
        self.lines.append(msg)

    def text(self):
        return "\n".join(self.lines)


# -- PreemptionHandler ---------------------------------------------------
def test_sigterm_and_sigusr1_set_the_flag_and_reason():
    for sig, name in ((signal.SIGTERM, "SIGTERM"),
                      (signal.SIGUSR1, "SIGUSR1")):
        with PreemptionHandler() as h:
            assert not h.stop_requested and h.reason is None
            os.kill(os.getpid(), sig)
            deadline = time.monotonic() + 5
            while not h.stop_requested and time.monotonic() < deadline:
                time.sleep(0.01)
            assert h.stop_requested and h.reason == name


def test_restore_reinstates_previous_handlers():
    prev = signal.getsignal(signal.SIGTERM)
    h = PreemptionHandler()
    assert h.install()
    assert signal.getsignal(signal.SIGTERM) == h._on_signal
    h.restore()
    assert signal.getsignal(signal.SIGTERM) == prev


def test_one_stray_sigint_keeps_draining_a_second_raises():
    with PreemptionHandler() as h:
        h._on_signal(signal.SIGTERM, None)
        h._on_signal(signal.SIGINT, None)
        assert h.stop_requested and h.reason == "SIGINT"
        with pytest.raises(KeyboardInterrupt):
            h._on_signal(signal.SIGINT, None)


def test_request_stop_and_install_off_the_main_thread():
    h = PreemptionHandler(logger=ListLogger())
    out = {}
    t = threading.Thread(target=lambda: out.update(ok=h.install()))
    t.start()
    t.join(10)
    assert out["ok"] is False and not h.installed
    assert "not on the main thread" in h.logger.text()
    h.request_stop("test")
    assert h.stop_requested and h.reason == "test"


# -- StallWatchdog -----------------------------------------------------------
def test_watchdog_disabled_at_zero_timeout():
    wd = StallWatchdog(0.0)
    wd.start()
    assert not wd.enabled and wd._thread is None
    wd.stop()


def test_watchdog_fires_75_after_the_timeout_with_stacks():
    log, fired = ListLogger(), []
    wd = StallWatchdog(0.2, logger=log, exit_fn=fired.append, poll_s=0.05)
    wd.start()
    wd.heartbeat(0)
    deadline = time.monotonic() + 5.0
    while not fired and time.monotonic() < deadline:
        time.sleep(0.05)
    wd.stop()
    assert fired == [RESTART_EXIT_CODE]
    text = log.text()
    assert "no round completed in" in text
    assert "last completed round: 0" in text
    assert "--- Thread MainThread" in text and "local_devices" in text


def test_watchdog_heartbeat_defers_firing():
    fired = []
    wd = StallWatchdog(0.3, logger=ListLogger(), exit_fn=fired.append,
                       poll_s=0.05)
    wd.start()
    for _ in range(10):
        wd.heartbeat()
        time.sleep(0.05)
    wd.stop()
    assert not fired
    assert "format_thread_stacks" in format_thread_stacks()


# -- ElasticRunner -----------------------------------------------------------
class FakeChild:
    def __init__(self, rc, on_wait=None):
        self.rc, self.pid, self.on_wait = rc, 4242, on_wait

    def wait(self):
        if self.on_wait is not None:
            self.on_wait()
        return self.rc

    def poll(self):
        return self.rc


def _fake_ckpt(ckpt_dir, round_idx):
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(os.path.join(ckpt_dir, "checkpoint.ckpt"), "wb") as f:
        f.write(b"x")
    with open(os.path.join(ckpt_dir, "checkpoint.json"), "w") as f:
        json.dump({"round": round_idx}, f)


def _runner(ckpt_dir, script, cmd=("train", "--x"), **kw):
    cmds, delays = [], []
    it = iter(script)

    def popen(c, **_):
        cmds.append(c)
        rc, round_idx = next(it)
        return FakeChild(rc, None if round_idx is None else
                         (lambda ri=round_idx: _fake_ckpt(ckpt_dir, ri)))

    runner = ElasticRunner(list(cmd), ckpt_dir=ckpt_dir, popen=popen,
                           sleep_fn=delays.append, log_fn=lambda m: None,
                           **kw)
    return runner, cmds, delays


def test_restarts_on_75_and_appends_resume(tmp_path):
    ckpt = str(tmp_path)
    runner, cmds, _ = _runner(ckpt, [(RESTART_EXIT_CODE, 3), (0, 6)])
    assert runner.run() == 0 and runner.launches == 2
    assert cmds == [["train", "--x"], ["train", "--x", "--resume", ckpt]]


@pytest.mark.parametrize("pin", [["--resume", "elsewhere"],
                                 ["--resume=/warmstart"]])
def test_a_pinned_resume_is_never_duplicated(pin, tmp_path):
    _fake_ckpt(str(tmp_path), 1)
    runner, cmds, _ = _runner(str(tmp_path), [(0, None)],
                              cmd=["train"] + pin)
    assert runner.run() == 0 and cmds[0] == ["train"] + pin


def test_non_restartable_exit_propagates(tmp_path):
    runner, _, _ = _runner(str(tmp_path), [(1, None)])
    assert runner.run() == 1 and runner.launches == 1


def test_crash_loop_without_progress_gives_up(tmp_path):
    runner, _, _ = _runner(str(tmp_path), [(RESTART_EXIT_CODE, None)] * 10,
                           max_restarts=2)
    assert runner.run() == RESTART_EXIT_CODE
    assert runner.launches == 3 and runner.stalled_restarts == 3


def test_progress_resets_the_budget_and_backoff_doubles(tmp_path):
    script = [(RESTART_EXIT_CODE, r) for r in (1, 2, 3)] + [(0, 4)]
    runner, _, _ = _runner(str(tmp_path / "a"), script, max_restarts=1)
    assert runner.run() == 0 and runner.launches == 4
    runner, _, delays = _runner(
        str(tmp_path / "b"), [(RESTART_EXIT_CODE, None)] * 4 + [(0, None)],
        max_restarts=10, backoff_base_s=1.0, backoff_max_s=4.0)
    assert runner.run() == 0 and delays == [1.0, 2.0, 4.0, 4.0]


def test_read_checkpoint_round_and_the_harness_usage(tmp_path):
    assert read_checkpoint_round(None) is None
    assert read_checkpoint_round(str(tmp_path)) is None
    _fake_ckpt(str(tmp_path), 7)
    assert read_checkpoint_round(str(tmp_path)) == 7
    assert harness_main([]) == 2
    assert harness_main(["--ckpt_dir", str(tmp_path), "--"]) == 2


def test_supervise_subcommand_routes_to_the_harness():
    assert "supervise" not in tcli.SUBCOMMANDS
    assert tcli.main(["supervise"]) == 2  # the harness's usage error


# -- the CLI's drain ---------------------------------------------------------
def _stop_after(round_idx):
    def callback(r, trainer, server, clients, metrics):
        if r == round_idx:
            os.kill(os.getpid(), signal.SIGTERM)
    return callback


@pytest.mark.parametrize("extra", [
    [], ["--async_checkpoint"], ["--data_plane", "stream"],
    ["--eval_freq", "3"]], ids=["sync", "async", "stream", "no_eval_save"])
def test_a_stop_drains_at_the_round_boundary_and_resumes_bitwise(
        extra, tmp_path):
    words = ["--backend", "cpu", "--save_all_models", "true"] + extra
    ref = tcli.main(cli_argv(tmp_path / "ref", rounds=5, extra=words))
    run = tmp_path / "run"
    with pytest.raises(SystemExit) as ei:
        tcli.main(cli_argv(run, rounds=5, extra=words),
                  round_callback=_stop_after(1))
    assert ei.value.code == RESTART_EXIT_CODE
    assert read_checkpoint_round(str(run)) == 2  # drained after round 1
    assert read_health(str(run))["intent"] == "preempted"
    res = tcli.main(cli_argv(run, rounds=5, extra=words
                             + ["--resume", str(run)]))
    assert res["rounds"] == 5 and res["test_top1"] == ref["test_top1"]
    assert file_digest(str(run / "checkpoint.ckpt"), True) == \
        file_digest(str(tmp_path / "ref" / "checkpoint.ckpt"), True)
    _, rows, _ = load_jsonl(str(run / "metrics.jsonl"))
    from fedtorch_tpu_torch.telemetry import count_restarts, stitch_rows
    assert count_restarts(rows) == 1
    assert [r["round"] for r in stitch_rows(rows)] == list(range(5))
    _, events, _ = load_jsonl(str(run / "events.jsonl"))
    assert [e["reason"] for e in events if e["event"] == "preempt.drain"] \
        == ["SIGTERM"]


def test_the_drain_restores_the_signal_handlers(tmp_path):
    prev = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit):
        tcli.main(cli_argv(tmp_path / "run", rounds=3,
                           extra=["--backend", "cpu"]),
                  round_callback=_stop_after(0))
    assert signal.getsignal(signal.SIGTERM) == prev
    assert not [t for t in threading.enumerate()
                if t.name in ("stall-watchdog", "async-checkpointer")
                and t.is_alive()]


def test_a_raising_round_loop_lands_the_pending_async_checkpoint(tmp_path):
    def boom(r, *a):
        if r == 1:
            raise RuntimeError("loop died")

    run = tmp_path / "run"
    with pytest.raises(RuntimeError, match="loop died"):
        tcli.main(cli_argv(run, rounds=4, extra=[
            "--backend", "cpu", "--async_checkpoint"]),
            round_callback=boom)
    assert read_checkpoint_round(str(run)) == 2
    assert read_health(str(run))["intent"] == "error"
