"""Per-host auto-restart harness: the outer half of self-healing (port of
``fedtorch_tpu/robustness/harness.py``, a copy).

The inner half (``preemption.py`` / ``watchdog.py``) makes a training
process *exit 75* with a drained checkpoint whenever it is preempted or
wedged. This module closes the loop: :class:`ElasticRunner` launches
the training command, and whenever it exits with a restartable code it
relaunches it with ``--resume <ckpt_dir>`` so the job continues from
the last durable round — unattended.

Two failure disciplines keep a broken job from cycling forever:

* **exponential backoff** between restarts (``backoff_base_s``
  doubling, capped at ``backoff_max_s``) so a fast crash loop cannot
  hammer the scheduler;
* **progress-gated retry budget**: before each relaunch the harness
  reads ``checkpoint.json``'s ``round``. A restart that *advanced* the
  round is free — real recovery earns fresh budget and resets the
  backoff. Only consecutive restarts that failed to advance the round
  count against ``max_restarts``; when they exhaust it the harness
  gives up and propagates the child's exit code. A genuinely
  self-healing job can therefore restart indefinitely, while a
  deterministic crash-on-resume dies after ``max_restarts`` tries.

SIGTERM/SIGINT to the harness are forwarded to the child and disable
further restarts (the whole host is going away — draining the child is
all that is left to do). Entry point: ``python -m fedtorch_tpu_torch.cli
supervise --ckpt_dir RUN_DIR -- python -m fedtorch_tpu_torch.cli ...
--run_dir RUN_DIR``.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from typing import Callable, Optional, Sequence

from fedtorch_tpu_torch.robustness.preemption import RESTART_EXIT_CODE


def read_exit_intent(ckpt_dir: Optional[str]) -> Optional[str]:
    """The child's machine-readable exit intent from the run dir's
    ``health.json`` (fedtorch_tpu_torch.telemetry, docs/observability.md):
    'preempted' = clean SIGTERM drain, 'stalled' = watchdog fired on a
    wedged process, 'error' = the round loop raised. None when the file is
    missing (telemetry off / pre-telemetry run) or unreadable — the
    harness logs the intent but never gates on it, so it keeps
    supervising heterogeneous jobs."""
    if ckpt_dir is None:
        return None
    try:
        from fedtorch_tpu_torch.telemetry import read_health
        doc = read_health(ckpt_dir)
        return None if doc is None else str(doc.get("intent"))
    except Exception:  # schema skew must not kill the harness
        return None


def read_checkpoint_round(ckpt_dir: Optional[str]) -> Optional[int]:
    """The round recorded in ``<ckpt_dir>/checkpoint.json`` — the
    harness's only probe into the job's progress. None when the file
    is missing or unreadable (corrupt meta must not kill the harness:
    resume itself skips corrupt meta and starts fresh)."""
    if ckpt_dir is None:
        return None
    try:
        with open(os.path.join(ckpt_dir, "checkpoint.json")) as f:
            return int(json.load(f)["round"])
    except (OSError, ValueError, KeyError, TypeError):
        return None


class ElasticRunner:
    """Launch-and-relaunch supervisor for one host's training process.

    ``popen``/``sleep_fn`` are injectable for tests. ``log_fn``
    receives one-line status strings (default: stderr)."""

    def __init__(self, cmd: Sequence[str], ckpt_dir: Optional[str] = None,
                 max_restarts: int = 5, backoff_base_s: float = 1.0,
                 backoff_max_s: float = 60.0,
                 restart_codes: Sequence[int] = (RESTART_EXIT_CODE,),
                 resume_flag: str = "--resume",
                 popen: Callable = subprocess.Popen,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 log_fn: Optional[Callable[[str], None]] = None):
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got "
                             f"{max_restarts}")
        self.cmd = list(cmd)
        self.ckpt_dir = ckpt_dir
        self.max_restarts = max_restarts
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.restart_codes = frozenset(restart_codes)
        self.resume_flag = resume_flag
        self.popen = popen
        self.sleep_fn = sleep_fn
        self.log_fn = log_fn if log_fn is not None else (
            lambda m: print(m, file=sys.stderr, flush=True))
        self.launches = 0
        self.stalled_restarts = 0  # consecutive non-advancing restarts
        self._draining = False
        self._child = None

    # -- command construction ------------------------------------------
    def _build_cmd(self) -> list:
        """Append ``--resume <ckpt_dir>`` once a checkpoint exists so
        the relaunch continues instead of restarting from scratch. A
        command that already carries the flag is left alone (the
        operator pinned a resume source)."""
        cmd = list(self.cmd)
        pinned = any(a == self.resume_flag
                     or a.startswith(self.resume_flag + "=")
                     for a in cmd)
        if (self.ckpt_dir is not None and not pinned
                and os.path.exists(os.path.join(self.ckpt_dir,
                                                "checkpoint.ckpt"))):
            cmd += [self.resume_flag, self.ckpt_dir]
        return cmd

    # -- signal forwarding ----------------------------------------------
    def _forward(self, signum, frame) -> None:
        self._draining = True
        child = self._child
        if child is not None and child.poll() is None:
            try:
                child.send_signal(signum)
            except OSError:  # child raced to exit
                pass

    # -- the supervise loop ---------------------------------------------
    def run(self) -> int:
        prev = {}
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev[sig] = signal.signal(sig, self._forward)
        except ValueError:  # not the main thread (tests) — no forwarding
            prev = {}
        try:
            return self._loop()
        finally:
            for sig, p in prev.items():
                try:
                    signal.signal(sig, p)
                except (ValueError, OSError):
                    pass

    def _loop(self) -> int:
        while True:
            round_before = read_checkpoint_round(self.ckpt_dir)
            cmd = self._build_cmd()
            self.launches += 1
            self._child = self.popen(cmd)
            self._log(f"launch #{self.launches} pid="
                      f"{getattr(self._child, 'pid', '?')} "
                      f"round={round_before} cmd={' '.join(cmd)}")
            rc = self._child.wait()
            if self._draining:
                self._log(f"draining (signal forwarded); child exited "
                          f"{rc}, not restarting")
                return rc
            if rc not in self.restart_codes:
                if rc != 0:
                    self._log(f"child exited {rc} (not restartable); "
                              "giving up")
                return rc

            round_after = read_checkpoint_round(self.ckpt_dir)
            intent = read_exit_intent(self.ckpt_dir)
            if intent is not None:
                self._log(f"child health intent: {intent}")
            advanced = (round_after is not None
                        and (round_before is None
                             or round_after > round_before))
            if advanced:
                # real progress: recovery is working — fresh budget
                self.stalled_restarts = 0
            else:
                self.stalled_restarts += 1
                if self.stalled_restarts > self.max_restarts:
                    self._log(
                        f"child exited {rc} but the checkpoint round "
                        f"({round_after}) has not advanced across "
                        f"{self.stalled_restarts} consecutive restarts "
                        "— crash loop, giving up")
                    return rc
            delay = min(
                self.backoff_base_s
                * (2.0 ** max(self.stalled_restarts - 1, 0)),
                self.backoff_max_s)
            self._log(
                f"child exited {rc} (restartable) round={round_after} "
                f"advanced={advanced} "
                f"stalled={self.stalled_restarts}/{self.max_restarts}; "
                f"relaunching in {delay:.1f}s")
            self.sleep_fn(delay)

    def _log(self, msg: str) -> None:
        self.log_fn(f"run_elastic: {msg}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="run_elastic",
        description="Auto-restart harness: relaunch the training "
                    "command with --resume on restartable exits "
                    "(exit code 75)",
        epilog="Usage: run_elastic [options] -- <training command...>")
    p.add_argument("--ckpt_dir", default=None,
                   help="run directory holding checkpoint.json/"
                        "checkpoint.ckpt; enables --resume relaunch "
                        "and crash-loop detection (pass the same "
                        "directory as the training command's --run_dir)")
    p.add_argument("--max_restarts", type=int, default=5,
                   help="consecutive restarts WITHOUT checkpoint-round "
                        "progress before giving up (progress resets "
                        "the budget)")
    p.add_argument("--backoff_base", type=float, default=1.0)
    p.add_argument("--backoff_max", type=float, default=60.0)
    p.add_argument("--restart_codes", default=str(RESTART_EXIT_CODE),
                   help="comma-separated exit codes that trigger a "
                        "relaunch (default: 75, EX_TEMPFAIL)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" not in argv:
        build_parser().print_help(sys.stderr)
        print("\nrun_elastic: missing '-- <training command>'",
              file=sys.stderr)
        return 2
    split = argv.index("--")
    args = build_parser().parse_args(argv[:split])
    cmd = argv[split + 1:]
    if not cmd:
        print("run_elastic: empty training command after '--'",
              file=sys.stderr)
        return 2
    runner = ElasticRunner(
        cmd, ckpt_dir=args.ckpt_dir, max_restarts=args.max_restarts,
        backoff_base_s=args.backoff_base, backoff_max_s=args.backoff_max,
        restart_codes=tuple(int(c) for c in
                            args.restart_codes.split(",") if c))
    return runner.run()


if __name__ == "__main__":
    raise SystemExit(main())
