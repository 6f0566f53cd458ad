"""The preemption drill: SIGTERM a training process mid-run under the
restart harness, and let it resume.

:func:`kill_drill` runs a command line of ``python -m
fedtorch_tpu_torch.cli`` under :class:`~fedtorch_tpu_torch.robustness.
harness.ElasticRunner` with ``--run_dir RUN_DIR``. The first child gets
SIGTERM as soon as it logs the train line of round ``kill_after`` (its
``--debug`` console output), must drain at the next round boundary and
exit with 75; the harness relaunches it with ``--resume RUN_DIR`` and the
second child runs to the end. With ``--save_all_models true
--checkpoint_keep_last_n 0`` the run directory then holds a keep of
every round, written by whichever child ran it, which the caller holds
bitwise against an uninterrupted run's.

``tests/test_torch_cli_lifecycle.py`` runs it on the CPU and
``chip_smoke.py``'s ``lifecycle`` phase on the card.
"""
from __future__ import annotations

import os
import re
import signal
import subprocess
import threading
import time
from typing import List, Optional, Sequence

from fedtorch_tpu_torch.robustness.harness import ElasticRunner


def kill_drill(cmd: Sequence[str], run_dir: str, kill_after: int = 1,
               timeout_s: float = 600.0, env: Optional[dict] = None,
               max_restarts: int = 2) -> dict:
    """Run the drill; returns ``{"rcs", "rc", "launches", "killed_after",
    "outputs", "harness_log", "seconds"}``: each child's exit code in
    launch order, the harness's, the number of launches, the round whose
    train line triggered the SIGTERM, each child's console lines and the
    harness's log lines. A child still running after ``timeout_s`` is
    killed (its code is then -9)."""
    train_line = re.compile(rf"Round: {int(kill_after)}\. Epoch: ")
    procs: List[subprocess.Popen] = []
    outputs: List[List[str]] = []
    readers: List[threading.Thread] = []
    log: List[str] = []
    killed = {"after": None}
    t0 = time.perf_counter()

    def popen(c, **_):
        proc = subprocess.Popen(c, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                bufsize=1, env=env)
        lines: List[str] = []
        first = not procs
        procs.append(proc)
        outputs.append(lines)

        def read():
            for line in proc.stdout:
                lines.append(line.rstrip("\n"))
                if first and killed["after"] is None \
                        and train_line.search(line):
                    killed["after"] = int(kill_after)
                    try:
                        os.kill(proc.pid, signal.SIGTERM)
                    except ProcessLookupError:  # raced to exit
                        pass

        reader = threading.Thread(target=read, daemon=True,
                                  name=f"kill-drill-reader-{len(procs)}")
        reader.start()
        readers.append(reader)
        return proc

    def watchdog():
        while not done.wait(1.0):
            if time.perf_counter() - t0 > timeout_s:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                return

    done = threading.Event()
    guard = threading.Thread(target=watchdog, daemon=True,
                             name="kill-drill-timeout")
    guard.start()
    runner = ElasticRunner(list(cmd), ckpt_dir=run_dir,
                           max_restarts=max_restarts, popen=popen,
                           sleep_fn=lambda s: None, log_fn=log.append)
    try:
        rc = runner.run()
    finally:
        done.set()
        guard.join(5)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
        for r in readers:
            r.join(10)
    return {"rcs": [p.returncode for p in procs], "rc": rc,
            "launches": runner.launches, "killed_after": killed["after"],
            "outputs": outputs, "harness_log": log,
            "seconds": time.perf_counter() - t0}
