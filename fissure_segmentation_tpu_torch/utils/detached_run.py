"""Detached (nohup) experiment execution.

The port's copy of utils/detached_run.py.

Parity with reference utils/detached_run.py:11-48: when `--offline` is set,
the script re-executes itself under nohup with output redirected to
``<output>/logs/<script>_<timestamp>.txt`` and the parent exits.
"""
from __future__ import annotations

import os
import subprocess
import sys
from datetime import datetime


def maybe_run_detached_cli(args) -> None:
    if not getattr(args, "offline", False):
        return
    log_dir = os.path.join(getattr(args, "output", "./results"), "logs")
    os.makedirs(log_dir, exist_ok=True)
    script = os.path.basename(sys.argv[0]).replace(".py", "")
    ts = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    log_file = os.path.join(log_dir, f"{script}_{ts}.txt")

    argv = [a for a in sys.argv if a != "--offline"]
    with open(log_file, "w") as log:
        subprocess.Popen(["nohup", sys.executable, "-u", *argv],
                         stdout=log, stderr=subprocess.STDOUT,
                         preexec_fn=os.setpgrp)
    print(f"detached; logging to {log_file}")
    sys.exit(0)
