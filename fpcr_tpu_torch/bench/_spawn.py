"""Start the ranks of a gloo world on the CPU as OS processes, as the
multi-process scripts' parents do."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Sequence

_ROOT = str(Path(__file__).resolve().parents[2])  # the package's parent


def free_port() -> int:
    """A free localhost port. Probe-then-bind races with any other process
    taking the port in between: an 'address already in use' from a rank is
    that race, and a rerun clears it."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(module: str, world: int, args: Sequence[str], ok_line: str,
              timeout: float = 600.0) -> bool:
    """Run ``python -m module *args --rank r --world world --port p`` for
    every rank at once; print each rank's output; True if every rank
    exited 0 and printed ``ok_line``. Ranks still running at the end are
    killed."""
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    with tempfile.TemporaryDirectory(prefix="fpcr_ranks_") as tmp:
        logs = [open(Path(tmp) / f"rank{r}.log", "w+") for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", module, *args, "--rank", str(r),
             "--world", str(world), "--port", str(port)],
            env=env, stdout=logs[r], stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        ok = True
        try:
            for r, p in enumerate(procs):
                try:
                    p.wait(timeout=timeout)
                except subprocess.TimeoutExpired:
                    print(f"[parent] rank {r} timed out after {timeout} s")
                    ok = False
                    break
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for r, (p, log) in enumerate(zip(procs, logs)):
                log.seek(0)
                out = log.read()
                log.close()
                sys.stdout.write(out)
                if p.returncode != 0 or ok_line not in out:
                    ok = False
                    print(f"[parent] rank {r} FAILED (rc={p.returncode})")
        sys.stdout.flush()
    return ok
