"""Start the processes of a multi-process run on this host and wait for them.

:func:`run_ranks` starts one command a rank, all together, and waits for
every one within one deadline. A rank that fails or outlives the deadline
gets the others killed (a rank left alone waits on its collectives forever)
and raises ``RuntimeError`` with the end of each rank's output; the output
goes to files, so a chatty rank never blocks on a full pipe.
"""

from __future__ import annotations

import os
import socket
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Sequence


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(commands: Sequence[Sequence[str]], timeout_s: float,
              env: Optional[Dict[str, str]] = None,
              cwd: Optional[str] = None) -> List[str]:
    """Run ``commands`` (one a rank) side by side; returns each rank's
    output (stdout and stderr) when every rank exits 0 in time."""
    logs = [tempfile.TemporaryFile(mode="w+") for _ in commands]
    procs = [subprocess.Popen(list(cmd), stdout=log, stderr=subprocess.STDOUT,
                              env=env, cwd=cwd)
             for cmd, log in zip(commands, logs)]
    deadline = time.monotonic() + timeout_s
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.returncode not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                break
            if time.monotonic() > deadline:
                failed = f"ranks still running after {timeout_s:.0f} s"
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    if failed is None:
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
    if failed is not None:
        tails = "\n".join(f"--- rank {r} (exit {p.returncode}):\n{o[-3000:]}"
                          for r, (p, o) in enumerate(zip(procs, outs)))
        raise RuntimeError(f"{failed}\n{tails}")
    return outs


def rank_env(threads: int = 0) -> Dict[str, str]:
    """This process's environment for a rank; ``threads`` > 0 pins the
    intra-op threads of each rank (CPU runs side by side)."""
    env = dict(os.environ)
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    return env
