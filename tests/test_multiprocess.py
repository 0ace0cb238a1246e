"""Real multi-controller execution: 2 OS processes, Gloo collectives.

The multi-host path must be exercised
past the single-process no-op. This spawns two genuine ``jax.distributed``
processes (CPU backend, 2 virtual devices each → a 4-device global mesh)
and runs the whole multi-controller story — process-local ingest, a
global-tree build whose collectives cross the process boundary, and the
cross-process multislice merge. See ``multiprocess_worker.py`` for what
each process asserts.
"""

import os
import socket
import subprocess
import sys

WORKER = os.path.join(os.path.dirname(__file__), "multiprocess_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed():
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # the worker pins its own device count
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), str(port)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out.decode(errors="replace"))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (
            f"process {pid} failed (rc={p.returncode}):\n{out[-4000:]}"
        )
        assert f"PROC {pid} ALL-OK" in out
