"""Cross-host execution test: 2 real processes over jax.distributed.

The last SURVEY §2.4 coverage row: ``parallel/distributed.py`` must
actually run as more than one process.  ``jax.distributed`` works over
localhost gRPC with the CPU backend -- each worker owns 2 virtual CPU
devices, the global mesh spans 4, and the workers validate a sharded
render + a distributed train step against single-device references
(tests/distributed_worker.py).

The workers run under ``JAX_PLATFORMS=cpu`` only: this test starts several
JAX processes, and on a GPU machine each would try to reserve most of the
same card's memory.  Keep it on the CPU.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_distributed():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "distributed_worker.py")
    addr = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, worker, addr, "2", str(pid)],
            cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out:\n"
                    + "\n---\n".join(outs))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
        assert "DIST_OK" in out, out[-3000:]
