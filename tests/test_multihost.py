"""True multi-process jax.distributed scan: spawns two coordinator-
connected processes (4 virtual CPU devices each, global mesh of 8),
each holding only its host_slices() half of the corpus, and checks
parallel.multihost.count_multihost against the full-corpus native
count — a real 2-process jax.distributed run on the CPU
(BASELINE.md).  SREGEX_MULTIHOST=0 skips it."""

import os
import socket
import subprocess
import sys

import pytest

_HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.skipif(os.environ.get("SREGEX_MULTIHOST") == "0",
                    reason="multihost test disabled")
def test_two_process_distributed_count():
    port = str(_free_port())
    env = dict(os.environ)
    # the runner forces its own CPU platform / device count
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(_HERE, "multihost_runner.py"),
         str(pid), port],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=560)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "MULTIHOST_OK" in out, \
            "process %d:\n%s" % (pid, out[-3000:])
