"""2-process multi-host wiring test.

The multi-process path (parallel/multihost.py: jax.distributed.initialize,
the mesh factory, host-local I/O slabs) is exercised with two OS processes
on localhost — CPU devices, the same `jax.distributed` + global-Array
machinery a multi-host GPU run uses. Each worker checks sharded ==
single-device on its own addressable shards (tests/multihost_worker.py).
"""

import os
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_sharded_step():
    # worker communicate() below enforces its own 240 s timeout
    port = _free_port()
    # a clean CPU-only environment: the worker sets its own device count
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen([sys.executable, WORKER, str(i), "2", str(port)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, env=env)
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out:\n"
                    + "\n---\n".join(outs))

    finally:
        import shutil
        import tempfile
        shutil.rmtree(os.path.join(tempfile.gettempdir(),
                                   f"swmhd_mh_ckpt_{port}"),
                      ignore_errors=True)
        shutil.rmtree(os.path.join(tempfile.gettempdir(),
                                   f"swmhd_mh_fields_{port}"),
                      ignore_errors=True)

    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 and ("distributed" in out.lower()
                                  and "unimplemented" in out.lower()):
            pytest.skip(f"jax.distributed unsupported on CPU here:\n{out}")
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert "MULTIHOST-OK" in out, f"worker {i} output:\n{out}"
