"""Multi-process distributed encode (SURVEY.md §5.8 / §4).

Spawns N=2 fresh python processes, each with 4 virtual CPU devices,
joined via ``jax.distributed.initialize`` into one 8-device runtime; both
run the data-parallel encoder over the global mesh and must produce the
same zlib-verified bitstream.  This is the multi-process CPU simulation
the survey mandates for testing the multi-host path without a pod.

Runs OUTSIDE the session's normal jax process (subprocesses get their own
runtime), so it is safe alongside the conftest CPU config.
"""
import os
import socket
import subprocess
import sys
import textwrap

import pytest

WORKER = textwrap.dedent("""
    import os, sys, zlib
    coord, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.getcwd())
    from deflate_jax.parallel import distributed as DD
    DD.init(coord, nproc, pid, local_device_count=4)
    import jax
    assert len(jax.devices()) == nproc * 4, jax.devices()
    assert len(jax.local_devices()) == 4

    import numpy as np
    rng = np.random.default_rng(7)
    data = (rng.integers(97, 123, 200000, dtype=np.uint8).tobytes()
            + bytes(50000)
            + rng.integers(0, 256, 80000, dtype=np.uint8).tobytes())
    stream = DD.compress_distributed(data, level=2)
    assert zlib.decompress(stream, -15) == data, "distributed round trip"
    print(f"proc{pid} ok {len(stream)}", flush=True)
""")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


@pytest.mark.slow
def test_two_process_encode(tmp_path):
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    wf = tmp_path / "worker.py"
    wf.write_text(WORKER)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, str(wf), coord, "2", str(pid)],
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed workers timed out")
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{out}\n{err}"
    sizes = {o.split()[-1] for _, o, _ in outs}
    assert len(sizes) == 1, f"processes disagree: {outs}"
