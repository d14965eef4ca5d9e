"""chip_smoke.py and bench.py measure the GPU only: without one they exit
non-zero and print no result line."""
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, script, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("args", [(), ("--chips", "4")])
def test_chip_smoke_refuses_the_cpu(args):
    r = _run("chip_smoke.py", ROOT, *args)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run("chip_smoke.py", tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_refuses_the_cpu():
    r = _run("bench.py", ROOT)
    assert r.returncode != 0
    assert "needs a GPU" in r.stderr
    assert r.stdout.strip() == ""
