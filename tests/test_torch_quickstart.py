"""examples/quickstart_torch.py runs on the CPU when told to (BFS and
PageRank against its numpy oracle, batched BFS row 0 against the
single-source run) and imports no JAX."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RUN = """
import runpy, sys
sys.argv = ["quickstart_torch.py"] + sys.argv[1:]
runpy.run_path({path!r}, run_name="__main__")
assert "jax" not in sys.modules and "repro" not in sys.modules
"""


@pytest.mark.parametrize("parts", [1, 2])
def test_quickstart_torch_on_cpu(parts):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    code = _RUN.format(path=os.path.join(REPO, "examples",
                                         "quickstart_torch.py"))
    r = subprocess.run([sys.executable, "-c", code, "--device", "cpu",
                        "--parts", str(parts)], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.rstrip().endswith("OK"), r.stdout
    assert "multi-source BFS: 8 roots" in r.stdout
    assert "async BFS: " in r.stdout
