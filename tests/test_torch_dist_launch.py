"""The graph launcher under ``torchrun``: two gloo ranks, one part each
(``DistComm``), print the program list, rounds and ``[verify]`` lines
of the one-process run at parts 2 (``StackedComm``), and the mesh line
that names the deployment."""

import os
import re
import shutil
import subprocess
import sys

from conftest import REPO, SRC

ARGS = ["-m", "repro_torch.launch.graph_analytics", "--graph", "urand12",
        "--parts", "2", "--device", "cpu"]


def _lines(out: str) -> list[str]:
    """The launcher's lines without their times: program, rounds and
    every ``[verify]`` verdict."""
    keep = []
    for line in out.splitlines():
        if line.startswith("[verify]"):
            keep.append(line)
        elif line.startswith("[graph]") and "rounds=" in line:
            name, rounds = line.split()[1], line.split("rounds=")[1]
            keep.append(f"{name} rounds={rounds}")
    return keep


def _run(cmd):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    r = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


def test_torchrun_two_ranks_match_one_process():
    torchrun = shutil.which("torchrun") or os.path.join(
        os.path.dirname(sys.executable), "torchrun")
    dist = _run([torchrun, "--standalone", "--nproc-per-node", "2", *ARGS])
    one = _run([sys.executable, *ARGS])
    assert "[graph] mesh: 2 ranks over gloo, one part a rank (DistComm)" \
        in dist
    assert "mesh:" not in one
    got, want = _lines(dist), _lines(one)
    assert len([x for x in want if "rounds=" in x]) == 16, want
    assert sum(x.startswith("[verify]") for x in want) >= 8, want
    assert got == want
    # rank 0 alone prints: every line once
    assert len(re.findall(r"^\[graph\] bfs_fast ", dist, re.M)) == 1
