"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of the JAX package ``repro``."""

import ast
import os
import subprocess
import sys

from conftest import REPO, SRC

PORT = os.path.join(SRC, "repro_torch")
CHIP_SMOKE = os.path.join(REPO, "chip_smoke.py")
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = [CHIP_SMOKE]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    return files


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax_or_reference():
    files = _port_files()
    assert len(files) > 20, files
    assert {os.path.join(PORT, "core", m) for m in
            ("faults.py", "recovery.py")} <= set(files)
    assert {os.path.join(PORT, "obs", m) for m in
            ("__init__.py", "registry.py", "spans.py", "telemetry.py",
             "report.py", "trace_export.py")} <= set(files)
    assert {os.path.join(PORT, *m) for m in
            (("serve", "server.py"), ("serve", "executor.py"),
             ("core", "compat.py"), ("launch", "graph_serve.py"),
             ("serve", "dynamic", "__init__.py"),
             ("serve", "dynamic", "mutation.py"),
             ("serve", "dynamic", "stream.py"),
             ("serve", "persist", "__init__.py"),
             ("serve", "persist", "crashpoints.py"),
             ("serve", "persist", "wal.py"),
             ("serve", "persist", "snapshot.py"),
             ("serve", "persist", "recover.py"),
             ("core", "dryrun.py"), ("launch", "dryrun.py"),
             ("roofline", "analysis.py"), ("roofline", "jaxpr_cost.py"),
             ("launch", "steps.py"), ("launch", "train.py"),
             ("optim", "adamw.py"), ("checkpoint", "checkpoint.py"),
             ("distributed", "fault_tolerance.py"),
             ("distributed", "compression.py"),
             ("distributed", "__init__.py"),
             ("distributed", "actctx.py"),
             ("models", "moe.py"), ("models", "mamba2.py"),
             ("launch", "mesh.py"), ("roofline", "recost.py"),
             ("models", "params.py"), ("models", "model.py"))} <= set(files)
    bad = [(os.path.relpath(f, REPO), root) for f in files
           for root in _imported_roots(f) if root in FORBIDDEN]
    assert not bad, f"forbidden imports: {bad}"


_IMPORT_ALL = r"""
import importlib, importlib.util, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("IMPORTED", len(names))
"""


def test_importing_every_module_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL.format(smoke=CHIP_SMOKE)],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    n = int(r.stdout.split("IMPORTED")[1])
    assert n >= 20, r.stdout


_TELEMETRY_RUN = r"""
import sys
import repro_torch.obs
from repro_torch.core import CheckpointRunner, GraphEngine, partition_graph
from repro_torch.graphs import urand_edges
from repro_torch.obs import SpanRecorder, chrome_trace, recording, \
    validate_chrome_trace
eng = GraphEngine(partition_graph(urand_edges(128, 512, seed=3), 128, 2),
                  device="cpu")
garr = eng.device_graph()
prog = eng.program("bfs", "fast", telemetry=True)
rec = SpanRecorder()
with recording(rec):
    tel = prog.run_telemetry(prog(garr, 0)[-1])
    rep = CheckpointRunner(eng, "pagerank", "fast", telemetry=True,
                           obs=rec).run(garr)
validate_chrome_trace(chrome_trace(rec.spans(), rec.events()))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("TELEMETRY-RUN", tel.series.rounds, rep.telemetry["rounds"])
"""


def test_telemetry_run_loads_no_jax():
    """Importing ``repro_torch.obs``, a telemetry build's run and a traced
    checkpointed run leave jax and the JAX package unloaded."""
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", _TELEMETRY_RUN], env=env,
                       capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "TELEMETRY-RUN" in r.stdout, r.stdout


_DURABLE_RUN = r"""
import sys, tempfile
import numpy as np
from repro_torch.core import GraphEngine, partition_graph
from repro_torch.graphs import urand_edges
from repro_torch.serve import GraphServer, Persistence, query
eng = GraphEngine(partition_graph(urand_edges(256, 2048, seed=3), 256, 2),
                  device="cpu")
d = tempfile.mkdtemp()
server = GraphServer(eng, buckets=(4,), persistence=Persistence(
    d, snapshot_every=1, fsync=False))
dyn = server.dynamic_graph()
rng = np.random.default_rng(0)
server.mutate(deletes=dyn.sample_deletable(8, rng))
server.mutate(inserts=dyn.sample_insertable(8, rng))
rec = GraphServer.recover(d, device="cpu", buckets=(4,))
res = rec.serve([query("bfs", root=3)])[0]
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("DURABLE-RUN", rec.epoch, res.status)
"""


def test_dynamic_and_durable_run_loads_no_jax():
    """Mutating a durable server, recovering it and serving from the
    recovered one leave jax and the JAX package unloaded."""
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", _DURABLE_RUN], env=env,
                       capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "DURABLE-RUN 2 ok" in r.stdout, r.stdout


_PLAN_AND_TRAIN = r"""
import sys, tempfile
import torch
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import smoke_config
from repro_torch.core.dryrun import lower_graph_programs
from repro_torch.launch.train import train
recs = lower_graph_programs("urand12", "pod", algos=("bfs_fast",
                                                     "pagerank_fast"))
d = tempfile.mkdtemp()
tc = TrainConfig(total_steps=4, warmup_steps=1, checkpoint_dir=d,
                 checkpoint_every=2)
train(smoke_config("tinyllama-1.1b"), tc, batch=2, seq=32, steps=4,
      device="cpu", simulate_failure=3, log_every=1)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("PLAN-AND-TRAIN", len(recs))
"""


def test_dryrun_and_training_load_no_jax():
    """Planning programs on meta tensors, and training with checkpoints
    and a simulated failure, leave jax and the JAX package unloaded."""
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", _PLAN_AND_TRAIN], env=env,
                       capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "PLAN-AND-TRAIN 2" in r.stdout, r.stdout


_DIST_RUN = r"""
import sys, tempfile
import torch
import torch.distributed as dist
from repro_torch.core import GraphEngine, partition_graph
from repro_torch.distributed import compress_tree, init_ef_state
from repro_torch.graphs import urand_edges
from repro_torch.launch.mesh import make_graph_mesh
dist.init_process_group("gloo", init_method="file://" + tempfile.mkdtemp()
                        + "/rdzv", rank=0, world_size=1)
eng = GraphEngine(partition_graph(urand_edges(128, 512, seed=3), 128, 1),
                  device="cpu", mesh=make_graph_mesh(1))
garr = eng.device_graph()
parents, rounds = eng.program("bfs", "fast")(garr, 0)
grads = {"w": torch.ones(8)}
q, s, r = compress_tree(grads, init_ef_state(grads))
dist.destroy_process_group()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("DIST-RUN", type(eng.comm).__name__, rounds, int(q["w"][0]))
"""


def test_distcomm_and_compression_run_loads_no_jax():
    """A program over a one-rank gloo group (``DistComm``) and a
    compressed gradient tree leave jax and the JAX package unloaded."""
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", _DIST_RUN], env=env,
                       capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "DIST-RUN DistComm" in r.stdout and r.stdout.split()[-1] \
        == "127", r.stdout
