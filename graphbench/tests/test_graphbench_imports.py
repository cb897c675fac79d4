"""Nothing the benchmark loads is JAX or the JAX package, and the
reference loads nothing of the program."""

import ast
import subprocess
import sys

import torch

from graphbench import manifest

RUN = '''
import sys
sys.path[:0] = [".", "src"]
import torch
torch.set_num_threads(1)
import dataclasses
import json
from graphbench import harness, manifest, control, run
kron = manifest.HERE / "configs" / "gap-kron22.json"
for name, config in (("urand22-bfs", None), ("urand22-pagerank", kron)):
    cell = manifest.cell(manifest.load(), name)
    base = cell.config if config is None else json.loads(config.read_text())
    cell = dataclasses.replace(cell, config={**base, "scale": 9,
                                             "edge_factor": 4})
    harness.run_cell(cell, 3, 0.1, False, device="cpu")
    for m in cell.end_to_end + cell.per_layer:
        manifest.reader(m["name"])
print(sorted({m.split(".")[0] for m in sys.modules}))
'''


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=manifest.ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_not_the_jax_package():
    tops = _loaded(RUN)
    assert "repro_torch" in tops and "graphbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    tops = _loaded("import sys; sys.path.insert(0, '.');"
                   "import graphbench.reference.bfs,"
                   " graphbench.reference.pagerank;"
                   "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert not tops & {"repro_torch", "repro", "jax"}
    for path in (manifest.HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] \
                    if isinstance(node, ast.Import) else [node.module]
                for name in names:
                    assert name.split(".")[0] in (
                        "torch", "numpy", "__future__"), (path, name)


def test_the_entry_point_refuses_a_machine_without_a_card():
    if torch.cuda.is_available():
        return  # the card's own runs exercise the other branch
    out = subprocess.run([sys.executable, "graphbench/run.py", "--workload",
                          "urand22-bfs", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=manifest.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
