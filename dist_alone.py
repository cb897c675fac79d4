"""Time ``chip_smoke.py``'s ``[dist]`` phase alone on the card: build the
graph kernels, generate GRAPH and partition it at each of PARTS, run
``run_dist`` and print its lines and its seconds (``[dist done]``).

    python3 dist_alone.py               # this checkout's chip_smoke.py
    python3 dist_alone.py CHECKOUT      # another checkout's, e.g. a parent
                                        # unpacked with `git archive`

Each checkout runs in a process of its own (its ``chip_smoke.py`` imports
its own ``src``), so two are timed on one card by two invocations in one
command, in turns: parent, this tree, this tree, parent.
"""

import sys
import time
from pathlib import Path


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else __file__).resolve()
    if root.is_file():
        root = root.parent
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    t0 = time.perf_counter()
    port = cs.Port()
    if not port.torch.cuda.is_available():
        print("dist_alone: no CUDA device", file=sys.stderr)
        return 1
    port.build.build_all()
    port.localops.set_mode("auto")
    gcfg = port.graph_workloads.ALL[cs.GRAPH]
    edges = port.generate_edges(gcfg, cs.SEED)
    engines = {}
    for parts in cs.PARTS:
        g = port.partition_graph(edges, gcfg.num_vertices, parts)
        eng = port.GraphEngine(g, device="cuda")
        engines[parts] = (g, eng, eng.device_graph())
    del edges
    print(f"[dist-alone] {root}: kernels and graphs ready in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cs.run_dist(port, engines, "cuda")
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
