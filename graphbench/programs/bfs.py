"""The ``bfs`` mix: searches from roots drawn from the seed.

Work a search: Graph500's count, the input edges whose source the
search reached (the out-degrees of the reached vertices, summed on the
device after the search's synchronise); of a symmetric graph, whose
edge list holds each undirected edge both ways, the undirected edges of
the reached component, half that sum.  Checked: every sampled
search's parents and rounds against the plain reference.
"""

from __future__ import annotations

import torch

from graphbench import costs, generate
from graphbench.reference import bfs as ref

UNREACHED = ref.UNREACHED


class Session:
    def __init__(self, cell, seed: int, n: int, e: int,
                 out_degree: torch.Tensor):
        self.traffic = cell.traffic
        self.n, self.e = n, e
        stream = int(self.traffic["root_stream"])
        self.roots = generate.draw_roots(out_degree, stream, seed).tolist()
        self.out_degree = out_degree.to(torch.int64)
        self.max_levels = int(self.traffic["params"]["max_levels"])
        self.per_edge = 2 if cell.config.get("symmetric", False) else 1

    def bind(self, engine, params: dict) -> None:
        self.engine = engine
        self.garr = engine.device_graph()
        self.prog = engine.program(self.traffic["program"],
                                   self.traffic["variant"], **params)
        n_pad = engine.g.n
        deg = torch.zeros(n_pad, dtype=torch.int64, device=engine.device)
        deg[: self.n] = self.out_degree.to(engine.device)
        self.deg = deg
        self.out_degree = None

    def root(self, i: int) -> int:
        # the window cycles over the stream; warm-up calls (i < 0) take
        # roots from its end
        return self.roots[i % len(self.roots)]

    def call(self, i: int):
        return self.prog(self.garr, self.root(i))

    def work(self, outs) -> torch.Tensor:
        reached = outs[0].reshape(-1) < UNREACHED
        return (self.deg * reached).sum()

    def work_values(self, work: list) -> list[int]:
        if not work:
            return []
        return [w // self.per_edge for w in torch.stack(work).tolist()]

    def least_bytes(self, traversed: int) -> int:
        return costs.bfs_least_bytes(traversed, self.n)

    def answer(self, i: int, outs) -> dict:
        return {"root": self.root(i), "parents": outs[0],
                "rounds": int(outs[1])}

    def release(self) -> None:
        self.engine = self.garr = self.prog = self.deg = None

    def check(self, answers: list[dict], edges: torch.Tensor) -> dict:
        """``bfs_errors``: over the sample, the vertices whose parent is
        not the reference's plus the rounds by which they differ."""
        errors = 0
        for a in answers:
            want, rounds = ref.bfs(edges, self.n, a["root"], self.max_levels)
            got = a["parents"].reshape(-1)[: self.n].to(edges.device)
            errors += int((got.to(torch.int64) != want).sum())
            errors += abs(a["rounds"] - rounds)
        return {"bfs_errors": errors}

    def control(self, edges: torch.Tensor, count: int) -> list[dict]:
        """The control's answers for the first ``count`` roots: the
        reference in the program's place with the parent rule broken
        (the largest-id in-neighbour one level up, a BFS tree all the
        same)."""
        out = []
        for i in range(count):
            parents, rounds = ref.bfs(edges, self.n, self.root(i),
                                      self.max_levels, pick="amax")
            out.append({"root": self.root(i), "parents": parents,
                        "rounds": rounds})
        return out
