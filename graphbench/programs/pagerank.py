"""The ``pagerank`` mix: solves to the program's tolerance, back to back.

Work a solve: the rounds it ran.  Checked against the float64
reference, as the configurations state: every sampled solve's ranks
against the reference's after as many rounds (``rank_rel_gap``), and its
stop by the L1 rule (``stop_l1``, the L1 change one more float64 round
makes from the solve's ranks).  Reported beside them: the solve's
rounds and those after which the reference's own rule stops.
"""

from __future__ import annotations

import torch

from graphbench import costs
from graphbench.reference.pagerank import PowerIteration


class Session:
    def __init__(self, cell, seed: int, n: int, e: int,
                 out_degree: torch.Tensor):
        self.traffic = cell.traffic
        self.n, self.e = n, e
        p = self.traffic["params"]
        self.iters, self.tol = int(p["iters"]), float(p["tol"])
        self.err_every = int(p["err_every"])
        self.alpha = float(self.traffic["alpha"])
        self._reference = None

    def bind(self, engine, params: dict) -> None:
        self.engine = engine
        self.garr = engine.device_graph()
        self.prog = engine.program(self.traffic["program"],
                                   self.traffic["variant"], **params)

    def call(self, i: int):
        return self.prog(self.garr)

    @staticmethod
    def work(outs) -> int:
        return int(outs[-1])

    @staticmethod
    def work_values(work: list) -> list[int]:
        return list(work)

    def least_bytes(self, rounds: int) -> int:
        return costs.pagerank_least_bytes(rounds, self.n, self.e)

    @staticmethod
    def answer(i: int, outs) -> dict:
        return {"rank": outs[0], "rounds": int(outs[-1])}

    def release(self) -> None:
        self.engine = self.garr = self.prog = None

    def reference(self, edges: torch.Tensor):
        """``(power, rounds)``: the float64 reference of the graph, and
        the rounds after which its stopping rule stops; worked out once a
        session."""
        if self._reference is None:
            power = PowerIteration(edges, self.n, self.alpha)
            _, rounds = power.until_stop(self.iters, self.tol,
                                         self.err_every)
            self._reference = (power, rounds, {})
        return self._reference[:2]

    def _after(self, rounds: int) -> torch.Tensor:
        power, _, ranks = self._reference
        if rounds not in ranks:
            ranks[rounds] = power.run(rounds)
        return ranks[rounds]

    def check(self, answers: list[dict], edges: torch.Tensor) -> dict:
        """``rank_rel_gap``: over the sample, the largest relative gap of
        a vertex's rank to the float64 reference's after as many rounds.
        ``stop_l1``: the largest L1 change one more float64 round makes
        from a sampled solve's ranks.  ``rounds`` and ``ref_rounds``: the
        most rounds a sampled solve ran, and the reference rule's."""
        power, ref_rounds = self.reference(edges)
        rel, stop, rounds = 0.0, 0.0, 0
        for a in answers:
            got = a["rank"].reshape(-1)[: self.n].to(edges.device).double()
            want = self._after(a["rounds"])
            rel = max(rel, float(((got - want).abs() / want).max()))
            stop = max(stop, float((power.step(got) - got).abs().sum()))
            rounds = max(rounds, a["rounds"])
        return {"rank_rel_gap": rel, "stop_l1": stop, "rounds": rounds,
                "ref_rounds": ref_rounds}
