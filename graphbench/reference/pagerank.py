"""Plain PageRank power iteration over an edge list.

Semantics stated by the configurations: ranks start at ``1 / n``; a
round sets ``rank'[v] = (1 - alpha) / n + alpha * sum over edges (u, v)
of rank[u] / outdeg(u)`` (every edge counted, a vertex with no out-edge
passes nothing on); every ``err_every`` rounds the L1 change of that
round is compared with ``tol`` and the iteration stops once it is no
larger, or after ``iters`` rounds.

Plain torch in float64 over the benchmark's own edge list; imports
nothing of the program.
"""

from __future__ import annotations

import torch


class PowerIteration:
    """The rounds of one graph, its out-degrees worked out once."""

    def __init__(self, edges: torch.Tensor, n: int, alpha: float):
        self.src, self.dst = edges[:, 0], edges[:, 1]
        self.n, self.alpha = n, alpha
        outdeg = torch.bincount(self.src, minlength=n).double()
        self.inv_deg = torch.where(outdeg > 0, 1.0 / outdeg.clamp(min=1), 0)
        self.base = (1.0 - alpha) / n

    def start(self) -> torch.Tensor:
        return torch.full((self.n,), 1.0 / self.n, dtype=torch.float64,
                          device=self.src.device)

    def step(self, rank: torch.Tensor) -> torch.Tensor:
        z = torch.zeros_like(rank)
        z.index_add_(0, self.dst, (rank * self.inv_deg)[self.src])
        return self.base + self.alpha * z

    def run(self, rounds: int) -> torch.Tensor:
        """The rank after ``rounds`` rounds."""
        rank = self.start()
        for _ in range(rounds):
            rank = self.step(rank)
        return rank

    def until_stop(self, iters: int, tol: float, err_every: int
                   ) -> tuple[torch.Tensor, int]:
        """``(rank, rounds)`` where the stopping rule stops."""
        rank, rounds, err = self.start(), 0, float("inf")
        while rounds < iters and not err <= tol:
            new = self.step(rank)
            if (rounds + 1) % err_every == 0:
                err = float((new - rank).abs().sum())
            rank, rounds = new, rounds + 1
        return rank, rounds
