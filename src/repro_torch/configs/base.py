"""Configuration dataclasses for graph workloads."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GraphConfig:
    """Paper-side workload: an Erdos-Renyi ('urand') or RMAT graph."""

    name: str
    scale: int                # 2**scale vertices
    avg_degree: int = 16
    generator: str = "urand"  # urand | rmat | smallworld
    directed: bool = True

    @property
    def num_vertices(self) -> int:
        return 1 << self.scale

    @property
    def num_edges(self) -> int:
        return self.num_vertices * self.avg_degree
