"""GAP's uniform random graph: ``e`` edges with independently uniform
endpoints."""

from __future__ import annotations

import torch


def make(cfg: dict, n: int, e: int, gen: torch.Generator,
         device) -> torch.Tensor:
    src = torch.randint(0, n, (e,), generator=gen, device=device)
    dst = torch.randint(0, n, (e,), generator=gen, device=device)
    return torch.stack([src, dst], dim=1)
