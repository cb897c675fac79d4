"""The Graph500 Kronecker generator: initiator ``a, b, c`` (``d = 1 - a
- b - c``), one quadrant drawn a bit level an edge, the vertex ids then
permuted (``permute``) as GAP and Graph500 do."""

from __future__ import annotations

import torch

# edges drawn a call while the Kronecker bits are set: bounds the
# temporaries at a few hundred MB whatever the scale
CHUNK = 1 << 23


def make(cfg: dict, n: int, e: int, gen: torch.Generator,
         device) -> torch.Tensor:
    a, b, c = float(cfg["a"]), float(cfg["b"]), float(cfg["c"])
    ab = a + b
    a_norm = a / ab
    c_norm = c / (1.0 - ab)
    edges = torch.empty((e, 2), dtype=torch.int64, device=device)
    for lo in range(0, e, CHUNK):
        m = min(CHUNK, e - lo)
        src = torch.zeros(m, dtype=torch.int64, device=device)
        dst = torch.zeros(m, dtype=torch.int64, device=device)
        for _ in range(int(cfg["scale"])):
            r = torch.rand((2, m), generator=gen, device=device)
            src_bit = r[0] > ab
            dst_bit = torch.where(src_bit, r[1] > c_norm, r[1] > a_norm)
            src = src * 2 + src_bit
            dst = dst * 2 + dst_bit
        edges[lo:lo + m, 0] = src
        edges[lo:lo + m, 1] = dst
    if cfg.get("permute", False):
        perm = torch.randperm(n, generator=gen, device=device)
        edges = perm[edges]
    return edges
