"""Plain-PyTorch version of the flash attention kernel."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, return_lse: bool = False):
    """q (BH, Sq, D), k/v (BH, Sk, D) -> (BH, Sq, D) in v's dtype; with
    ``return_lse`` also each row's f32 log-sum-exp of its masked scores,
    (BH, Sq): ``m + log(l)`` of the reference's online softmax."""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) \
        * (q.shape[-1] ** -0.5)
    if softcap and softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= kp > qp - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqk,bkd->bqd", p.to(v.dtype), v)
    if not return_lse:
        return o
    m = s.amax(dim=-1)
    l = torch.exp(s - m[..., None]).sum(dim=-1)
    return o, m + torch.log(torch.clamp(l, min=1e-30))
