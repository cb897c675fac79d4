"""Mamba2 (SSD, state-space duality) block: chunked scan and O(1)-state
decode step.

Follows Dao & Gu (arXiv:2405.21060).  The SSD chunked algorithm splits
the sequence into chunks of length Q: intra-chunk terms are a masked
quadratic attention-like product, inter-chunk terms flow through a loop
over per-chunk states (B, H, P, N) (the reference's ``lax.scan``).  All
of it is plain torch: the reference has no ``pallas_call`` here.

Shapes:  d_inner = expand * d_model;  H = d_inner / head_dim (P);
         N = ssm_state;  G = ssm_groups (B/C shared across heads/group).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import actctx
from repro_torch.models.layers import contract, silu
from repro_torch.models.params import spec


def mamba2_spec(cfg):
    d = cfg.d_model
    di = cfg.d_inner
    n = cfg.ssm_state
    g = cfg.ssm_groups
    nh = cfg.ssm_nheads
    conv_dim = di + 2 * g * n
    return {
        "in_proj": spec((d, 2 * di + 2 * g * n + nh), ("embed", "ssm_inner")),
        "conv_w": spec((cfg.ssm_conv, conv_dim), ("conv", "ssm_inner"),
                       scale=0.1),
        "conv_b": spec((conv_dim,), ("ssm_inner",), init="zeros"),
        "A_log": spec((nh,), ("ssm_heads",), init="arange_neg"),
        "D": spec((nh,), ("ssm_heads",), init="ones"),
        "dt_bias": spec((nh,), ("ssm_heads",), init="zeros"),
        "norm_scale": spec((di,), ("ssm_inner",), init="ones"),
        "out_proj": spec((di, d), ("ssm_inner", "embed"),
                         scale=0.02 / max(1, cfg.num_layers) ** 0.5),
    }


def _segsum(x):
    """Stable 'segment sum': out[..., i, j] = sum_{j<k<=i} x[..., k].

    Returns (..., Q, Q) with -inf above the diagonal (j > i).
    """
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, -torch.inf)


def _causal_conv(x, w, b):
    """Depthwise causal conv. x: (B,S,Cd), w: (W,Cd)."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):  # W is tiny (4): unrolled taps
        out = out + xp[:, i:i + x.shape[1], :] * w[i]
    return out + b


def ssd_chunked(x, dt, A, Bc, Cc, D, *, chunk: int, h0=None):
    """SSD forward.

    x:  (B, S, H, P) values
    dt: (B, S, H)    positive step sizes
    A:  (H,)         negative decay rates
    Bc: (B, S, G, N) input projections
    Cc: (B, S, G, N) output projections
    D:  (H,)         skip
    h0: optional initial state (B, H, P, N)
    Returns y (B, S, H, P) in x's dtype, h_final (B, H, P, N) in f32.
    """
    Bsz, S, H, P = x.shape
    G, N = Bc.shape[2], Bc.shape[3]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"sequence {S} is not a multiple of the SSD chunk "
                         f"{Q}")
    nC = S // Q
    rep = H // G

    f32 = torch.float32
    xb = (x * dt[..., None]).to(f32)                        # fold dt into x
    dA = dt.to(f32) * A.to(f32)                             # (B,S,H) negative

    # chunked views
    xc = xb.reshape(Bsz, nC, Q, H, P)
    dAc = dA.reshape(Bsz, nC, Q, H).permute(0, 1, 3, 2)      # (B,C,H,Q)
    Bcc = Bc.reshape(Bsz, nC, Q, G, N).to(f32)
    Ccc = Cc.reshape(Bsz, nC, Q, G, N).to(f32)

    dA_cum = torch.cumsum(dAc, dim=-1)                      # (B,C,H,Q)
    dA_tot = dA_cum[..., -1]                                # (B,C,H)

    # group -> head broadcast for B/C projections
    Bh = torch.repeat_interleave(Bcc, rep, dim=3)           # (B,C,Q,H,N)
    Ch = torch.repeat_interleave(Ccc, rep, dim=3)           # (B,C,Q,H,N)

    # ---- intra-chunk (diagonal blocks): quadratic masked product ----
    L = torch.exp(_segsum(dAc))                             # (B,C,H,Q,Q)
    CB = torch.einsum("bclhn,bcshn->bchls", Ch, Bh)         # (B,C,H,Q,Q)
    M = CB * L                                              # masked decay
    y_diag = torch.einsum("bchls,bcshp->bclhp", M, xc)
    del L, CB, M

    # ---- chunk states: B^T x with decay-to-end ----
    decay_end = torch.exp(dA_tot[..., None] - dA_cum)       # (B,C,H,Q)
    Bx = torch.einsum("bcshn,bcshp->bchpn",
                      Bh * decay_end.permute(0, 1, 3, 2)[..., None],
                      xc)                                   # (B,C,H,P,N)

    # ---- inter-chunk recurrence over chunk states ----
    h = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    h_prevs = []
    for c in range(nC):                     # state BEFORE each chunk
        h_prevs.append(h)
        h = h * torch.exp(dA_tot[:, c])[..., None, None] + Bx[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                   # (B,C,H,P,N)

    # ---- inter-chunk output: C h_prev with decay-from-start ----
    decay_in = torch.exp(dA_cum)                            # (B,C,H,Q)
    y_off = torch.einsum("bclhn,bchpn->bclhp", Ch, h_prevs) \
        * decay_in.permute(0, 1, 3, 2)[..., None]

    y = (y_diag + y_off).reshape(Bsz, S, H, P)
    y = y + (D.to(f32)[None, None, :, None] * x.to(f32))
    return y.to(x.dtype), h


def _ssm(p, zxbcdt, cfg, h0=None, conv0=None):
    """The block between its projections, on plain tensors: the causal
    conv over the in-projection's ``x B C`` channels, the SSD scan and
    the gated norm.  Returns y (B, S, d_inner) and the new state
    (h_last f32 (B, H, P, N), conv (B, ssm_conv - 1, conv_dim))."""
    B, S, _ = zxbcdt.shape
    di, n, g = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
    nh, hd = cfg.ssm_nheads, cfg.ssm_head_dim
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * g * n, nh], dim=-1)

    w, b = p["conv_w"].to(zxbcdt.dtype), p["conv_b"].to(zxbcdt.dtype)
    if conv0 is not None:
        # decode path stitches conv state; prefill uses zero left-context
        xbc_ext = torch.cat([conv0.to(xbc.dtype), xbc], dim=1)
        xbc_conv = _causal_conv(xbc_ext, w, b)[:, conv0.shape[1]:, :]
        new_conv = xbc_ext[:, -(cfg.ssm_conv - 1):, :]
    else:
        xbc_conv = _causal_conv(xbc, w, b)
        new_conv = xbc[:, -(cfg.ssm_conv - 1):, :]
    xbc_conv = silu(xbc_conv)

    xs, Bc, Cc = torch.split(xbc_conv, [di, g * n, g * n], dim=-1)
    xs = xs.reshape(B, S, nh, hd)
    Bc = Bc.reshape(B, S, g, n)
    Cc = Cc.reshape(B, S, g, n)
    # jax.nn.softplus is logaddexp(x, 0), in f32
    dtf = dt.float() + p["dt_bias"].float()
    dt = torch.logaddexp(dtf, torch.zeros_like(dtf))
    A = -torch.exp(p["A_log"].float())

    y, h_last = ssd_chunked(xs, dt, A, Bc, Cc, p["D"],
                            chunk=cfg.ssm_chunk, h0=h0)
    y = y.reshape(B, S, di)

    # gated RMSNorm (mamba2 uses norm(y * silu(z)))
    y = y * silu(z)
    yf = y.float()
    var = torch.mean(torch.square(yf), dim=-1, keepdim=True)
    y = (yf * torch.rsqrt(var + 1e-6) * p["norm_scale"].float()).to(
        zxbcdt.dtype)
    return y, (h_last, new_conv)


# the block's weights that :func:`_ssm` reads
SSM_LEAVES = ("conv_w", "conv_b", "dt_bias", "A_log", "D", "norm_scale")


def _ssm_sharded(p, zxbcdt, cfg, h0, conv0):
    """:func:`_ssm` on DTensors: each rank runs its own batch rows with
    every channel and head, since the in-projection's pieces (z, x, B,
    C, dt) do not fall on its shards and the conv and the scan need
    whole sequences; ranks that held the same rows share them out
    (``actctx.spread``), so no row is computed twice.  Its weights, its
    state and its output are laid out accordingly (the state's heads and
    channels gathered going in, each rank keeping its shard of the new
    state coming out).  y comes back with every channel on each of the
    ranks that shared the rows out."""
    rows = actctx.token_layout(zxbcdt)
    mesh = zxbcdt.device_mesh
    layout = actctx.spread(rows, mesh, zxbcdt.shape[0]
                           // actctx.splits(rows, mesh, 0))
    w = {k: actctx.whole(p[k], layout) for k in SSM_LEAVES}
    loc = [None if t is None else actctx.local_tokens(t, layout)
           for t in (h0, conv0)]
    y, (h, conv) = _ssm(w, actctx.local_tokens(zxbcdt, layout), cfg, *loc)
    y = actctx.relayout(actctx.from_tokens(y, zxbcdt, layout), rows)
    return (y,) + tuple(actctx.from_tokens(t, zxbcdt, layout)
                        for t in (h, conv))


def mamba2_block(p, x, cfg, *, h0=None, conv0=None, return_state=False):
    """Full Mamba2 block (no outer norm/residual).

    x: (B, S, d_model) -> (B, S, d_model); with ``return_state`` also
    (h_last f32 (B, H, P, N), conv state (B, ssm_conv - 1, conv_dim)).
    On DTensors the sequence is whole on each rank, the in-projection's
    output laid out as the reference's "ffn" site lays it (its channels
    over "model"), then :func:`_ssm_sharded`; the out-projection
    contracts the channels split over "model" again, as the MLP's does.
    """
    x = actctx.constrain(x, "batch")
    zxbcdt = actctx.constrain(
        contract("bsd,df->bsf", x, p["in_proj"].to(x.dtype)), "ffn")
    if actctx.is_dtensor(zxbcdt):
        y, h_last, new_conv = _ssm_sharded(p, zxbcdt, cfg, h0, conv0)
        y = actctx.constrain(y, "ffn")
    else:
        y, (h_last, new_conv) = _ssm(p, zxbcdt, cfg, h0, conv0)
    out = contract("bsf,fd->bsd", y, p["out_proj"].to(x.dtype))
    if return_state:
        return out, (h_last, new_conv)
    return out


def mamba2_decode(p, x, cfg, state):
    """O(1) single-token decode. x: (B, 1, d); state = (h, conv_buf).

    h: (B, H, P, N); conv_buf: (B, ssm_conv-1, conv_dim).
    """
    h, conv_buf = state
    out, (h_new, conv_new) = mamba2_block(
        p, x, cfg, h0=h, conv0=conv_buf, return_state=True)
    return out, (h_new, conv_new)


def init_ssm_state(cfg, batch, dtype=torch.float32, device=None):
    """Zero decode state of one layer: h (B, H, P, N) in f32 and the conv
    buffer (B, ssm_conv - 1, conv_dim) in ``dtype``, on the card unless
    ``device`` says otherwise."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_ssm_state puts the state on CUDA and no CUDA device "
                "is available; pass device='cpu' to keep it on the CPU")
        device = "cuda"
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    h = torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state),
                    dtype=torch.float32, device=device)
    conv = torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                       device=device)
    return h, conv
