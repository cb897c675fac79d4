"""PartitionedVector: the ``hpx::partitioned_vector`` analogue.

A global per-vertex array lives as ``(P, n_local)``: every per-part
tensor carries a leading parts dim, and all P parts sit stacked on one
device.  HPX exposes remote element access through AGAS; the analogue
here is bulk exchange, so :class:`StackedComm` provides the exchange
primitives the graph algorithms are built from, each a reshape,
transpose and reduce over the parts dim:

  * exchange_sum -- each part holds a full-length (n,) accumulator of
      proposed updates; the reduce-scatter delivers the combined slice
      to each owner: ``(P_src, P_dst, n_local).sum(0)``.
  * exchange_or -- boolean OR-combine over a PACKED bitmap: n/32 words
      per part on the wire.
  * exchange_min_int -- owner-combining with MIN (parent selection in
      BFS): the all_to_all + min becomes ``.amin(0)``.
  * broadcast_global -- all-gather a (P, n_local) field into a full (n,)
      replica on every part (pull-mode reads).
  * psum_scalar -- the global all-reduce of one scalar per part.  It is
      the round's barrier and its one device-to-host sync: it returns a
      host number, which halt tests and branch decisions read.

Bitmaps are int32 words (bit ``i & 31`` of word ``i >> 5``), read as
the same 32 bits as the JAX package's uint32 words: PyTorch's CPU
kernels do not shift uint32.

Every exchange routes its OUTGOING payload through ``_tap``, which adds
one part's payload bytes to ``StackedComm.wire`` under ``(phase, op)``
— the same ops (``sum`` / ``or`` / ``min`` / ``bcast``) and the same
per-part figure the JAX package's telemetry wire tap records.
``psum_scalar`` is not tapped: the halt scalar is control plane.
"""

from __future__ import annotations

import torch


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., m) bool -> (..., m/32) int32 words (m a multiple of 32).

    Accumulates in int64 (bit 31 would overflow an int32 sum), then
    wraps to the int32 word with the same 32 bits."""
    m = bits.shape[-1]
    w = bits.reshape(bits.shape[:-1] + (m // 32, 32)).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (w << shifts).sum(dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words) \
        .to(torch.int32)


def unpack_bits(packed: torch.Tensor, m: int) -> torch.Tensor:
    """(..., m/32) int32 words -> (..., m) bool."""
    idx = torch.arange(m, dtype=torch.int32, device=packed.device)
    return ((packed[..., idx >> 5] >> (idx & 31)) & 1).to(torch.bool)


def test_bit(packed: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Bit ``idx`` (int32, any shape) of a packed (W,) bitmap, as 0/1."""
    return (packed[idx >> 5] >> (idx & 31)) & 1


class StackedComm:
    """The collectives of P parts stacked on one device.

    ``wire[(phase, op)]`` accumulates the bytes one part ships; the
    superstep loop sets ``phase`` to ``"init"``, ``"round"`` or
    ``"outputs"``.
    """

    def __init__(self, parts: int, device):
        self.parts = int(parts)
        self.device = torch.device(device)
        self.phase = "round"
        self.wire: dict[tuple[str, str], int] = {}

    def __repr__(self):
        return f"StackedComm(parts={self.parts}, device={self.device})"

    def reset_wire(self) -> None:
        self.wire.clear()

    def wire_by_op(self, phase: str = "round") -> dict[str, int]:
        """Accumulated bytes per part of one phase, keyed by op."""
        return {op: b for (ph, op), b in self.wire.items() if ph == phase}

    def _tap(self, op: str, payload: torch.Tensor) -> None:
        per_part = payload.numel() // self.parts * payload.element_size()
        key = (self.phase, op)
        self.wire[key] = self.wire.get(key, 0) + per_part

    def lo(self, n_local: int) -> torch.Tensor:
        """(P, 1) int32 first global id each part owns."""
        return (torch.arange(self.parts, dtype=torch.int32,
                             device=self.device) * n_local)[:, None]

    def _blocks(self, x: torch.Tensor) -> torch.Tensor:
        """(P, n) -> (P_src, P_dst, n_local)."""
        return x.reshape(self.parts, self.parts, -1)

    def exchange_sum(self, acc_global: torch.Tensor) -> torch.Tensor:
        """(P, n) proposed updates -> (P, n_local) owner sums.

        Parts add in source order, one after the other, as the JAX
        package's psum_scatter does across CPU devices; a bf16 payload
        accumulates in float32 and rounds once to bf16, as it does
        there."""
        self._tap("sum", acc_global)
        blocks = self._blocks(acc_global)
        acc = blocks[0].float()
        for p in range(1, self.parts):
            acc = acc + blocks[p].float()
        return acc.to(acc_global.dtype)

    def exchange_or(self, mask_global: torch.Tensor) -> torch.Tensor:
        """(P, n) bool -> (P, n_local) bool OR over all parts, shipped
        bit-packed (n/32 words per part)."""
        n_local = mask_global.shape[-1] // self.parts
        packed = pack_bits(mask_global)
        self._tap("or", packed)
        rows = self._blocks(packed)               # (P_src, P_dst, nl/32)
        acc = rows[0].clone()
        for p in range(1, self.parts):
            acc |= rows[p]
        return unpack_bits(acc, n_local)

    def exchange_min_int(self, val_global: torch.Tensor) -> torch.Tensor:
        """(P, n) proposals -> (P, n_local) element-wise MIN."""
        self._tap("min", val_global)
        return self._blocks(val_global).amin(dim=0)

    def broadcast_global(self, local_vals: torch.Tensor) -> torch.Tensor:
        """(P, n_local) -> (P, n): each part holds the full replica."""
        self._tap("bcast", local_vals)
        return local_vals.reshape(1, -1).expand(self.parts, -1)

    def own_slice(self, x_global: torch.Tensor) -> torch.Tensor:
        """(P, n) replicated or per-part -> (P, n_local): each part's own
        block (the ``dynamic_slice`` at ``axis_index * n_local``)."""
        ar = torch.arange(self.parts, device=x_global.device)
        return self._blocks(x_global)[ar, ar]

    def psum_scalar(self, x: torch.Tensor):
        """(P,) per-part scalars -> their sum as a host number."""
        return x.sum().item()
