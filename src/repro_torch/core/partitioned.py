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
  * shift -- the ring permutation: part i sends its payload to part
      (i + 1) mod P (the ``ppermute`` ring of triangle counting).
  * psum_scalar -- the global all-reduce of one scalar per part.  It is
      the round's barrier and its one device-to-host sync: it returns a
      host number, which halt tests and branch decisions read.
  * exchange_{min,sum,or}_start / *_finish -- the double-buffered forms
      of the async driver: ``start`` ships the payload with one
      piggybacked scalar column and returns the in-flight handle (a
      plain tensor), ``finish`` is a pure local reduction of it.

Bitmaps are int32 words (bit ``i & 31`` of word ``i >> 5``), read as
the same 32 bits as the JAX package's uint32 words: PyTorch's CPU
kernels do not shift uint32.

Every exchange routes its OUTGOING payload through ``_tap``, which adds
one part's payload bytes to ``StackedComm.wire`` and one to
``StackedComm.taps`` under ``(phase, op)`` — the same ops (``sum`` /
``or`` / ``min`` / ``bcast`` / ``perm``) and the same per-part figure the
JAX package's telemetry wire tap records; ``obs/telemetry.py`` measures
a run as the difference of ``tally()`` across it — and then
hands it to ``faults.tap`` (a no-op unless a fault schedule is armed),
and ships what that returns.  A ``start`` taps under its blocking
form's op, its scalar column included.  ``psum_scalar`` is not tapped:
the halt scalar is control plane.
"""

from __future__ import annotations

import torch

from repro_torch.core import faults


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

    ``wire[(phase, op)]`` accumulates the bytes one part ships and
    ``taps[(phase, op)]`` the exchanges that shipped them; the superstep
    loop sets ``phase`` to ``"init"``, ``"round"`` or ``"outputs"``.
    """

    def __init__(self, parts: int, device):
        self.parts = int(parts)
        self.device = torch.device(device)
        self.phase = "round"
        self.wire: dict[tuple[str, str], int] = {}
        self.taps: dict[tuple[str, str], int] = {}

    def __repr__(self):
        return f"StackedComm(parts={self.parts}, device={self.device})"

    def reset_wire(self) -> None:
        self.wire.clear()
        self.taps.clear()

    def tally(self) -> dict[tuple[str, str], tuple[int, int]]:
        """The cumulative ``(bytes, taps)`` of every ``(phase, op)``."""
        return {k: (b, self.taps[k]) for k, b in self.wire.items()}

    def wire_by_op(self, phase: str = "round") -> dict[str, int]:
        """Accumulated bytes per part of one phase, keyed by op."""
        return {op: b for (ph, op), b in self.wire.items() if ph == phase}

    def _tap(self, op: str, payload: torch.Tensor,
             words: bool = False) -> torch.Tensor:
        """Count one part's bytes of ``payload``, then return it as the
        fault tap leaves it (``words``: a payload of bitmap words)."""
        per_part = payload.numel() // self.parts * payload.element_size()
        key = (self.phase, op)
        self.wire[key] = self.wire.get(key, 0) + per_part
        self.taps[key] = self.taps.get(key, 0) + 1
        return faults.tap(op, payload, self.parts, words)

    def lo(self, n_local: int) -> torch.Tensor:
        """(P, 1) int32 first global id each part owns."""
        return (torch.arange(self.parts, dtype=torch.int32,
                             device=self.device) * n_local)[:, None]

    def gid(self, n_local: int) -> torch.Tensor:
        """(P, n_local) int32 global id of every vertex slot."""
        return torch.arange(n_local, dtype=torch.int32,
                            device=self.device) + self.lo(n_local)

    def _blocks(self, x: torch.Tensor) -> torch.Tensor:
        """(P, n) -> (P_src, P_dst, n_local)."""
        return x.reshape(self.parts, self.parts, -1)

    def _source_sum(self, rows: torch.Tensor) -> torch.Tensor:
        """(P_src, P_dst, ...) -> (P_dst, ...) added in source order, in
        the rows' dtype (a bf16 payload in float32, rounded once)."""
        wide = rows.dtype == torch.bfloat16
        acc = rows[0].float() if wide else rows[0].clone()
        for p in range(1, self.parts):
            acc += rows[p]
        return acc.to(rows.dtype)

    def _source_or(self, rows: torch.Tensor) -> torch.Tensor:
        """(P_src, P_dst, words) -> (P_dst, words) OR over the sources."""
        acc = rows[0].clone()
        for p in range(1, self.parts):
            acc |= rows[p]
        return acc

    def exchange_sum(self, acc_global: torch.Tensor) -> torch.Tensor:
        """(P, n) proposed updates -> (P, n_local) owner sums.

        Parts add in source order, one after the other, as the JAX
        package's psum_scatter does across CPU devices.  Integer and
        float32 payloads add in their own dtype (integers exact, wrapping
        on overflow); a bf16 payload accumulates in float32 and rounds
        once to bf16, as it does there."""
        acc_global = self._tap("sum", acc_global)
        return self._source_sum(self._blocks(acc_global))

    def exchange_or(self, mask_global: torch.Tensor) -> torch.Tensor:
        """(P, n) bool -> (P, n_local) bool OR over all parts, shipped
        bit-packed (n/32 words per part)."""
        n_local = mask_global.shape[-1] // self.parts
        packed = self._tap("or", pack_bits(mask_global), words=True)
        return unpack_bits(self._source_or(self._blocks(packed)), n_local)

    def exchange_min_int(self, val_global: torch.Tensor) -> torch.Tensor:
        """(P, n) proposals -> (P, n_local) element-wise MIN."""
        val_global = self._tap("min", val_global)
        return self._blocks(val_global).amin(dim=0)

    def broadcast_global(self, local_vals: torch.Tensor,
                         words: bool = False) -> torch.Tensor:
        """(P, n_local) -> (P, n): each part holds the full replica
        (``words``: the field is bitmap words)."""
        local_vals = self._tap("bcast", local_vals, words)
        return local_vals.reshape(1, -1).expand(self.parts, -1)

    def shift(self, x: torch.Tensor, words: bool = False) -> torch.Tensor:
        """(P, ...) per-part payloads -> the same with part i's payload
        at part (i + 1) mod P: one step of the ring (``words``: the
        payloads are bitmap words)."""
        x = self._tap("perm", x, words)
        return torch.roll(x, 1, dims=0)

    def own_slice(self, x_global: torch.Tensor) -> torch.Tensor:
        """(P, n) replicated or per-part -> (P, n_local): each part's own
        block (the ``dynamic_slice`` at ``axis_index * n_local``)."""
        ar = torch.arange(self.parts, device=x_global.device)
        return self._blocks(x_global)[ar, ar]

    def psum_scalar(self, x: torch.Tensor):
        """(P,) per-part scalars -> their sum as a host number."""
        return x.sum().item()

    # -- double-buffered exchange: start / finish pairs ---------------------
    #
    # A start ships only the payload and returns the handle; its finish is
    # a pure local reduction, run a round later by the async driver.  Each
    # part stamps one scalar (a halt count or residual) on all P outgoing
    # rows as a trailing column in the payload's dtype, so the receiver
    # holds all P stamps and their sum in source order is the global sum,
    # as ``psum_scalar`` gives it (integer-valued scalars are exact in a
    # float32 column up to 2**24).

    def _stamped(self, blocks: torch.Tensor, scalar) -> torch.Tensor:
        """(P_src, P_dst, w) blocks + each source's scalar as column w."""
        parts = self.parts
        if isinstance(scalar, torch.Tensor):
            col = scalar.reshape(parts, 1, 1).to(blocks.dtype) \
                .expand(parts, parts, 1)
        else:
            col = torch.full((parts, parts, 1), scalar, dtype=blocks.dtype,
                             device=blocks.device)
        return torch.cat([blocks, col], dim=2)

    def exchange_min_start(self, val_global: torch.Tensor, scalar):
        """Ship the MIN-combine proposals ``(P, n)`` with ``scalar`` (a
        number, or one per part as ``(P,)``) piggybacked in the proposal
        dtype.  The handle is the ``(P_src, P_dst, n_local + 1)``
        received rows."""
        return self._tap("min", self._stamped(self._blocks(val_global),
                                              scalar))

    def exchange_min_finish(self, handle: torch.Tensor):
        """``((P, n_local) combined minima, (P,) global scalar sum)``:
        every part's sum is the same."""
        return handle[:, :, :-1].amin(dim=0), self._source_sum(
            handle[:, :, -1])

    def exchange_sum_start(self, acc_global: torch.Tensor, scalar):
        """Ship the SUM-combine proposals ``(P, n)`` with a piggybacked
        scalar column.  The reduce-scatter combines on the wire, so the
        handle is already the ``(P, n_local + 1)`` owner sums, added in
        source order in the payload's dtype."""
        return self._source_sum(self._tap(
            "sum", self._stamped(self._blocks(acc_global), scalar)))

    def exchange_sum_finish(self, handle: torch.Tensor):
        """``((P, n_local) combined sums, (P,) global scalar sum)``."""
        return handle[:, :-1], handle[:, -1]

    def exchange_or_start(self, mask_global: torch.Tensor, scalar):
        """Ship the bit-packed OR of a ``(P, n)`` bool mask with a
        piggybacked count word (an int32 word, the JAX package's uint32
        bits).  The handle is the ``(P_src, P_dst, n_words + 1)`` received
        rows; finish it with the static ``n_local``."""
        return self._tap("or", self._stamped(
            self._blocks(pack_bits(mask_global)), scalar), words=True)

    def exchange_or_finish(self, handle: torch.Tensor, n_local: int):
        """``((P, n_local) bool OR-combined mask, (P,) int32 global scalar
        sum)``."""
        return unpack_bits(self._source_or(handle[:, :, :-1]), n_local), \
            self._source_sum(handle[:, :, -1])
