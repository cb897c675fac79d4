"""PartitionedVector: the ``hpx::partitioned_vector`` analogue.

A global per-vertex array lives as ``(L, n_local)``: every per-part
tensor carries a leading dim over the L parts this process holds.  Two
exchange contexts give the programs the same primitives:

  * :class:`StackedComm` -- all P parts stacked on one device (L = P);
      every exchange is a reshape, transpose and reduce over the parts
      dim.
  * :class:`DistComm` -- one part a rank of a ``torch.distributed``
      group of P ranks (L = 1, the part of the rank's own index); the
      exchanges are collectives, and each received ``(P_src, ...)``
      block is combined locally in source order, with the same code as
      ``StackedComm``'s, so the two give the same bits.

A comm names both counts: ``parts`` is P, the global count the payloads
are cut by, and ``local_parts`` the L rows held here; ``first_part`` is
the global index of local row 0.  Each collective below, in both comms,
is a layer site ``comm.<method>`` (``obs/spans.py``).  The primitives:

  * exchange_sum -- each part holds a full-length (n,) accumulator of
      proposed updates; the reduce-scatter delivers the combined slice
      to each owner: ``(P_src, P_dst, n_local).sum(0)``.
  * exchange_or -- boolean OR-combine over a PACKED bitmap: n/32 words
      per part on the wire.
  * exchange_min_int -- owner-combining with MIN (parent selection in
      BFS): the all_to_all + min becomes ``.amin(0)``.
  * broadcast_global -- all-gather a (L, n_local) field into a full (n,)
      replica on every part (pull-mode reads).
  * shift -- the ring permutation: part i sends its payload to part
      (i + 1) mod P (the ``ppermute`` ring of triangle counting).
  * psum_scalar -- the global all-reduce of one scalar per part.  It is
      the round's barrier and its one device-to-host sync: it returns a
      host number, which halt tests and branch decisions read.
  * exchange_{min,sum,or}_start / *_finish -- the double-buffered forms
      of the async driver: ``start`` ships the payload with one
      piggybacked scalar column and returns the in-flight handle,
      ``finish`` reduces it locally.

A :class:`GraphMesh` names the deployment and builds its comm: the
one-process mesh (``StackedComm``) unless the caller launched ranks and
says so (``launch/mesh.py::make_graph_mesh``).

Control-plane reductions are not exchanges and are never tapped:
``sum_parts`` (a global sum left on the device, for the guards),
``all_parts`` (the guarded round's verdict, AND over every part) and
``max_scalar``.  ``gather_parts`` collects a vertex field for the
caller, outside any program.  ``agree``, ``gather_objects`` and
``broadcast_object`` move host verdicts and objects between the
processes of a group (the checkpoint runner's resume check, the rank
server's messages, the mutation planner's capacity outcome); under
``DistComm`` they run over a gloo control group (:func:`control_group`).

Bitmaps are int32 words (bit ``i & 31`` of word ``i >> 5``), read as
the same 32 bits as the JAX package's uint32 words: PyTorch's CPU
kernels do not shift uint32.

Every exchange routes its OUTGOING payload through ``_tap``, which adds
one part's payload bytes to ``wire`` and one to ``taps`` under ``(phase,
op)`` -- the same ops (``sum`` / ``or`` / ``min`` / ``bcast`` /
``perm``) and the same per-part figure the JAX package's telemetry wire
tap records; ``obs/telemetry.py`` measures a run as the difference of
``tally()`` across it -- and then hands it to ``faults.tap`` (a no-op
unless a fault schedule is armed) with the global index of its first
row, and ships what that returns.  A ``start`` taps under its blocking
form's op, its scalar column included.  ``psum_scalar`` is not tapped:
the halt scalar is control plane.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import faults
from repro_torch.obs.spans import spanned


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


def part_sums(x: torch.Tensor) -> torch.Tensor:
    """(L, m) float -> (L,) each part's sum, one reduction a part.

    A part's float sum then has the same bits whether this process holds
    one part or all P: a reduction over several rows at once may split
    each row in another order (CUDA's reduction kernels pick their split
    by the number of rows)."""
    return torch.stack([row.sum() for row in x])


class StackedComm:
    """The collectives of P parts stacked on one device.

    ``wire[(phase, op)]`` accumulates the bytes one part ships and
    ``taps[(phase, op)]`` the exchanges that shipped them; the superstep
    loop sets ``phase`` to ``"init"``, ``"round"`` or ``"outputs"``.
    """

    def __init__(self, parts: int, device):
        self.parts = int(parts)
        self.local_parts = self.parts       # rows held here: every part
        self.first_part = 0                 # global index of local row 0
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
        per_part = payload.numel() // self.local_parts \
            * payload.element_size()
        key = (self.phase, op)
        self.wire[key] = self.wire.get(key, 0) + per_part
        self.taps[key] = self.taps.get(key, 0) + 1
        return self._fault_tap(op, payload, words)

    def _fault_tap(self, op: str, payload: torch.Tensor, words: bool):
        """``faults.tap`` of a payload whose rows are every part."""
        return faults.tap(op, payload, self.parts, words)

    def part_ids(self) -> torch.Tensor:
        """(L,) global index of each part held here."""
        return torch.arange(self.first_part,
                            self.first_part + self.local_parts,
                            device=self.device)

    def own_index(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The ``(row, block)`` index of each held part's own block in
        ``_blocks`` of a (L, n) field: what :meth:`own_slice` reads."""
        return torch.arange(self.local_parts, device=self.device), \
            self.part_ids()

    def lo(self, n_local: int) -> torch.Tensor:
        """(L, 1) int32 first global id each held part owns."""
        return (self.part_ids().to(torch.int32) * n_local)[:, None]

    def gid(self, n_local: int) -> torch.Tensor:
        """(L, n_local) int32 global id of every vertex slot."""
        return torch.arange(n_local, dtype=torch.int32,
                            device=self.device) + self.lo(n_local)

    def _blocks(self, x: torch.Tensor) -> torch.Tensor:
        """(L, n) -> (L_src, P_dst, n_local)."""
        return x.reshape(self.local_parts, self.parts, -1)

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

    @spanned("exchange_sum", "comm")
    def exchange_sum(self, acc_global: torch.Tensor) -> torch.Tensor:
        """(P, n) proposed updates -> (P, n_local) owner sums.

        Parts add in source order, one after the other, as the JAX
        package's psum_scatter does across CPU devices.  Integer and
        float32 payloads add in their own dtype (integers exact, wrapping
        on overflow); a bf16 payload accumulates in float32 and rounds
        once to bf16, as it does there."""
        acc_global = self._tap("sum", acc_global)
        return self._source_sum(self._blocks(acc_global))

    @spanned("exchange_or", "comm")
    def exchange_or(self, mask_global: torch.Tensor) -> torch.Tensor:
        """(P, n) bool -> (P, n_local) bool OR over all parts, shipped
        bit-packed (n/32 words per part)."""
        n_local = mask_global.shape[-1] // self.parts
        packed = self._tap("or", pack_bits(mask_global), words=True)
        return unpack_bits(self._source_or(self._blocks(packed)), n_local)

    @spanned("exchange_min_int", "comm")
    def exchange_min_int(self, val_global: torch.Tensor) -> torch.Tensor:
        """(P, n) proposals -> (P, n_local) element-wise MIN."""
        val_global = self._tap("min", val_global)
        return self._blocks(val_global).amin(dim=0)

    @spanned("broadcast_global", "comm")
    def broadcast_global(self, local_vals: torch.Tensor,
                         words: bool = False) -> torch.Tensor:
        """(P, n_local) -> (P, n): each part holds the full replica
        (``words``: the field is bitmap words)."""
        local_vals = self._tap("bcast", local_vals, words)
        return local_vals.reshape(1, -1).expand(self.parts, -1)

    @spanned("shift", "comm")
    def shift(self, x: torch.Tensor, words: bool = False) -> torch.Tensor:
        """(P, ...) per-part payloads -> the same with part i's payload
        at part (i + 1) mod P: one step of the ring (``words``: the
        payloads are bitmap words)."""
        x = self._tap("perm", x, words)
        return torch.roll(x, 1, dims=0)

    def own_slice(self, x_global: torch.Tensor) -> torch.Tensor:
        """(L, n) replicated or per-part -> (L, n_local): each part's own
        block (the ``dynamic_slice`` at ``axis_index * n_local``)."""
        return self._blocks(x_global)[self.own_index()]

    def zero_own(self, x_global: torch.Tensor) -> None:
        """Zero each held part's own block of a contiguous (L, n) field,
        in place, at :meth:`own_slice`'s index."""
        self._blocks(x_global)[self.own_index()] = 0

    @spanned("psum_scalar", "comm")
    def psum_scalar(self, x: torch.Tensor):
        """(P,) per-part scalars -> their sum as a host number."""
        return x.sum().item()

    @spanned("sum_parts", "comm")
    def sum_parts(self, x: torch.Tensor) -> torch.Tensor:
        """(P,) per-part values -> their sum, a device scalar (no sync)."""
        return x.sum()

    @spanned("all_parts", "comm")
    def all_parts(self, verdict: torch.Tensor) -> bool:
        """A bool tensor of per-part or global verdicts -> True when every
        part's holds: the guarded round's one sync."""
        return bool(verdict.all().item())

    @spanned("max_scalar", "comm")
    def max_scalar(self, x: torch.Tensor) -> int:
        """(P,) per-part integer maxima -> the global maximum."""
        return int(x.max())

    @spanned("gather_parts", "comm")
    def gather_parts(self, x: torch.Tensor) -> torch.Tensor:
        """(L, ...) held parts -> (P, ...) every part, for the caller that
        collects a result (not an exchange: untapped)."""
        return x

    # -- control plane: host objects and decisions, never tapped -----------
    #
    # One process holds every part here, so each is the identity; under
    # ``DistComm`` they are collectives over the control group, which
    # every rank must call in the same order.

    @property
    def leader(self) -> bool:
        """True on the process that decides for the group (rank 0)."""
        return self.first_part == 0

    def agree(self, ok: bool) -> bool:
        """A host verdict -> True when every process's holds."""
        return bool(ok)

    def gather_objects(self, obj) -> list:
        """A host object -> every process's, in part order (one here,
        standing for all P parts)."""
        return [obj]

    def broadcast_object(self, obj):
        """The leader's host object on every process."""
        return obj

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
        """(L_src, P_dst, w) blocks + each source's scalar as column w."""
        rows, parts = self.local_parts, self.parts
        if isinstance(scalar, torch.Tensor):
            col = scalar.reshape(rows, 1, 1).to(blocks.dtype) \
                .expand(rows, parts, 1)
        else:
            col = torch.full((rows, parts, 1), scalar, dtype=blocks.dtype,
                             device=blocks.device)
        return torch.cat([blocks, col], dim=2)

    @spanned("exchange_min_start", "comm")
    def exchange_min_start(self, val_global: torch.Tensor, scalar):
        """Ship the MIN-combine proposals ``(P, n)`` with ``scalar`` (a
        number, or one per part as ``(P,)``) piggybacked in the proposal
        dtype.  The handle is the ``(P_src, P_dst, n_local + 1)``
        received rows."""
        return self._tap("min", self._stamped(self._blocks(val_global),
                                              scalar))

    @spanned("exchange_min_finish", "comm")
    def exchange_min_finish(self, handle: torch.Tensor):
        """``((P, n_local) combined minima, (P,) global scalar sum)``:
        every part's sum is the same."""
        return self._min_rows(handle)

    def _min_rows(self, rows: torch.Tensor):
        return rows[:, :, :-1].amin(dim=0), self._source_sum(rows[:, :, -1])

    @spanned("exchange_sum_start", "comm")
    def exchange_sum_start(self, acc_global: torch.Tensor, scalar):
        """Ship the SUM-combine proposals ``(P, n)`` with a piggybacked
        scalar column.  The reduce-scatter combines on the wire, so the
        handle is already the ``(P, n_local + 1)`` owner sums, added in
        source order in the payload's dtype."""
        return self._source_sum(self._tap(
            "sum", self._stamped(self._blocks(acc_global), scalar)))

    @spanned("exchange_sum_finish", "comm")
    def exchange_sum_finish(self, handle: torch.Tensor):
        """``((P, n_local) combined sums, (P,) global scalar sum)``."""
        return self._sum_rows(handle)

    @staticmethod
    def _sum_rows(sums: torch.Tensor):
        return sums[:, :-1], sums[:, -1]

    @spanned("exchange_or_start", "comm")
    def exchange_or_start(self, mask_global: torch.Tensor, scalar):
        """Ship the bit-packed OR of a ``(P, n)`` bool mask with a
        piggybacked count word (an int32 word, the JAX package's uint32
        bits).  The handle is the ``(P_src, P_dst, n_words + 1)`` received
        rows; finish it with the static ``n_local``."""
        return self._tap("or", self._stamped(
            self._blocks(pack_bits(mask_global)), scalar), words=True)

    @spanned("exchange_or_finish", "comm")
    def exchange_or_finish(self, handle: torch.Tensor, n_local: int):
        """``((P, n_local) bool OR-combined mask, (P,) int32 global scalar
        sum)``."""
        return self._or_rows(handle, n_local)

    def _or_rows(self, rows: torch.Tensor, n_local: int):
        return unpack_bits(self._source_or(rows[:, :, :-1]), n_local), \
            self._source_sum(rows[:, :, -1])


# ---------------------------------------------------------------------------
# One part a rank: the exchanges as torch.distributed collectives.
# ---------------------------------------------------------------------------


class Pending:
    """An exchange in flight: the collective's ``Work`` (None once done
    or for a blocking call), the buffer it receives into, and, when the
    transport stages through host memory, the pinned host buffers and
    the device buffer the result is copied to.  The send buffer is held
    until :meth:`wait`, so it outlives the collective that reads it."""

    __slots__ = ("work", "recv", "send", "device_recv")

    def __init__(self, work, recv, send, device_recv=None):
        self.work, self.recv, self.send = work, recv, send
        self.device_recv = device_recv

    def wait(self) -> torch.Tensor:
        """The received tensor, on the exchange's device.  Under NCCL
        ``Work.wait`` makes the caller's current stream wait for the
        collective (the host does not block); under gloo it blocks the
        host until the data is in ``recv``."""
        if self.work is not None:
            self.work.wait()
            self.work = None
        self.send = None
        if self.device_recv is not None:
            self.device_recv.copy_(self.recv)
            self.recv, self.device_recv = self.device_recv, None
        return self.recv

    @classmethod
    def finished(cls, rows: torch.Tensor, device) -> "Pending":
        """A finished handle whose :meth:`wait` returns a copy of
        ``rows`` on ``device``: nothing in flight, ``work`` None.  A
        checkpoint finishes a live handle into host rows with
        ``Pending.finished(handle.wait(), "cpu")`` (a staged handle's
        device copy runs inside that ``wait``) and a restore rebuilds
        it on the exchange's device the same way."""
        return cls(None, rows.to(device, copy=True), None)


class DistComm(StackedComm):
    """The collectives of P parts over the P ranks of the default
    ``torch.distributed`` process group, one part a rank: this rank holds part ``rank`` as ``(1, ...)``
    tensors (``local_parts`` 1, ``first_part`` the rank).

    Which collective moves which op:

      * ``exchange_sum`` / ``exchange_min_int`` / ``exchange_or`` and
        their ``*_start`` forms: one ``all_to_all_single`` each; the
        receiver combines the ``(P_src, ...)`` rows locally, in source
        order, with ``StackedComm``'s ``_source_sum`` / ``_source_or``
        / ``amin`` (not NCCL's ``reduce_scatter``, whose ring order would
        change float32 bits).  A part ships what a reduce-scatter would.
      * ``broadcast_global``: ``all_gather`` into ``(1, n)``.
      * ``shift``: ``all_to_all_single`` with one non-empty split each
        way (send to rank + 1, receive from rank - 1).
      * ``psum_scalar``, ``sum_parts``, ``all_parts``, ``max_scalar``,
        ``gather_parts``: ``all_gather`` of the P values, reduced here
        in part order (the same ``sum`` call over the same ``(P,)``
        tensor as ``StackedComm``'s, so float halts read the same bits).

    Backends: NCCL moves CUDA tensors directly; gloo moves host memory,
    so every gloo op on a CUDA tensor is staged through pinned host
    buffers (a copy out before the collective, a copy in after it),
    chosen by backend and device here, never on a failure;
    :attr:`staged_ops` names the ops a run staged.  gloo on CPU tensors
    stages nothing.

    The ``*_start`` / ``*_finish`` pairs are asynchronous: ``start``
    taps the payload and issues the collective with ``async_op=True``,
    returning its :class:`Pending`; ``finish`` waits on it and reduces
    locally (so ``exchange_sum_start``'s handle is not pre-reduced, as
    ``StackedComm``'s is).  Under NCCL the process group records an
    event on the caller's current stream after the payload is written
    and its own stream waits on that event before the collective runs;
    ``finish``'s ``Work.wait`` makes the current stream wait for the
    collective before anything reads the received rows.  Under gloo the
    collective runs on gloo's own thread while the caller computes.
    """

    def __init__(self, parts: int, device):
        import torch.distributed as dist
        super().__init__(parts, device)
        if not dist.is_initialized():
            raise RuntimeError("DistComm needs an initialized "
                               "torch.distributed process group")
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        if self.world != self.parts:
            raise ValueError(f"DistComm holds one part a rank: parts="
                             f"{self.parts} over {self.world} ranks")
        self.local_parts = 1
        self.first_part = self.rank
        self.backend = str(dist.get_backend())
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.staged_ops: set[str] = set()

    def __repr__(self):
        return (f"DistComm(parts={self.parts}, rank={self.rank}, "
                f"backend={self.backend}, device={self.device})")

    def _fault_tap(self, op: str, payload: torch.Tensor, words: bool):
        """``faults.tap`` of this rank's part: its row is global part
        ``rank``, so an event fires on the rank that holds its part."""
        return faults.tap(op, payload, self.parts, words,
                          first=self.first_part)

    # -- transport ------------------------------------------------------------

    def _issue(self, op: str, collective, recv: torch.Tensor,
               send: torch.Tensor, async_op: bool) -> Pending:
        """Run ``collective(recv, send, async_op)`` on this rank's
        buffers, or, when the backend moves host memory only, on pinned
        host copies of them."""
        if not self.staged:
            return Pending(collective(recv, send, async_op), recv, send)
        self.staged_ops.add(op)
        host_send = torch.empty(send.shape, dtype=send.dtype,
                                pin_memory=True)
        host_send.copy_(send)               # waits for the payload
        host_recv = torch.empty(recv.shape, dtype=recv.dtype,
                                pin_memory=True)
        return Pending(collective(host_recv, host_send, async_op),
                       host_recv, host_send, device_recv=recv)

    def _a2a(self, op: str, blocks: torch.Tensor,
             async_op: bool = False) -> Pending:
        """Row q of ``blocks`` (P, ...) to rank q; row p of the received
        tensor came from rank p."""
        import torch.distributed as dist
        send = blocks.contiguous()
        return self._issue(
            op, lambda r, s, a: dist.all_to_all_single(r, s, async_op=a),
            torch.empty_like(send), send, async_op)

    def _gather(self, op: str, x: torch.Tensor) -> torch.Tensor:
        """(1, ...) this rank's rows -> (P, ...) every rank's, in rank
        order."""
        import torch.distributed as dist
        send = x.contiguous()
        recv = torch.empty((self.parts,) + tuple(send.shape[1:]),
                           dtype=send.dtype, device=send.device)
        return self._issue(
            op, lambda r, s, a: dist.all_gather_into_tensor(
                r, s, async_op=a), recv, send, False).wait()

    # -- blocking exchanges -------------------------------------------------

    @spanned("exchange_sum", "comm")
    def exchange_sum(self, acc_global: torch.Tensor) -> torch.Tensor:
        """(1, n) proposed updates -> (1, n_local) owner sums, added in
        source order as :meth:`StackedComm.exchange_sum` adds them."""
        acc_global = self._tap("sum", acc_global)
        rows = self._a2a("sum", self._blocks(acc_global)[0]).wait()
        return self._source_sum(rows[:, None])

    @spanned("exchange_or", "comm")
    def exchange_or(self, mask_global: torch.Tensor) -> torch.Tensor:
        """(1, n) bool -> (1, n_local) bool OR over all parts, shipped
        bit-packed."""
        n_local = mask_global.shape[-1] // self.parts
        packed = self._tap("or", pack_bits(mask_global), words=True)
        rows = self._a2a("or", self._blocks(packed)[0]).wait()
        return unpack_bits(self._source_or(rows[:, None]), n_local)

    @spanned("exchange_min_int", "comm")
    def exchange_min_int(self, val_global: torch.Tensor) -> torch.Tensor:
        """(1, n) proposals -> (1, n_local) element-wise MIN."""
        val_global = self._tap("min", val_global)
        rows = self._a2a("min", self._blocks(val_global)[0]).wait()
        return rows[:, None].amin(dim=0)

    @spanned("broadcast_global", "comm")
    def broadcast_global(self, local_vals: torch.Tensor,
                         words: bool = False) -> torch.Tensor:
        """(1, n_local) -> (1, n): the full replica on this rank."""
        local_vals = self._tap("bcast", local_vals, words)
        return self._gather("bcast", local_vals).reshape(1, -1)

    @spanned("shift", "comm")
    def shift(self, x: torch.Tensor, words: bool = False) -> torch.Tensor:
        """(1, ...) this part's payload -> part (rank - 1) mod P's."""
        import torch.distributed as dist
        x = self._tap("perm", x, words).contiguous()
        sends = [0] * self.parts
        recvs = [0] * self.parts
        sends[(self.rank + 1) % self.parts] = 1
        recvs[(self.rank - 1) % self.parts] = 1
        return self._issue(
            "perm", lambda r, s, a: dist.all_to_all_single(
                r, s, recvs, sends, async_op=a),
            torch.empty_like(x), x, False).wait()

    @spanned("psum_scalar", "comm")
    def psum_scalar(self, x: torch.Tensor):
        """(1,) this part's scalar -> the sum over all parts, a host
        number."""
        return self._gather("psum", x.reshape(1)).sum().item()

    @spanned("sum_parts", "comm")
    def sum_parts(self, x: torch.Tensor) -> torch.Tensor:
        return self._gather("psum", x.reshape(1)).sum()

    @spanned("all_parts", "comm")
    def all_parts(self, verdict: torch.Tensor) -> bool:
        local = torch.as_tensor(verdict, device=self.device).all() \
            .to(torch.int32).reshape(1)
        return bool(self._gather("psum", local).all().item())

    @spanned("max_scalar", "comm")
    def max_scalar(self, x: torch.Tensor) -> int:
        return int(self._gather("psum", x.reshape(1)).max())

    @spanned("gather_parts", "comm")
    def gather_parts(self, x: torch.Tensor) -> torch.Tensor:
        return self._gather("gather", x)

    def agree(self, ok: bool) -> bool:
        import torch.distributed as dist
        flag = torch.tensor([1 if ok else 0], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=control_group())
        return bool(flag.item())

    def gather_objects(self, obj) -> list:
        return gather_objects(obj)

    def broadcast_object(self, obj):
        return broadcast_object(obj)

    # -- double-buffered exchange ---------------------------------------------

    # A start's handle is the Pending all_to_all of its (1, P_dst, w + 1)
    # stamped rows; its finish waits, views the received (P_src, w + 1)
    # rows as StackedComm's (P_src, 1, w + 1) handle and reduces them.

    @spanned("exchange_min_start", "comm")
    def exchange_min_start(self, val_global: torch.Tensor, scalar):
        return self._a2a("min", self._tap("min", self._stamped(
            self._blocks(val_global), scalar))[0], async_op=True)

    @spanned("exchange_min_finish", "comm")
    def exchange_min_finish(self, handle: Pending):
        return self._min_rows(handle.wait()[:, None])

    @spanned("exchange_sum_start", "comm")
    def exchange_sum_start(self, acc_global: torch.Tensor, scalar):
        return self._a2a("sum", self._tap("sum", self._stamped(
            self._blocks(acc_global), scalar))[0], async_op=True)

    @spanned("exchange_sum_finish", "comm")
    def exchange_sum_finish(self, handle: Pending):
        return self._sum_rows(self._source_sum(handle.wait()[:, None]))

    @spanned("exchange_or_start", "comm")
    def exchange_or_start(self, mask_global: torch.Tensor, scalar):
        return self._a2a("or", self._tap("or", self._stamped(
            self._blocks(pack_bits(mask_global)), scalar), words=True)[0],
            async_op=True)

    @spanned("exchange_or_finish", "comm")
    def exchange_or_finish(self, handle: Pending, n_local: int):
        return self._or_rows(handle.wait()[:, None], n_local)


# ---------------------------------------------------------------------------
# The control plane of a group of ranks: host objects, never exchanges.
# ---------------------------------------------------------------------------

_CONTROL: list = []     # [(default group, its gloo control group)]


def control_group():
    """The process group that carries host objects between the ranks:
    the default group when it is gloo, else one gloo group over the
    same ranks, made once for the default group (every rank reaches its
    first control call at the same point, so every rank makes it in
    the same order).  Objects then move through host memory whatever
    backend moves the data."""
    import torch.distributed as dist
    world = dist.group.WORLD
    if str(dist.get_backend()) == "gloo":
        return None
    if not _CONTROL or _CONTROL[0][0] is not world:
        _CONTROL[:] = [(world, dist.new_group(backend="gloo"))]
    return _CONTROL[0][1]


def gather_objects(obj) -> list:
    """Every rank's picklable ``obj``, in rank order, on every rank."""
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj, group=control_group())
    return out


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank."""
    import torch.distributed as dist
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=control_group())
    return box[0]


@dataclass(frozen=True)
class GraphMesh:
    """The graph engine's 1-D mesh over the ``"parts"`` axis, as the
    caller launched it: ``distributed`` False is the one-process mesh,
    every part stacked here (``StackedComm``); True, the ranks of the
    initialized default process group, one part a rank (``DistComm``).
    Which parts this process holds is the comm's to say."""

    parts: int
    distributed: bool = False

    def comm(self, device) -> StackedComm:
        """The exchange context of this process's parts on ``device``."""
        if self.distributed:
            return DistComm(self.parts, device)
        return StackedComm(self.parts, device)
