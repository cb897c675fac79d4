"""Batch coalescing: pack compatible pending queries into a fixed
ladder of batch sizes so every launch hits an already-built program.

The engine caches programs per ``(algo, variant, params, batch)``
(``core/api.py``), so a server that launched whatever batch width the
queue happened to hold would build a program per width.  The ladder
quantizes instead: a batch of ``k`` source queries launches at the smallest
bucket ``>= k`` (capped at the top bucket), padding the root vector by
repeating the last root — padded lanes are lanes whose answers the
demux discards (the batched runner runs each distinct root once and
copies it into its duplicate lanes, ``core/superstep.py``).  After one
warmup pass per bucket nothing is ever built again
(``tests/test_torch_serve.py::test_bucket_ladder_no_rebuild``).

Policy is deliberately work-conserving: a batch forms as soon as the
executor has room and ANY query is pending — there is no fill timer —
so light traffic rides small buckets at low latency and heavy traffic
climbs the ladder by itself.  Fairness across keys is oldest-head-first
(the key whose front query has waited longest dispatches next), which
bounds per-key starvation under a skewed mix.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

from repro_torch.serve.query import Query, QueryKey

DEFAULT_BUCKETS = (1, 8, 32, 128)


class BucketLadder:
    """Sorted fixed batch sizes; ``pick(k)`` = smallest bucket >= k,
    top bucket when k overflows (the rest stays queued)."""

    def __init__(self, buckets=DEFAULT_BUCKETS):
        sizes = sorted(set(int(b) for b in buckets))
        if not sizes or sizes[0] < 1:
            raise ValueError(f"buckets must be positive ints: {buckets!r}")
        self.sizes = tuple(sizes)

    def pick(self, pending: int) -> int:
        for b in self.sizes:
            if pending <= b:
                return b
        return self.sizes[-1]

    def __repr__(self):
        return f"BucketLadder{self.sizes}"


@dataclass
class Batch:
    """One coalesced launch: ``bucket`` source queries (roots padded to
    the bucket width by duplication), or — ``bucket == 0`` — every
    pending refresh query of one key sharing a single unbatched launch.
    ``epoch`` is the snapshot epoch all member queries were admitted at
    (a batch never mixes epochs)."""

    key: QueryKey
    queries: list
    bucket: int
    roots: list                          # padded, len == bucket; [] refresh
    epoch: int = -1
    t_formed: float = 0.0                # perf_counter at next_batch()

    @property
    def n_real(self) -> int:
        return len(self.queries)


class Coalescer:
    """Admission queue + batch formation over per-(key, epoch) FIFO
    queues.  Keying the queues on the admission epoch is what keeps
    coalescing snapshot-consistent: queries admitted before a mutation
    never share a launch with queries admitted after it, so every
    launch reads exactly one graph version.

    ``max_queued`` bounds the TOTAL pending count; an admission that
    would exceed it sheds one query first, **oldest-deadline-first**:
    the victim is the pending query whose absolute deadline expires
    soonest (ties, and the unbounded ``deadline_s=None`` tail, break
    to oldest admission).  Under overload that policy drops exactly
    the queries least likely to make their budget anyway and keeps
    no-deadline work last in the firing line.  The evicted query (which
    may be the one just admitted) is returned so the server can resolve
    it with a typed ``shed`` result instead of silence."""

    def __init__(self, ladder: BucketLadder | None = None,
                 max_queued: int | None = None):
        if max_queued is not None and max_queued < 1:
            raise ValueError(f"max_queued must be >= 1, got {max_queued}")
        self.ladder = ladder or BucketLadder()
        self.max_queued = max_queued
        self._pending: dict[tuple[QueryKey, int], deque[Query]] = {}

    def admit(self, q: Query) -> Query | None:
        """Queue ``q``; returns the query shed to stay within
        ``max_queued`` (None when the queue had room)."""
        self._pending.setdefault((q.key, q.epoch), deque()).append(q)
        if self.max_queued is None or \
                self.pending_count() <= self.max_queued:
            return None
        return self._shed_one()

    def _shed_one(self) -> Query:
        victim_ke, victim_i, victim_key = None, -1, None
        for ke, dq in self._pending.items():
            for i, q in enumerate(dq):
                k = (q.deadline_abs, q.t_submit, q.qid)
                if victim_key is None or k < victim_key:
                    victim_ke, victim_i, victim_key = ke, i, k
        dq = self._pending[victim_ke]
        victim = dq[victim_i]
        del dq[victim_i]
        return victim

    def pending_count(self, key: QueryKey | None = None) -> int:
        if key is not None:
            return sum(len(d) for (k, _), d in self._pending.items()
                       if k == key)
        return sum(len(d) for d in self._pending.values())

    def has_pending(self) -> bool:
        return any(self._pending.values())

    def next_batch(self) -> Batch | None:
        """Form ONE batch from the (key, epoch) whose head query is
        oldest."""
        live = [(d[0].t_submit, ke) for ke, d in self._pending.items() if d]
        if not live:
            return None
        _, (key, epoch) = min(live, key=lambda e: e[0])  # ties: admission
        dq = self._pending[(key, epoch)]
        now = time.perf_counter()          # batch formation time: the
        # coalesce-wait span for each member runs t_submit..t_formed
        if key.seeded:
            # one launch per seeded query: each carries (or resolves to)
            # its own vertex-field seed, so launches never share
            return Batch(key, [dq.popleft()], 0, [], epoch, t_formed=now)
        if not key.rooted:
            queries = list(dq)
            dq.clear()
            return Batch(key, queries, 0, [], epoch, t_formed=now)
        bucket = self.ladder.pick(len(dq))
        queries = [dq.popleft() for _ in range(min(bucket, len(dq)))]
        roots = [q.root for q in queries]
        roots += [roots[-1]] * (bucket - len(roots))   # dup-root padding
        return Batch(key, queries, bucket, roots, epoch, t_formed=now)
