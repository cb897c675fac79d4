"""The resident-engine graph server.

``GraphServer`` keeps a :class:`~repro_torch.core.api.GraphEngine` and
its device-resident graph alive across queries and drives
mixed-algorithm traffic through the engine's program cache:

  admission  ``submit()`` validates against the registry, stamps
             ``(qid, t_submit)`` and queues per coalescing key.
  coalescing ``serve.coalescer``: source queries pack into the bucket
             ladder (padding with duplicate roots) so every launch hits
             an already-built ``batch=bucket`` program; refresh queries
             of one key share a single launch.
  execution  ``DoubleBufferedExecutor``: up to ``depth`` launches ride
             in flight and the pipeline blocks only at demux.  A
             program's host loop reads a halt value every round, so
             what overlaps the next batch's formation is the tail of a
             launch, not the launch (``serve.executor``).
  demux      per-query answers slice back out of the batched
             ``(P, B, n_local)`` outputs into host-side
             :class:`QueryResult`\\ s, identical to what a direct
             ``engine.program(...)`` call returns.  Padded lanes are
             dropped on the device before the one copy to the host.

Synchronous by construction: ``pump()`` advances the pipeline one step
and the caller owns the loop (``serve`` for a closed-loop query list,
``serve_trace`` to replay a timed arrival trace in real time).  No
threads.

**Dynamic graphs.**  ``mutate()`` applies a batched edge insert/delete
against the resident graph through ``repro_torch.serve.dynamic`` and
opens a new SNAPSHOT EPOCH: pending queries are flushed against the old
tensors first, the device patch is functional (in-flight launches keep
their snapshot), and queries admitted afterwards read the new one.
Seeded queries (``pagerank/warm``, ``cc/incremental``,
``kcore/incremental``) resolve their vertex-field seed from the
server's seed store — previously served outputs, adopted warm only
when the mutation history since their epoch keeps them exact
(``registry.IncrementalSpec.mutations``), cold otherwise.

**Durability.**  ``persistence=`` write-ahead-logs every mutation batch
and snapshots the serving state (``repro_torch.serve.persist``);
``GraphServer.recover(dir)`` resumes a killed server at the exact epoch
with bit-identical answers.

**Overload & failure resilience.**  Every terminal disposition is a
typed :class:`QueryResult` (``status`` in ``ok`` / ``timed_out`` /
``shed`` / ``failed``) — the server never silently drops an admitted
query and never lets one bad query take the pipeline down:

  * **validation** — :func:`~repro_torch.serve.query.validate_query`
    runs at admission (``validate=False`` opts out): out-of-range
    roots, non-finite float params and corrupt seed vectors are
    rejected BEFORE they can ride — or poison — a coalesced launch.
  * **deadlines** — a query may carry ``deadline_s`` (or inherit
    ``default_deadline_s``), an admission-to-demux budget.  Budgets
    never block a batch: a query already over budget when its batch
    forms is answered ``timed_out`` without launching, and one whose
    launch lands late has its answer withheld at demux.  Latency cells
    in the metrics record only ``ok`` answers; misses ride the
    ``timed_out`` counter.
  * **load shedding** — ``max_queued`` bounds the admission queue; an
    overflowing admission sheds the pending query with the soonest
    absolute deadline (oldest-deadline-first — see
    :class:`~repro_torch.serve.coalescer.Coalescer`), resolved as
    ``shed``.
  * **retry & quarantine** — a launch that raises (at dispatch or at
    the executor's wait on its device work) is bisected: multi-query
    batches resubmit their members singly, so healthy queries complete
    and the poison one keeps failing alone; a singleton retries with
    exponential backoff (``retry_backoff_s * 2**attempt``) up to
    ``max_retries``, then lands in ``server.quarantined`` with a
    ``failed`` result carrying the exception.  The executor itself never
    wedges — a failed launch cannot orphan its in-flight peers
    (``serve.executor``).

**One part a rank.**  Over a ``DistComm`` engine every rank holds a
server, and rank 0 leads: admission, validation, coalescing,
deadlines, shedding, retry, quarantine and the seed store's choices are
its alone, and so are the results.  The programs and the demux's
gathers are collectives, so every rank runs them in the same order:
before each launch, each demux and each mutation batch the leader
broadcasts a plain message over the control plane (key, bucket, roots,
epoch and the seed's source; the demuxed lanes; the batch), and the
other ranks follow it.  A launch that fails on any rank fails on every
rank, through one agreed verdict before it runs and one after, so the
retry or the bisection runs everywhere.  The other ranks call the same
public methods (``warmup``, ``serve``, ``serve_trace``, ``mutate``,
``drain``, ``pump``), which follow the leader's call to its end and
return no results (``mutate`` their own ``MutationStats``), or
:meth:`GraphServer.follow` until the leader's :meth:`GraphServer.close`.
A leader's call that raises raises on every rank at its end.
"""

from __future__ import annotations

import contextlib
import pickle
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core import registry
from repro_torch.core.api import GraphEngine
from repro_torch.core.incremental import KIND_DTYPES, cold_seed
from repro_torch.obs import NULL_RECORDER
from repro_torch.serve.coalescer import Batch, BucketLadder, Coalescer
from repro_torch.serve.dynamic import DynamicGraph, MutationBatch, \
    MutationStats
from repro_torch.serve.executor import DoubleBufferedExecutor, Launch
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.persist import DurabilityState, Persistence, \
    maybe_crash
from repro_torch.serve.query import Query, QueryKey, QueryResult, \
    make_key, validate_query


class LaunchFailed(RuntimeError):
    """A launch that failed on another rank: every rank treats it as
    failed, and the leader retries or bisects it."""


def _picklable(err):
    """``err`` itself if it pickles (to re-raise on every rank), else a
    RuntimeError that names it."""
    try:
        pickle.dumps(err)
        return err
    except Exception:
        return RuntimeError(repr(err))


def _settled(out) -> bool:
    """Wait for a launch's device work; False if the wait raised."""
    try:
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(o, torch.Tensor) and o.is_cuda:
                torch.cuda.synchronize(o.device)
                break
        return True
    except Exception:
        return False


def _host_scalar(value):
    """A scalar output as the host value a demuxed field holds."""
    if isinstance(value, torch.Tensor):
        value = value.cpu()
    return np.asarray(value)[()]


class GraphServer:
    def __init__(self, engine: GraphEngine, *, buckets=None, depth: int = 2,
                 max_queued: int | None = None,
                 default_deadline_s: float | None = None,
                 max_retries: int = 2, retry_backoff_s: float = 0.02,
                 validate: bool = True,
                 persistence: Persistence | str | None = None, obs=None):
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.engine = engine
        # over ranks (DistComm) rank 0 leads and the others follow its
        # messages (module docstring); stacked, this process is both
        self.ranks = engine.distributed
        self.leader = engine.comm.leader
        self._depth = 0                  # the leader's nested public calls
        self._followed: deque = deque()  # a follower's launches to demux
        self._stopped = False            # a follower the leader released
        # serving-path observability: an obs.SpanRecorder records every
        # pipeline stage (admission -> validate -> coalesce_wait ->
        # dispatch -> device -> demux -> query) plus durability and
        # resilience events.
        # The default NULL_RECORDER is disabled — each site pays one
        # attribute read and allocates nothing.
        self.obs = obs if obs is not None else NULL_RECORDER
        self.garr = engine.device_graph()      # resident device graph
        self.ladder = BucketLadder(buckets) if buckets else BucketLadder()
        self.coalescer = Coalescer(self.ladder, max_queued=max_queued)
        self.executor = DoubleBufferedExecutor(depth)
        self.metrics = ServeMetrics()
        self.default_deadline_s = default_deadline_s
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.validate = bool(validate)
        # quarantined poison queries (their `failed` results), and
        # out-of-band resolutions (shed at admission) the next pump()
        # hands back to whoever drives the loop
        self.quarantined: list[QueryResult] = []
        self._oob: list[QueryResult] = []
        # mailbox of demuxed-but-uncollected answers: serve()/
        # serve_trace() POP what they return, so a long-running server
        # holds only results nobody has picked up yet (callers driving
        # submit/pump directly should pop too — vertex fields are
        # (n_orig,) arrays and an unbounded dict grows without end)
        self.results: dict[int, QueryResult] = {}
        self._next_qid = 0
        # dynamic-graph state: the snapshot epoch, the lazily built
        # mutation subsystem, the mutation history (what _seeds entries
        # are judged against), and the seed store itself —
        # (algo, field) -> (epoch, (n_orig,) host array) harvested from
        # served refresh results
        self.epoch = 0
        self.dynamic: DynamicGraph | None = None
        self.mutation_log: list[dict] = []
        self._seeds: dict[tuple[str, str], tuple[int, np.ndarray]] = {}
        # durability (WAL + snapshots): None = fail-stop volatile.
        # ``persistence=`` starts durable FROM SCRATCH (refusing a dir
        # that already holds state); ``GraphServer.recover(dir)`` is the
        # resume constructor.
        self.durability: DurabilityState | None = None
        self.recovery_report = None
        if persistence is not None:
            self.durability = DurabilityState.create(self, persistence)
            self.durability.obs = self.obs
            self.metrics.wal_records = self.durability.wal_records

    # -- admission -----------------------------------------------------------
    def submit(self, algo: str, variant: str | None = None, *,
               root: int | None = None,
               deadline_s: float | None = None, **params) -> int:
        """Admit one query; returns its qid (resolved in ``results``)."""
        return self.submit_query(
            Query(make_key(algo, variant, **params), root,
                  deadline_s=deadline_s))

    def submit_query(self, q: Query, t_submit: float | None = None) -> int:
        self._leads("submit")
        if q.qid != -1:
            # admission stamps the object in place; re-submitting it
            # would re-stamp it and orphan the first qid's result
            raise ValueError(
                f"query already admitted as qid={q.qid}; build a fresh "
                "Query to resubmit")
        with self.obs.span("admission", "server", label=q.key.label):
            if self.validate:
                try:
                    with self.obs.span("validate", "server"):
                        validate_query(q, self.engine.g.n_orig)
                except ValueError:
                    self.metrics.count("rejected")
                    if self.obs.enabled:
                        self.obs.event("rejected", "server",
                                       label=q.key.label)
                    raise
            q.qid, self._next_qid = self._next_qid, self._next_qid + 1
            q.t_submit = (time.perf_counter() if t_submit is None
                          else t_submit)
            q.epoch = self.epoch
            if q.deadline_s is None:
                q.deadline_s = self.default_deadline_s
            # the metrics window opens at FIRST ADMISSION (idempotent),
            # so the first launch's queue + dispatch wait counts against
            # qps — record()'s own start() is only a fallback for
            # standalone use
            self.metrics.start()
            shed = self.coalescer.admit(q)
        if shed is not None:
            self._oob.append(self._resolve(shed, "shed"))
        return q.qid

    def _resolve(self, q: Query, status: str,
                 error: Exception | None = None,
                 t_done: float | None = None) -> QueryResult:
        """Terminal non-``ok`` disposition: typed result into the
        mailbox plus the matching resilience counter."""
        t_done = time.perf_counter() if t_done is None else t_done
        res = QueryResult(
            qid=q.qid, key=q.key, root=q.root, fields={}, rounds=-1,
            latency_s=t_done - q.t_submit, bucket=0, epoch=q.epoch,
            status=status, error=error)
        self.metrics.count(
            "quarantined" if status == "failed" else status)
        if status == "failed":
            self.quarantined.append(res)
        if self.obs.enabled:
            # the query's async span closes here even on a non-ok
            # disposition; the matching resilience event marks WHY
            self.obs.add_span("query", "server", q.t_submit, t_done,
                              qid=q.qid, label=q.key.label, bucket=0,
                              status=status,
                              latency_s=res.latency_s)
            if status == "failed":
                self.obs.event("launch_failure", "executor", qid=q.qid,
                               label=q.key.label)
            else:
                self.obs.event(status, "server", qid=q.qid,
                               label=q.key.label)
        self.results[q.qid] = res
        return res

    # -- ranks: the leader's messages and the followers' loop ---------------
    def _leads(self, what: str) -> None:
        if not self.leader:
            raise RuntimeError(
                f"{what}: rank 0 leads a rank server; the other ranks "
                "follow it (follow(), or the same public call)")

    def _tell(self, *msg) -> None:
        """Broadcast one message of the leader to the followers."""
        if self.ranks:
            self.engine.comm.broadcast_object(msg)

    @contextlib.contextmanager
    def _call(self, what: str):
        """The leader's public call: at its end (the outermost one) the
        followers, which follow it, are told it is done, with its error
        if it raised."""
        self._leads(what)
        self._depth += 1
        err = None
        try:
            yield
        except BaseException as e:
            err = _picklable(e)
            raise
        finally:
            self._depth -= 1
            if self._depth == 0:
                self._tell("done", err)

    def follow(self, until: str = "stop") -> dict:
        """A follower's loop: run the leader's messages in order until
        ``until`` arrives (``"stop"`` from the leader's :meth:`close`,
        ``"done"`` at the end of a public call; a stop ends either).
        Returns the launches and the last mutation's stats it ran; at
        the "done" of a leader's call that raised, raises its error."""
        got = {"launches": 0, "mutation": None}
        while True:
            op, *args = self.engine.comm.broadcast_object(None)
            if op == "dispatch":
                self._follow_dispatch(*args)
                got["launches"] += 1
            elif op == "demux":
                self._follow_demux(*args)
            elif op == "mutate":
                got["mutation"] = self._follow_mutate(*args)
            elif op == "stop" or until == "done":
                self._stopped = op == "stop"
                if op == "done" and args[0] is not None:
                    raise args[0]
                return got

    def _follow_dispatch(self, key, bucket, roots, source) -> None:
        try:
            out = self._run_launch(key, bucket, roots, source)
        except Exception:
            out = None       # failed on every rank: the leader decides
        if out is not None:
            self._followed.append((key, bucket, out))

    def _follow_demux(self, n_real: int, epoch: int) -> None:
        key, bucket, out = self._followed.popleft()
        if self.engine.comm.agree(_settled(out)) and n_real:
            self._gather(key, bucket, n_real, out, epoch)

    def _follow_mutate(self, inserts, deletes):
        try:
            return self._apply_mutation(inserts, deletes)
        except Exception:
            return None      # raised on every rank; the leader's "done"
                             # carries the error to the caller

    def close(self) -> None:
        """End serving, on every rank: the leader's stop releases a
        follower from :meth:`follow` (or from its own ``close``), and
        every rank closes its WAL."""
        if self.leader:
            self._tell("stop")
        elif not self._stopped:
            self.follow()
        if self.durability is not None:
            self.durability.close()

    # -- warmup --------------------------------------------------------------
    def warmup(self, keys) -> int:
        """Build and run once every (key x ladder rung) so serving never
        pays a build (or a kernel's first load); returns the launch
        count.  Source keys warm every bucket; refresh keys warm the
        single unbatched program.  Warmup launches bypass the metrics
        window."""
        if not self.leader:
            return self.follow("done")["launches"]
        launches = 0
        with self._call("warmup"):
            for key in keys:
                if isinstance(key, str):
                    key = make_key(key)
                buckets = self.ladder.sizes if key.rooted else (0,)
                for b in buckets:
                    batch = Batch(key, [], b, [0] * b)
                    out = self._dispatch(batch)
                    # warming mid-serving may retire REAL in-flight
                    # launches to free slots: demux them, don't drop them
                    for launch in self.executor.push(batch, out):
                        self._demux(launch)
                    launches += 1
            for launch in self.executor.drain():
                self._demux(launch)
        return launches

    # -- dynamic graphs ------------------------------------------------------
    def dynamic_graph(self) -> DynamicGraph:
        """The mutation subsystem over the resident graph (built lazily:
        reading the free-slot state off the mirrors costs O(E) once)."""
        if self.dynamic is None:
            self.dynamic = DynamicGraph(self.engine, self.garr)
            self.dynamic.epoch = self.epoch
        return self.dynamic

    def mutate(self, inserts=None, deletes=None) -> MutationStats:
        """Apply one batched edge insert/delete and open a new snapshot
        epoch.

        Ordering vs. the pipeline: every PENDING query is flushed into
        the executor first, so it dispatches against the pre-mutation
        tensors it was admitted under; launches already in flight keep
        reading their snapshot because the device patch is functional
        (copy-on-write).  Queries admitted after this call read the new
        epoch.  A batch that overflows the free-slot pools falls back to
        a full re-partition + re-upload (``stats.rebuild=True``;
        programs for the new layout are built on first use — the
        program-cache key covers the layout signature).

        Durability ordering (``persistence=`` servers): the batch is
        planned, WAL-logged and fsynced BEFORE it applies — a crash at
        any instruction leaves the log a superset of the applied
        epochs, never the reverse — and every ``snapshot_every`` epochs
        a crash-consistent snapshot pumps after the apply.

        Over ranks the leader sends the batch after the flush and every
        rank applies its part of it; a follower's call returns its own
        stats (equal to the leader's).
        """
        if not self.leader:
            return self.follow("done")["mutation"]
        with self._call("mutate"):
            if self.durability is not None:
                maybe_crash("between-batches")
            with self.obs.span("mutation", "server") as msp:
                while True:
                    batch = self.coalescer.next_batch()
                    if batch is None:
                        break
                    self._launch(batch)   # results wait in the mailbox
                self._tell("mutate", inserts, deletes)
                stats = self._apply_mutation(inserts, deletes)
                msp.args.update(epoch=stats.epoch, n_insert=stats.n_insert,
                                n_delete=stats.n_delete,
                                rebuild=bool(stats.rebuild))
        return stats

    def _apply_mutation(self, inserts, deletes) -> MutationStats:
        """What every rank does with a mutation batch: apply (logged,
        on a durable server), open the epoch, snapshot when due."""
        dyn = self.dynamic_graph()
        if self.durability is not None:
            stats = self.durability.logged_apply(dyn, inserts, deletes)
        else:
            stats = dyn.apply(inserts, deletes)
        self.garr = dyn.garr
        self.epoch = dyn.epoch
        self.metrics.epoch = self.epoch
        self.mutation_log.append({
            "epoch": stats.epoch, "n_insert": stats.n_insert,
            "n_delete": stats.n_delete, "rebuild": stats.rebuild})
        if self.durability is not None:
            self.metrics.wal_records = self.durability.wal_records
            self.durability.maybe_snapshot(self)
        return stats

    @classmethod
    def recover(cls, dir, *, mesh=None, device=None, snapshot_every=None,
                retain=None, fsync=None, **kwargs) -> "GraphServer":
        """Resume serving from a durability directory: newest
        digest-valid snapshot + WAL-suffix replay, bit-identical to the
        uninterrupted server at the recovered epoch, on ``device``
        (default: the card).  ``mesh`` (``make_graph_mesh(P)`` inside a
        process group of P ranks) recovers a directory that P ranks
        wrote, each rank its part; every rank calls this.  ``kwargs``
        pass through to the constructor (buckets, depth, deadlines,
        ...); the persistence knobs default to what the snapshot
        recorded.  The recovered server keeps appending to the same WAL;
        what it did is on ``server.recovery_report``."""
        from repro_torch.serve.persist.recover import recover_state
        rec = kwargs.get("obs") or NULL_RECORDER
        with rec.span("recovery", "server", dir=str(dir)) as rsp:
            rs = recover_state(dir, device=device, mesh=mesh)
            rsp.args.update(epoch=rs.epoch,
                            wal_records=rs.report.wal_records,
                            replayed=rs.report.replayed)
        server = cls(rs.engine, **kwargs)
        server.dynamic = rs.dynamic
        server.garr = rs.dynamic.garr
        server.epoch = rs.epoch
        server.mutation_log = rs.mutation_log
        server._seeds = dict(rs.seeds)
        stored = rs.persist_cfg
        cfg = Persistence(
            dir=str(dir),
            snapshot_every=(snapshot_every if snapshot_every is not None
                            else stored.get("snapshot_every", 8)),
            retain=(retain if retain is not None
                    else stored.get("retain", 2)),
            fsync=(fsync if fsync is not None
                   else stored.get("fsync", True)))
        if rs.wal is not None:               # the WAL is rank 0's
            rs.wal.fsync = cfg.fsync
        server.durability = DurabilityState.resume(
            cfg, rs.wal, rs.digest, rs.count, rs.batch_id,
            last_snapshot_epoch=rs.report.snapshot_epoch,
            comm=rs.engine.comm if server.ranks else None)
        server.durability.obs = server.obs
        server.recovery_report = rs.report
        server.metrics.epoch = rs.epoch
        server.metrics.recoveries = 1
        server.metrics.wal_records = rs.report.wal_records
        return server

    def resolve_seed(self, key: QueryKey) -> tuple[tuple, bool]:
        """(seed arrays, warm?) for a seeded query without an explicit
        seed.  A stored previous-epoch output is adopted WARM only when
        every mutation since its epoch is of a kind the program stays
        exact under (``IncrementalSpec.mutations``); otherwise the cold
        seed — still exact, just a full-rate recompute."""
        inc = key.spec.incremental
        if inc is not None:
            stored = self._seeds.get((key.algo, inc.seed_output))
            if stored is not None:
                seed_epoch, arr = stored
                if self._mutations_ok(seed_epoch, inc.mutations):
                    return (arr,), True
        return cold_seed(key.spec, self.engine.g), False

    def _mutations_ok(self, since_epoch: int, kinds: str) -> bool:
        if kinds == "any":
            return True
        for entry in self.mutation_log:
            if entry["epoch"] <= since_epoch:
                continue
            if kinds == "insert" and entry["n_delete"]:
                return False
            if kinds == "delete" and entry["n_insert"]:
                return False
        return True

    def _harvest_seeds(self, key: QueryKey, fields: dict,
                       epoch: int) -> None:
        """Keep the newest served output usable as a warm seed: any
        incremental variant of this algo whose ``seed_output`` is among
        the result fields gets (epoch, field) stored."""
        for algo, variant in registry.available():
            spec = registry.get_spec(algo, variant)
            inc = spec.incremental
            if inc is None or inc.of != key.algo:
                continue
            arr = fields.get(inc.seed_output)
            if arr is None:
                continue
            prev = self._seeds.get((key.algo, inc.seed_output))
            if prev is None or prev[0] <= epoch:
                self._seeds[(key.algo, inc.seed_output)] = (epoch, arr)

    # -- the pipeline --------------------------------------------------------
    def pump(self) -> list[QueryResult]:
        """Advance one step: form + dispatch one batch if any query is
        pending (retiring the oldest launch when the pipeline is full),
        else retire one in-flight launch.  Returns completed results —
        including typed shed / timed-out / failed dispositions."""
        if not self.leader:
            self.follow("done")
            return []
        with self._call("pump"):
            done = self._oob
            self._oob = []
            while True:
                batch = self.coalescer.next_batch()
                if batch is None:
                    launch = self.executor.complete_one()
                    if launch is not None:
                        done.extend(self._demux(launch))
                    return done
                batch, expired = self._check_deadlines(batch)
                done.extend(expired)
                if batch is not None:
                    done.extend(self._launch(batch))
                    return done
                # every member had expired in the queue: try the next one

    def _check_deadlines(self, batch: Batch):
        """Expire batch members already over budget BEFORE the launch
        (a deadline never blocks the batch — the live members re-pack
        and go).  Returns ``(batch | None, timed-out results)``."""
        now = time.perf_counter()
        live = [q for q in batch.queries if now <= q.deadline_abs]
        expired = [self._resolve(q, "timed_out", t_done=now)
                   for q in batch.queries if now > q.deadline_abs]
        if not expired:
            return batch, []
        if not live:
            return None, expired
        if batch.bucket:
            bucket = self.ladder.pick(len(live))
            roots = [q.root for q in live]
            roots += [roots[-1]] * (bucket - len(roots))
            batch = Batch(batch.key, live, bucket, roots, batch.epoch)
        else:
            batch = Batch(batch.key, live, batch.bucket, [], batch.epoch)
        return batch, expired

    def _singleton(self, q: Query, epoch: int) -> Batch:
        """A one-query batch for the retry / bisection path."""
        if q.key.rooted:
            b = self.ladder.pick(1)
            return Batch(q.key, [q], b, [q.root] * b, epoch)
        return Batch(q.key, [q], 0, [], epoch)

    def _launch(self, batch: Batch) -> list[QueryResult]:
        """Dispatch one batch; a raising dispatch routes to retry /
        quarantine instead of propagating.  Returns whatever completed
        as a side effect (retired peers, failure dispositions)."""
        if self.obs.enabled and batch.queries and batch.t_formed:
            # coalesce-wait: first member's admission -> batch formed
            self.obs.add_span(
                "coalesce_wait", "coalescer",
                min(q.t_submit for q in batch.queries), batch.t_formed,
                label=batch.key.label, bucket=batch.bucket,
                n=batch.n_real)
        try:
            with self.obs.span("dispatch", "executor",
                               label=batch.key.label, bucket=batch.bucket,
                               n=batch.n_real):
                out = self._dispatch(batch)
        except Exception as e:
            return self._on_launch_failure(batch, e)
        done = []
        for launch in self.executor.push(batch, out):
            done.extend(self._demux(launch))
        return done

    def _on_launch_failure(self, batch: Batch,
                           exc: Exception) -> list[QueryResult]:
        if not batch.queries:
            raise exc                      # warmup launch: surface it
        if len(batch.queries) > 1:
            # poison-query quarantine, step 1: bisect by resubmitting
            # the members singly — healthy queries complete, the poison
            # one keeps failing alone and exhausts its retries below
            done = []
            for q in batch.queries:
                done.extend(self._launch(self._singleton(q, batch.epoch)))
            return done
        q = batch.queries[0]
        q.attempts += 1
        if q.attempts > self.max_retries:
            return [self._resolve(q, "failed", error=exc)]
        self.metrics.count("retries")
        if self.retry_backoff_s:
            time.sleep(self.retry_backoff_s * (2 ** (q.attempts - 1)))
        return self._launch(self._singleton(q, batch.epoch))

    def drain(self) -> list[QueryResult]:
        """Run the pipeline dry: every pending query dispatched, every
        in-flight launch demuxed."""
        if not self.leader:
            self.follow("done")
            return []
        with self._call("drain"):
            done = self._oob
            self._oob = []
            while self.coalescer.has_pending() or len(self.executor):
                done.extend(self.pump())
            self.metrics.stop()
        return done

    def serve(self, queries) -> list[QueryResult]:
        """Closed loop: admit everything, drain, return (and collect
        from the mailbox) results in submission order (a follower: none,
        and ``queries`` unread)."""
        if not self.leader:
            self.follow("done")
            return []
        with self._call("serve"):
            qids = [self.submit_query(q) for q in queries]
            self.drain()
        return [self.results.pop(qid) for qid in qids]

    def serve_trace(self, trace) -> list[QueryResult]:
        """Replay a timed arrival trace (``[(t_s, Query)]``, as built by
        ``serve.workload.synthetic_trace``) in real time: a query is
        admitted when its arrival time passes; between arrivals the
        pipeline keeps pumping, so queued work and in-flight launches
        overlap the wait.  Latency runs from the intended arrival.

        Events may also be ``(t_s, MutationBatch)`` (e.g. merged from
        ``serve.dynamic.mutation_stream``): the batch applies when its
        time passes, flushing pending queries against their own epoch
        first — so a trace interleaves queries and mutations exactly as
        an online service would see them.  A follower follows the
        leader's replay and returns no results (``trace`` unread)."""
        if not self.leader:
            self.follow("done")
            return []
        with self._call("serve_trace"):
            return self._replay(trace)

    def _replay(self, trace) -> list[QueryResult]:
        trace = sorted(trace, key=lambda e: e[0])
        t0 = time.perf_counter()
        done, i = [], 0
        while i < len(trace) or self.coalescer.has_pending() \
                or len(self.executor) or self._oob:
            now = time.perf_counter() - t0
            while i < len(trace) and trace[i][0] <= now:
                item = trace[i][1]
                if isinstance(item, MutationBatch):
                    self.mutate(inserts=item.inserts, deletes=item.deletes)
                else:
                    self.submit_query(item, t_submit=t0 + trace[i][0])
                i += 1
            if self.coalescer.has_pending() or len(self.executor) \
                    or self._oob:
                for res in self.pump():
                    self.results.pop(res.qid, None)   # collected here
                    done.append(res)
            elif i < len(trace):
                time.sleep(min(trace[i][0] - now, 0.005))
        self.metrics.stop()
        return done

    # -- dispatch / demux ----------------------------------------------------
    def _program(self, key: QueryKey, bucket: int):
        return self.engine.program(
            key.algo, key.variant, batch=bucket or None, **dict(key.params))

    def _dispatch(self, batch: Batch):
        source = self._seed_source(batch)
        roots = [int(r) for r in batch.roots]
        self._tell("dispatch", batch.key, batch.bucket, roots, source)
        return self._run_launch(batch.key, batch.bucket, roots, source)

    def _seed_source(self, batch: Batch):
        """Where a seeded launch's seed comes from, as the leader
        decides it: ``("explicit", arrays)`` pinned by the query,
        ``("store", epoch)`` a stored warm seed, ``("cold",)``.  Warmup
        batches (no queries) resolve a cold seed just to run the right
        program; None for an unseeded launch."""
        if not batch.key.seeded:
            return None
        explicit = batch.queries[0].seed if batch.queries else None
        if explicit is not None:
            return ("explicit", explicit)
        if self.resolve_seed(batch.key)[1]:
            inc = batch.key.spec.incremental
            return ("store", self._seeds[(batch.key.algo,
                                          inc.seed_output)][0])
        return ("cold",)

    def _seed(self, key: QueryKey, source) -> tuple:
        """The seed arrays ``source`` names (every rank keeps the same
        store: the demux's gathers give each the whole field)."""
        if source[0] == "explicit":
            return source[1]
        if source[0] == "store":
            epoch, arr = self._seeds[(key.algo,
                                      key.spec.incremental.seed_output)]
            if epoch != source[1]:
                raise LaunchFailed(f"{key.label}: the stored seed is of "
                                   f"epoch {epoch}, not {source[1]}")
            return (arr,)
        return cold_seed(key.spec, self.engine.g)

    def _run_launch(self, key: QueryKey, bucket: int, roots: list, source):
        """Build the program and its inputs, then run it; over ranks a
        failure on any rank, before the run or in it, fails it on
        every rank (one agreed verdict each)."""
        comm = self.engine.comm
        err = None
        try:
            prog = self._program(key, bucket)
            if key.seeded:
                # one seeded launch per query
                args = tuple(
                    self.engine.scatter_vertex_field(a, KIND_DTYPES[kind])
                    for a, kind in zip(self._seed(key, source),
                                       key.spec.input_kinds))
            elif bucket:
                # host values: the batched runner reads each lane's
                # root on the host, and a device tensor would cost a
                # sync a lane
                args = (roots,)
            else:
                args = ()
        except Exception as e:
            err = e
        if self.ranks and not comm.agree(err is None):
            raise err or LaunchFailed(f"{key.label}: the launch failed on "
                                      "another rank before it ran")
        if err is not None:
            raise err
        if not self.ranks:
            return prog(self.garr, *args)
        out = None
        try:
            out = prog(self.garr, *args)
        except Exception as e:
            err = e
        if not comm.agree(err is None):
            raise err or LaunchFailed(f"{key.label}: the launch failed on "
                                      "another rank")
        return out

    def _gather(self, key: QueryKey, bucket: int, k: int, out,
                epoch: int) -> list:
        """The collective part of a demux, the same on every rank: each
        of the ``k`` real lanes' ``(fields, rounds)``, vertex fields
        gathered to the host; a refresh's fields also become warm seeds
        of the incremental variants."""
        prog = self._program(key, bucket)
        names = prog.program.output_names
        is_vertex = prog.program.output_is_vertex
        *outs, rounds = out
        eng = self.engine
        if bucket:
            # drop padded dup-root lanes ON DEVICE so the host copy in
            # this (only) synchronous section is proportional to real
            # queries, not the bucket width
            gathered = [eng.gather_batched_vertex_field(o[:, :k]) if v
                        else [_host_scalar(x) for x in o[:k]]
                        for o, v in zip(outs, is_vertex)]
            return [({n: g[i] for n, g in zip(names, gathered)},
                     int(rounds[i])) for i in range(k)]
        shared = {n: (eng.gather_vertex_field(o) if v else _host_scalar(o))
                  for n, (o, v) in zip(names, zip(outs, is_vertex))}
        # refresh outputs double as warm seeds for the incremental
        # variants of the same algorithm
        self._harvest_seeds(key, shared, epoch)
        return [(shared, int(rounds))] * k

    def _demux(self, launch: Launch) -> list[QueryResult]:
        batch = launch.payload
        if self.ranks:
            self._tell("demux", batch.n_real, batch.epoch)
            settled = self.engine.comm.agree(launch.error is None)
            if not settled and launch.error is None:
                launch.error = LaunchFailed(
                    f"{batch.key.label}: the launch failed on another "
                    "rank at its wait")
        if self.obs.enabled and batch.queries:
            # in-flight interval stamped by the executor (push -> its
            # wait returned); warmup launches stay un-traced
            self.obs.add_span(
                "device", "device", launch.t_dispatch, launch.t_done,
                label=batch.key.label, bucket=batch.bucket,
                n=batch.n_real, launch_seq=launch.seq,
                failed=launch.error is not None)
        if launch.error is not None:
            # the device surfaced a failure at the executor's wait: same
            # routing as a dispatch-time raise
            return self._on_launch_failure(batch, launch.error)
        if not batch.queries:              # warmup launch: nothing to slice
            return []
        with self.obs.span("demux", "server", label=batch.key.label,
                           bucket=batch.bucket, n=batch.n_real):
            per_query = self._gather(batch.key, batch.bucket, batch.n_real,
                                     launch.out, batch.epoch)
            results = []
            for q, (fields, r) in zip(batch.queries, per_query):
                if launch.t_done > q.deadline_abs:
                    # the answer exists but missed its budget: withhold
                    # it (a client gone by now must not see a stale
                    # success)
                    results.append(
                        self._resolve(q, "timed_out", t_done=launch.t_done))
                    continue
                res = QueryResult(
                    qid=q.qid, key=q.key, root=q.root, fields=fields,
                    rounds=r, latency_s=launch.t_done - q.t_submit,
                    bucket=batch.bucket, epoch=batch.epoch)
                self.metrics.record(q.key.label, batch.bucket,
                                    res.latency_s)
                if self.obs.enabled:
                    # the query's async span closes with the IDENTICAL
                    # latency_s float metrics just recorded — the
                    # exact-reconciliation invariant the obs tests pin
                    self.obs.add_span(
                        "query", "server", q.t_submit, launch.t_done,
                        qid=q.qid, label=q.key.label, bucket=batch.bucket,
                        status="ok", latency_s=res.latency_s)
                self.results[q.qid] = res
                results.append(res)
            return results
